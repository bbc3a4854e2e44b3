"""Small host-side helpers (reference utils/general.py:142-147 check_img_size,
:198-201 make_divisible, :204-227 class and image weights, :626-637
increment_path)."""

from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np
import torch


def resolve_device(device, who: str) -> torch.device:
    """``device``, or CUDA when it is None; raises where CUDA is asked for
    and there is none (the CPU must be asked for by name)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device (pass device='cpu' to run "
                           "on the CPU)")
    return dev


def not_ported(what: str, item: str):
    """Raise for a path of the JAX package that the port does not have yet,
    naming the ROADMAP item that holds it."""
    raise NotImplementedError(f"{what} is not ported (ROADMAP {item})")


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round a channel count up to the nearest multiple of ``divisor``
    (math.ceil(x / divisor) * divisor, as the width-multiple scaling uses)."""
    return int(math.ceil(x / divisor) * divisor)


def check_img_size(img_size: int, stride: int = 32) -> int:
    """Round an image size up to a multiple of the largest stride."""
    new_size = make_divisible(img_size, int(stride))
    if new_size != img_size:
        print(f"WARNING: --img-size {img_size} must be multiple of max stride "
              f"{stride}, updating to {new_size}")
    return new_size


def labels_to_class_weights(labels, nc: int) -> np.ndarray:
    """Inverse-frequency class weights, normalised to sum 1."""
    rows = [l for l in labels if len(l)]
    classes = (np.concatenate(rows, 0)[:, 0].astype(int) if rows
               else np.zeros(0, int))
    weights = np.bincount(classes, minlength=nc).astype(np.float64)
    weights[weights == 0] = 1
    weights = 1 / weights
    return (weights / weights.sum()).astype(np.float32)


def labels_to_image_weights(labels, nc: int, class_weights=None) -> np.ndarray:
    """Per-image sampling weights: class weights times the image's class
    counts (the --image-weights resampling)."""
    if class_weights is None:
        class_weights = np.ones(nc, np.float32)
    counts = np.array([np.bincount(l[:, 0].astype(int), minlength=nc)
                       if len(l) else np.zeros(nc) for l in labels])
    return (class_weights.reshape(1, nc) * counts).sum(1)


def increment_path(path, exist_ok: bool = False, sep: str = "") -> Path:
    """runs/exp -> runs/exp2, runs/exp3, ... where runs/exp exists."""
    path = Path(path)
    if (path.exists() and exist_ok) or not path.exists():
        return path
    dirs = [str(d) for d in path.parent.glob(f"{path.name}{sep}*")]
    matches = [re.search(rf"%s{sep}(\d+)" % re.escape(path.name), d)
               for d in dirs]
    i = [int(m.groups()[0]) for m in matches if m]
    return Path(f"{path}{sep}{max(i) + 1 if i else 2}")
