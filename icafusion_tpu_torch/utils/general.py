"""Small host-side helpers (reference utils/general.py:142-147 check_img_size,
:198-201 make_divisible, :204-227 class and image weights, :626-637
increment_path, :45-63 init_seeds and get_latest_run, :244-271 one_cycle
and colorstr)."""

from __future__ import annotations

import math
import os
import random
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


def one_cycle(y1: float = 0.0, y2: float = 1.0, steps: int = 100):
    """Sinusoidal ramp from y1 to y2 over ``steps`` (general.py:244-246)."""
    return lambda x: ((1 - math.cos(x * math.pi / steps)) / 2) * (y2 - y1) + y1


def linear_lr(lrf: float, epochs: int):
    """The --linear-lr lambda (train.py:149-150)."""
    return lambda x: (1 - x / (epochs - 1)) * (1.0 - lrf) + lrf


def init_seeds(seed: int = 0) -> np.random.Generator:
    """Seed Python's, numpy's and torch's global generators (general.py:
    45-57) and return a numpy Generator from ``seed``. The port's own
    random draws take explicit generators; this seeds what does not."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return np.random.default_rng(seed)


def colorstr(*input):
    """ANSI colour wrapper (general.py:249-271): colorstr('blue', 'bold',
    s), or colorstr(s) for blue bold."""
    *args, string = input if len(input) > 1 else ("blue", "bold", input[0])
    colors = {
        "black": "\033[30m", "red": "\033[31m", "green": "\033[32m",
        "yellow": "\033[33m", "blue": "\033[34m", "magenta": "\033[35m",
        "cyan": "\033[36m", "white": "\033[37m",
        "bright_black": "\033[90m", "bright_red": "\033[91m",
        "bright_green": "\033[92m", "bright_yellow": "\033[93m",
        "bright_blue": "\033[94m", "bright_magenta": "\033[95m",
        "bright_cyan": "\033[96m", "bright_white": "\033[97m",
        "end": "\033[0m", "bold": "\033[1m", "underline": "\033[4m",
    }
    return "".join(colors[x] for x in args) + f"{string}" + colors["end"]


def get_latest_run(search_dir: str = ".") -> str:
    """The newest last.ckpt (or last.msgpack) under search_dir, by ctime;
    '' when there is none (general.py:60-63)."""
    candidates = (list(Path(search_dir).rglob("last.ckpt"))
                  + list(Path(search_dir).rglob("last.msgpack")))
    return (str(max(candidates, key=os.path.getctime)) if candidates
            else "")


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
