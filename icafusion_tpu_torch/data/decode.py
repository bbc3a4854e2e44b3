"""Decode and letterbox paired images straight into batch buffers.

Counterpart of the JAX package's data/native.py:decode_letterbox_batch,
which decodes JPEGs with a C++ library (native/loader.cpp) on a thread pool.
The port decodes with cv2 (imread, BGR -> RGB) and letterboxes with
data/augment.letterbox(auto=False) on a thread pool of its own: the same
signature and returns. cv2 releases the interpreter lock while it decodes
and resizes, so the threads overlap. Pixels may differ from the C++
decoder's by a JPEG decoder's rounding.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from icafusion_tpu_torch.data.augment import letterbox


def _read_rgb(path: str) -> np.ndarray:
    import cv2
    img = cv2.imread(path)
    if img is None:
        raise RuntimeError(f"cannot decode image {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def decode_letterbox_batch(rgb_paths: List[str], ir_paths: List[str],
                           img_size, scaleup: bool = False,
                           n_threads: Optional[int] = None):
    """-> (rgb (n, H, W, 3) uint8, ir, ratios (n, 2) float32, pads (n, 2)
    float32, orig_hw (n, 2) int32). img_size: a square side or an (H, W)
    canvas. Ratio, pad and native size are the RGB image's, which callers
    rescale boxes with. n_threads defaults to min(8, cpu_count). Raises
    RuntimeError on a file that does not decode."""
    if len(rgb_paths) != len(ir_paths):
        raise ValueError(f"paired counts differ: {len(rgb_paths)} rgb vs "
                         f"{len(ir_paths)} ir")
    if n_threads is None:
        n_threads = max(1, min(8, os.cpu_count() or 1))
    n = len(rgb_paths)
    H, W = (img_size, img_size) if isinstance(img_size, int) else img_size
    rgb = np.empty((n, H, W, 3), np.uint8)
    ir = np.empty((n, H, W, 3), np.uint8)
    ratios = np.empty((n, 2), np.float32)
    pads = np.empty((n, 2), np.float32)
    hw = np.zeros((n, 2), np.int32)

    def one(i):
        a, b = _read_rgb(rgb_paths[i]), _read_rgb(ir_paths[i])
        hw[i] = a.shape[:2]
        rgb[i], ratio, pad = letterbox(a, (H, W), scaleup=scaleup)
        ir[i] = letterbox(b, (H, W), scaleup=scaleup)[0]
        ratios[i], pads[i] = ratio, pad

    with ThreadPoolExecutor(n_threads) as ex:
        for f in [ex.submit(one, i) for i in range(n)]:
            f.result()
    return rgb, ir, ratios, pads, hw
