"""Small host-side helpers (reference utils/general.py:142-147 check_img_size,
:198-201 make_divisible)."""

from __future__ import annotations

import math


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
