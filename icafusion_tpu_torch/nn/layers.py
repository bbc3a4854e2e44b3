"""Backbone and neck layers of the serving path, NCHW.

Counterparts of the JAX package's nn/layers.py (reference models/common.py).
Submodule names equal the flax names (``conv``, ``bn``, ``cv1``, ``m0``...)
so that utils/convert.py maps a flax variable tree onto these modules by
path. BatchNorm uses the reference's YOLOv5 settings: eps 1e-3, momentum
0.03.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def autopad(k, p=None):
    """'same' padding for odd kernels (reference common.py:36-40)."""
    if p is None:
        p = k // 2 if isinstance(k, int) else tuple(x // 2 for x in k)
    return p


class Conv(nn.Module):
    """Conv2d(bias=False) + BatchNorm + SiLU (reference common.py:48-60)."""

    def __init__(self, c1: int, c2: int, k=1, s=1, p=None, g: int = 1,
                 act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p), groups=g,
                              bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        if act is True:
            self.act = nn.SiLU()
        elif act in (False, None):
            self.act = nn.Identity()
        else:
            raise ValueError(f"unsupported activation spec: {act!r}")

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 with an optional residual (reference common.py:184-194)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_, c2, 3, 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs (reference common.py:216-227). The inner
    bottlenecks are named m0..m{n-1}, as in flax."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.n = n
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c_, c_, shortcut, g, e=1.0))

    def forward(self, x):
        y1 = self.cv1(x)
        for i in range(self.n):
            y1 = getattr(self, f"m{i}")(y1)
        return self.cv3(torch.cat([y1, self.cv2(x)], dim=1))


class SPPF(nn.Module):
    """SPP-Fast: three chained k x k stride-1 max pools (reference
    common.py:252-267); padding is -inf, as torch's max_pool2d pads."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)
        self.k = k

    def forward(self, x):
        x = self.cv1(x)
        y1 = F.max_pool2d(x, self.k, 1, self.k // 2)
        y2 = F.max_pool2d(y1, self.k, 1, self.k // 2)
        y3 = F.max_pool2d(y2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


class Focus(nn.Module):
    """2x2 pixel de-interleave into channels, then Conv (reference
    common.py:270-281)."""

    def __init__(self, c1: int, c2: int, k=1, s=1, p=None, g: int = 1,
                 act=True):
        super().__init__()
        self.conv = Conv(c1 * 4, c2, k, s, p, g, act)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                                    x[..., ::2, 1::2], x[..., 1::2, 1::2]],
                                   dim=1))


class Concat(nn.Module):
    """Concatenate a list of maps; YAML dimension 1 is the channel axis in
    NCHW too."""

    def __init__(self, dimension: int = 1):
        super().__init__()
        self.d = dimension

    def forward(self, xs: Sequence[torch.Tensor]):
        return torch.cat(list(xs), dim=self.d)


class Upsample(nn.Module):
    """nn.Upsample as the YAML rows use it ([None, scale, 'nearest']): an
    integer nearest scale repeats pixels. Every shipped config uses scale 2;
    other modes and non-integer scales are not ported."""

    def __init__(self, size: Optional[Tuple[int, int]] = None,
                 scale_factor: Optional[float] = None, mode: str = "nearest"):
        super().__init__()
        if (mode != "nearest" or size is not None
                or scale_factor != int(scale_factor)):
            raise ValueError("only integer nearest upsampling is ported, got "
                             f"size={size} scale={scale_factor} mode={mode!r}")
        self.s = int(scale_factor)

    def forward(self, x):
        return x.repeat_interleave(self.s, dim=-2).repeat_interleave(
            self.s, dim=-1)
