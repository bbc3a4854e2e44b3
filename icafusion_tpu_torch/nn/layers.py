"""Backbone and neck layers, NCHW, for serving and training.

Counterparts of the JAX package's nn/layers.py (reference models/common.py).
Submodule names equal the flax names (``conv``, ``bn``, ``cv1``, ``m0``...)
so that utils/convert.py maps a flax variable tree onto these modules by
path. BatchNorm uses the reference's YOLOv5 settings: eps 1e-3, momentum
0.03 (flax's 0.97), and in train mode updates its running variance with the
biased batch variance, as flax does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from icafusion_tpu_torch.kernels.conv_int8 import conv_int8_bn_act
from icafusion_tpu_torch.kernels.packed_conv import conv3x3_bn_silu

BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def autopad(k, p=None):
    """'same' padding for odd kernels (reference common.py:36-40)."""
    if p is None:
        p = k // 2 if isinstance(k, int) else tuple(x // 2 for x in k)
    return p


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train-mode update of the running variance uses
    the biased batch variance, as flax's BatchNorm does (torch uses the
    unbiased one): running = (1 - m) running + m var_biased. Normalisation
    uses the batch statistics, as in both."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        # torch updates copies (autograd keeps them; the buffers may change)
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                         self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            # torch added m * var * n / (n - 1): rescale that term by
            # (n - 1) / n and give back the share of (1 - m) old it took
            self.running_mean.copy_(mean)
            self.running_var.mul_((1 - self.momentum) / n).add_(
                var, alpha=(n - 1) / n)
            self.num_batches_tracked.add_(1)
        return y


class Conv(nn.Module):
    """Conv2d(bias=False) + BatchNorm + SiLU (reference common.py:48-60).

    In eval mode a 3x3, stride 1, pad 1, ungrouped 64 -> 64 Conv with SiLU
    runs as one fused kernel (kernels/packed_conv.py: conv3x3_bn_silu) with
    the BatchNorm folded into a per-channel scale and bias; on the CPU that
    call takes its plain version.

    int8 W8A8 (utils/quantize.py, the JAX package's Conv._int8_conv): once
    ``quantize_model`` has filled the buffers ``w8`` (Cout, kh, kw, Cin)
    int8, ``s_w`` (Cout,) and ``s_in`` (Cin,) float32, an eval-mode forward
    runs kernels/conv_int8.py: conv_int8_bn_act (quantize x, int8 conv,
    dequantize, BatchNorm, activation) before any other branch; a train-mode
    forward never quantizes. The buffers are None until then, so an
    unquantized model's state_dict is unchanged. While ``record`` is set
    (utils/quantize.calibrate), a float forward keeps the running maximum
    over batches of its input's per-channel |x| in ``absmax``."""

    def __init__(self, c1: int, c2: int, k=1, s=1, p=None, g: int = 1,
                 act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p), groups=g,
                              bias=False)
        self.bn = BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        if act is True:
            self.act = nn.SiLU()
        elif act in (False, None):
            self.act = nn.Identity()
        else:
            raise ValueError(f"unsupported activation spec: {act!r}")
        self.fused = (c1 == c2 == 64 and g == 1 and act is True
                      and self.conv.kernel_size == (3, 3)
                      and self.conv.stride == (1, 1)
                      and self.conv.padding == (1, 1))
        for name in ("w8", "s_w", "s_in"):
            self.register_buffer(name, None)
        self.record = False
        self.absmax: Optional[torch.Tensor] = None

    def forward(self, x):
        if self.w8 is not None and not self.training:
            bn = self.bn
            return conv_int8_bn_act(
                x, self.w8, self.s_in, self.s_w,
                (bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps),
                self.conv.stride, self.conv.padding,
                act=isinstance(self.act, nn.SiLU))
        if self.record:
            a = x.detach().abs().amax(dim=(0, 2, 3)).float()
            self.absmax = a if self.absmax is None else torch.maximum(
                self.absmax, a)
        if self.fused and not self.training:
            bn = self.bn
            scale = bn.weight.float() * torch.rsqrt(bn.running_var.float()
                                                    + bn.eps)
            bias = bn.bias.float() - bn.running_mean.float() * scale
            return conv3x3_bn_silu(x, self.conv.weight, scale, bias)
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
    common.py:252-267); padding is -inf, as torch's max_pool2d pads. The
    pool's gradient goes to the first row-major maximum of each window,
    which is where the JAX package's custom VJP sends it (ties are
    systematic in the chained pools)."""

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
        # nearest at an integer scale repeats pixels exactly, and keeps x's
        # memory format (the int8 conv's tma path reads channels_last maps)
        return F.interpolate(x, scale_factor=self.s, mode="nearest")
