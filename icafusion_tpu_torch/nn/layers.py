"""Backbone and neck layers, NCHW, for serving and training.

Counterparts of the JAX package's nn/layers.py (reference models/common.py).
Submodule names equal the flax names (``conv``, ``bn``, ``cv1``, ``m0``...)
so that utils/convert.py maps a flax variable tree onto these modules by
path. BatchNorm uses the reference's YOLOv5 settings: eps 1e-3, momentum
0.03 (flax's 0.97), and in train mode updates its running variance with the
biased batch variance, as flax does.

Besides the modules of the shipped configs, the long tail of the YAML
registry (DWConv, BottleneckCSP, C3TR, SPP, Contract, Expand, MaxPool2d,
the lone BatchNorm2d row, CrossConv, GhostConv, GhostBottleneck,
MixConv2d, SE_Block, the CBAM gates and Classify) runs on plain PyTorch, as
the JAX package runs it on XLA.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from icafusion_tpu_torch.kernels import ops  # noqa: F401  (icafusion::*)
from icafusion_tpu_torch.kernels.conv_int8 import conv_int8_bn_act
from icafusion_tpu_torch.kernels.packed_conv import conv3x3_bn_silu
from icafusion_tpu_torch.parallel.mesh import all_reduce_sum, world

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
    uses the batch statistics, as in both.

    In train mode under a process group of more than one rank
    (parallel/mesh.py), the statistics are those of the global batch, as
    the JAX package takes them over its mesh: the mean, then the centred
    sum of squares, each summed across the ranks by a differentiable
    all-reduce, so the backward sums across them too."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if world() > 1 and not x.is_meta:   # meta: a shape trace, no data
            return self._global_forward(x)
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

    def _global_forward(self, x):
        xf = x.float()
        sums = all_reduce_sum(torch.cat([xf.sum((0, 2, 3)), torch.full(
            (1,), float(xf.numel() // xf.shape[1]), device=x.device)]))
        n = sums[-1]
        mean = sums[:-1] / n
        xc = xf - mean[None, :, None, None]
        var = all_reduce_sum((xc * xc).sum((0, 2, 3))) / n
        y = (xc * torch.rsqrt(var + self.eps)[None, :, None, None]
             * self.weight.float()[None, :, None, None]
             + self.bias.float()[None, :, None, None])
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


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
    dequantize, BatchNorm, activation) before any other branch, grouped
    convs too; a train-mode forward never quantizes. The buffers are None until then, so an
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
                act=isinstance(self.act, nn.SiLU), groups=self.conv.groups)
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


def pool_same(x, k: int):
    """k x k max pool, stride 1, 'same' padding with -inf, as torch's
    max_pool2d pads. Its gradient goes to the first row-major maximum of
    each window, which is where the JAX package's custom VJP sends it (ties
    are systematic in chained pools)."""
    return F.max_pool2d(x, k, 1, k // 2)


class SPPF(nn.Module):
    """SPP-Fast: three chained k x k stride-1 max pools (reference
    common.py:252-267), each ``pool_same``."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)
        self.k = k

    def forward(self, x):
        x = self.cv1(x)
        y1 = pool_same(x, self.k)
        y2 = pool_same(y1, self.k)
        y3 = pool_same(y2, self.k)
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


# ---------------------------------------------------------------------------
# the long tail of the YAML registry (JAX nn/layers.py:243-779): modules no
# shipped config uses, for the reference's other YAMLs
# ---------------------------------------------------------------------------

def DWConv(c1: int, c2: int, k=1, s=1, act=True) -> Conv:
    """Depthwise conv: a Conv with g = gcd(c1, c2) (reference
    common.py:43-45). A grouped conv never takes the fused 64-channel
    kernel (Conv.fused needs g == 1)."""
    return Conv(c1, c2, k, s, g=math.gcd(c1, c2), act=act)


class BottleneckCSP(nn.Module):
    """CSP bottleneck (reference common.py:197-213): cv1 and the inner
    bottlenecks m0..m{n-1} on one path, the bare 1x1 convs cv3 (after the
    bottlenecks) and cv2 (on the input), BatchNorm and LeakyReLU(0.1) over
    both, then cv4. cv2 and cv3 are plain convs, as in flax."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = nn.Conv2d(c1, c_, 1, 1, bias=False)
        self.cv3 = nn.Conv2d(c_, c_, 1, 1, bias=False)
        self.cv4 = Conv(2 * c_, c2, 1, 1)
        self.bn = BatchNorm2d(2 * c_, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.n = n
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c_, c_, shortcut, g, e=1.0))

    def forward(self, x):
        y1 = self.cv1(x)
        for i in range(self.n):
            y1 = getattr(self, f"m{i}")(y1)
        y = torch.cat([self.cv3(y1), self.cv2(x)], dim=1)
        return self.cv4(F.leaky_relu(self.bn(y), 0.1))


class DenseGeneral(nn.Module):
    """flax's DenseGeneral as MultiHeadDotProductAttention uses it, with its
    kernel in flax's own layout (utils/convert.py keeps 3-D kernels as they
    are): ``heads`` splits the output into (heads, dk) (the query, key and
    value projections: kernel (c, heads, dk), bias (heads, dk)); ``merge``
    contracts an input (heads, dk) into c (the output projection: kernel
    (heads, dk, c), bias (c,))."""

    def __init__(self, c: int, heads: int, merge: bool = False):
        super().__init__()
        dk = c // heads
        self.merge = merge
        self.fan_in = heads * dk if merge else c
        shape = (heads, dk, c) if merge else (c, heads, dk)
        bound = 1.0 / math.sqrt(self.fan_in)
        self.kernel = nn.Parameter(torch.empty(shape).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.zeros(c if merge else (heads, dk)))

    def forward(self, x):
        if self.merge:
            return torch.einsum("bnhd,hdc->bnc", x, self.kernel) + self.bias
        return torch.einsum("bnc,chd->bnhd", x, self.kernel) + self.bias


class MultiHeadDotProductAttention(nn.Module):
    """flax's MultiHeadDotProductAttention without dropout (its default in
    the JAX TransformerLayer): per-head queries scaled by 1/sqrt(dk),
    softmax over the keys, the heads merged by ``out``. Plain PyTorch, as
    the JAX package computes it outside any Pallas kernel."""

    def __init__(self, c: int, heads: int):
        super().__init__()
        self.query = DenseGeneral(c, heads)
        self.key = DenseGeneral(c, heads)
        self.value = DenseGeneral(c, heads)
        self.out = DenseGeneral(c, heads, merge=True)

    def forward(self, q, k, v):
        q, k, v = self.query(q), self.key(k), self.value(v)
        q = q / math.sqrt(q.shape[-1])
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class TransformerLayer(nn.Module):
    """ViT layer without LayerNorms (reference common.py:63-77) on (B, N, c)
    tokens: bias-free q, k, v, the attention ``ma``, a residual, the
    bias-free fc1 -> fc2 and a residual."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        for name in ("q", "k", "v", "fc1", "fc2"):
            self.add_module(name, nn.Linear(c, c, bias=False))
        self.ma = MultiHeadDotProductAttention(c, num_heads)

    def forward(self, x):
        x = self.ma(self.q(x), self.k(x), self.v(x)) + x
        return self.fc2(self.fc1(x)) + x


class TransformerBlock(nn.Module):
    """Optional Conv to c2, flatten to tokens, add the learned embedding
    ``linear`` of them, N TransformerLayers tr0.., unflatten (reference
    common.py:80-106)."""

    def __init__(self, c1: int, c2: int, num_heads: int, num_layers: int):
        super().__init__()
        if c1 != c2:
            self.conv = Conv(c1, c2)
        self.linear = nn.Linear(c2, c2)
        self.n = num_layers
        for i in range(num_layers):
            self.add_module(f"tr{i}", TransformerLayer(c2, num_heads))

    def forward(self, x):
        if hasattr(self, "conv"):
            x = self.conv(x)
        b, c, h, w = x.shape
        p = x.flatten(2).transpose(1, 2)
        x = p + self.linear(p)
        for i in range(self.n):
            x = getattr(self, f"tr{i}")(x)
        return x.transpose(1, 2).reshape(b, c, h, w)


class C3TR(nn.Module):
    """C3 whose inner stack is a TransformerBlock of 4 heads and n layers
    (reference common.py:230-235)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = TransformerBlock(c_, c_, 4, n)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class SPP(nn.Module):
    """Spatial pyramid pooling at k = (5, 9, 13) (reference
    common.py:238-249), each pool ``pool_same``."""

    def __init__(self, c1: int, c2: int, k: Tuple[int, ...] = (5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * (len(k) + 1), c2, 1, 1)
        self.k = tuple(k)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [pool_same(x, k) for k in self.k],
                                  dim=1))


class Contract(nn.Module):
    """Height and width into channels by ``gain`` s (reference
    common.py:285-296): (B, C, H, W) -> (B, s*s*C, H/s, W/s), channel
    (sy*s + sx)*C + c."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        b, c, h, w = x.shape
        s = self.gain
        x = x.view(b, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
        return x.reshape(b, c * s * s, h // s, w // s)


class Expand(nn.Module):
    """Channels into height and width by ``gain`` s, Contract's inverse
    (reference common.py:299-310)."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        b, c, h, w = x.shape
        s = self.gain
        x = x.view(b, s, s, c // (s * s), h, w).permute(0, 3, 4, 1, 5, 2)
        return x.reshape(b, c // (s * s), h * s, w * s)


class MaxPool2d(nn.Module):
    """nn.MaxPool2d as the YAML rows give it: kernel k, stride s, padding
    p (with -inf)."""

    def __init__(self, k: int = 2, s: int = 2, p: int = 0):
        super().__init__()
        self.k, self.s, self.p = k, s, p

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p)


class BatchNormLayer(nn.Module):
    """The YAML module ``BatchNorm2d``: a lone BatchNorm (child ``bn``, the
    flax name) over the layer's c1 channels, with the Conv block's
    settings. (``BatchNorm2d`` above is the class every BatchNorm uses.)"""

    def __init__(self, c1: int):
        super().__init__()
        self.bn = BatchNorm2d(c1, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        return self.bn(x)


class CrossConv(nn.Module):
    """(1, k) then (k, 1) Conv, with an optional residual (reference
    experimental.py:11-22)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1,
                 e: float = 1.0, shortcut: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, (1, k), (1, s))
        self.cv2 = Conv(c_, c2, (k, 1), (s, 1), g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class Sum(nn.Module):
    """The (weighted) sum of n maps (reference experimental.py:25-43). With
    ``weight``, the learned gains are 2 sigmoid(w), w initialised to
    -arange(1, n) / 2, the flax parameter ``w``. Like the JAX package's
    Sum, it is not in the YAML registry."""

    def __init__(self, n: int, weight: bool = False):
        super().__init__()
        self.n = n
        self.weight = weight
        if weight:
            self.w = nn.Parameter(-torch.arange(1.0, n) / 2)

    def forward(self, xs: Sequence[torch.Tensor]):
        y = xs[0]
        if self.weight:
            w = torch.sigmoid(self.w) * 2
            for i in range(self.n - 1):
                y = y + xs[i + 1] * w[i]
        else:
            for i in range(self.n - 1):
                y = y + xs[i + 1]
        return y


class GhostConv(nn.Module):
    """Half the channels from a Conv, the other half from a 5x5 depthwise
    Conv of them (reference experimental.py:46-56)."""

    def __init__(self, c1: int, c2: int, k=1, s=1, g: int = 1, act=True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, None, g, act)
        self.cv2 = Conv(c_, c_, 5, 1, None, c_, act)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], dim=1)


class GhostBottleneck(nn.Module):
    """GhostConv conv0 -> (stride 2: DWConv) -> GhostConv conv2, plus the
    input or, at stride 2, a DWConv and a 1x1 Conv sc_pw of it (reference
    experimental.py:59-71). flax names the two unnamed DWConvs Conv_0 (main
    path) and Conv_1 (shortcut)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.s = s
        self.conv0 = GhostConv(c1, c_, 1, 1)
        self.conv2 = GhostConv(c_, c2, 1, 1, act=False)
        if s == 2:
            self.Conv_0 = DWConv(c_, c_, k, s, act=False)
            self.Conv_1 = DWConv(c1, c1, k, s, act=False)
            self.sc_pw = Conv(c1, c2, 1, 1, act=False)

    def forward(self, x):
        y = self.conv0(x)
        if self.s == 2:
            y = self.Conv_0(y)
        y = self.conv2(y)
        sc = self.sc_pw(self.Conv_1(x)) if self.s == 2 else x
        return y + sc


def equal_split(c2: int, groups: int) -> list:
    """MixConv2d's equal_ch split (reference experimental.py:79-81): the
    bucket sizes of floor(linspace(0, groups - 1e-6, c2))."""
    idx = np.floor(np.linspace(0, groups - 1e-6, c2))
    return [int((idx == g).sum()) for g in range(groups)]


class MixConv2d(nn.Module):
    """Bare convs m0.. of kernel sizes k on the input, their outputs
    concatenated (equal_split channels each), BatchNorm, LeakyReLU(0.1)
    and a residual (reference experimental.py:74-95)."""

    def __init__(self, c1: int, c2: int, k: Tuple[int, ...] = (1, 3),
                 s: int = 1):
        super().__init__()
        self.groups = len(k)
        for g, (kk, c) in enumerate(zip(k, equal_split(c2, len(k)))):
            self.add_module(f"m{g}", nn.Conv2d(c1, c, kk, s, kk // 2,
                                               bias=False))
        self.bn = BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        y = torch.cat([getattr(self, f"m{g}")(x) for g in range(self.groups)],
                      dim=1)
        return x + F.leaky_relu(self.bn(y), 0.1)


class SE_Block(nn.Module):
    """Squeeze-and-excitation (reference common.py:893-913): spatial mean,
    bias-free fc1 (c1 -> c1 / ratio), ReLU, fc2, sigmoid gate."""

    def __init__(self, c1: int, ratio: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(c1, c1 // ratio, bias=False)
        self.fc2 = nn.Linear(c1 // ratio, c1, bias=False)

    def forward(self, x):
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean((2, 3))))))
        return x * y[:, :, None, None]


class ChannelAttention(nn.Module):
    """CBAM's channel gate (reference common.py:916-939): one bias-free MLP
    (flax's unnamed Dense_0, ReLU, Dense_1) applied to the spatial mean and
    the spatial max, summed, sigmoid."""

    def __init__(self, c1: int, ratio: int = 16):
        super().__init__()
        self.Dense_0 = nn.Linear(c1, c1 // ratio, bias=False)
        self.Dense_1 = nn.Linear(c1 // ratio, c1, bias=False)

    def forward(self, x):
        mlp = lambda t: self.Dense_1(F.relu(self.Dense_0(t)))
        y = torch.sigmoid(mlp(x.mean((2, 3))) + mlp(x.amax((2, 3))))
        return x * y[:, :, None, None]


class SpatialAttention(nn.Module):
    """CBAM's spatial gate (reference common.py:942-957): the channel mean
    and max through a bias-free k x k conv to one channel, sigmoid."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, kernel_size, 1, kernel_size // 2,
                              bias=False)

    def forward(self, x):
        y = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)],
                      dim=1)
        return x * torch.sigmoid(self.conv(y))


class CBAM(nn.Module):
    """Channel then spatial attention, ca then sa (reference
    common.py:960-982)."""

    def __init__(self, c1: int, ratio: int = 16, kernel_size: int = 7):
        super().__init__()
        self.ca = ChannelAttention(c1, ratio)
        self.sa = SpatialAttention(kernel_size)

    def forward(self, x):
        return self.sa(self.ca(x))


class Classify(nn.Module):
    """Classification head (reference common.py:556-566): the spatial mean of
    each input, concatenated, a k x k conv with bias, flattened to
    (B, c2)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k), groups=g)

    def forward(self, x):
        xs = x if isinstance(x, (list, tuple)) else [x]
        z = torch.cat([y.mean((2, 3), keepdim=True) for y in xs], dim=1)
        return self.conv(z).flatten(1)
