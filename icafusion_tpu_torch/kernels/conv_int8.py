"""int8 W8A8 convolution with input quantization, dequantization, eval-mode
BatchNorm and SiLU in one kernel.

The JAX package runs its int8 conv through XLA, not Pallas
(``icafusion_tpu/nn/layers.py:154-176``, ``Conv._int8_conv``:
``lax.conv_general_dilated`` on int8 operands with an int32 result, then
``* s_w``, BatchNorm and the activation). PyTorch has no int8 convolution
on CUDA, so the port has its own kernel, ``csrc/conv_int8.cu``: an
implicit GEMM on ``mma.sync`` m16n8k32 s8 tensor-core tiles that quantizes
x in its operand load.

``conv_int8_bn_act`` launches that kernel on CUDA tensors and runs
``conv_int8_bn_act_reference``, the plain PyTorch version, on CPU tensors
only. Both compute

    x8  = clip(round_half_even(x / s_in[ci]), -127, 127)      (fp32 division)
    acc = conv(x8, w8)                                         (exact, int32)
    out = act(acc * mult + add)                                (fp32)
    mult = s_w * gamma / sqrt(var + eps), add = beta - mean * gamma / sqrt(..)

with the arithmetic of the epilogue in that order, rounded once to x's
dtype; ``epilogue=False`` returns ``acc`` itself. x is (B, Cin, H, W) in
any strides (channels_last on the serving path); the output is
channels_last.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from icafusion_tpu_torch.kernels import _build

BN = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, float]


def _pair(v) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else tuple(map(int, v))


def quantize_input(x: torch.Tensor, s_in: torch.Tensor) -> torch.Tensor:
    """x8 as float32 values: round half to even of the fp32 quotient
    (torch.round, as jnp.round), clamped to [-127, 127]."""
    s = s_in.float().reshape(-1, 1, 1) if s_in.dim() else s_in.float()
    return torch.clamp(torch.round(x.float() / s), -127, 127)


def fold_epilogue(s_w: torch.Tensor, bn: BN):
    """(mult, add) per output channel, in the kernel's fp32 order."""
    gamma, beta, mean, var, eps = bn
    g = gamma.float() * (1.0 / torch.sqrt(var.float() + eps))
    return s_w.float() * g, beta.float() - mean.float() * g


def conv_int8_bn_act_reference(x, w8, s_in, s_w, bn: BN, stride=1,
                               padding=0, act: bool = True,
                               epilogue: bool = True):
    """The plain version: quantize, convolve the int8 values in float64
    (exact: |acc| < 2^53), cast to int32, then the fp32 epilogue."""
    x8 = quantize_input(x, s_in).double()
    w = w8.permute(0, 3, 1, 2).double()
    acc = F.conv2d(x8, w, stride=_pair(stride), padding=_pair(padding))
    acc = acc.to(torch.int32).contiguous(memory_format=torch.channels_last)
    if not epilogue:
        return acc
    mult, add = fold_epilogue(s_w, bn)
    y = acc.float() * mult[:, None, None] + add[:, None, None]
    if act:
        y = F.silu(y)
    return y.to(x.dtype)


def conv_int8_bn_act(x, w8, s_in, s_w, bn: BN, stride=1, padding=0,
                     act: bool = True, epilogue: bool = True):
    """x: (B, Cin, H, W) float32 or bfloat16, any strides; w8: (Cout, kh,
    kw, Cin) int8, contiguous; s_in: (Cin,) or () float32; s_w: (Cout,)
    float32; bn: (gamma, beta, running_mean, running_var, eps) of the
    BatchNorm, float32 (Cout,) each (None without the epilogue). Returns
    act(BN(conv(x8, w8) * s_w)) in x's dtype, channels_last, or with
    epilogue=False the int32 accumulators. Ungrouped convs only."""
    if x.device.type == "cpu":
        return conv_int8_bn_act_reference(x, w8, s_in, s_w, bn, stride,
                                          padding, act, epilogue)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise TypeError(f"conv_int8_bn_act: x {tuple(x.shape)} {x.dtype}, "
                        "want (B, Cin, H, W) float32 or bfloat16")
    B, Cin, H, W = x.shape
    if w8.dtype != torch.int8 or w8.dim() != 4 or w8.shape[3] != Cin:
        raise ValueError(f"conv_int8_bn_act: w8 {tuple(w8.shape)} "
                         f"{w8.dtype}, want (Cout, kh, kw, {Cin}) int8 "
                         "(grouped convs are not supported)")
    Cout, kh, kw, _ = w8.shape
    if s_in.dim() == 0:
        s_in = s_in.expand(Cin).contiguous()
    if bn is None and epilogue:
        raise ValueError("conv_int8_bn_act: the epilogue needs bn")
    gamma, beta, mean, var, eps = bn or (s_w, s_w, s_w, s_w, 0.0)
    for t, n in ((s_in, Cin), (s_w, Cout), (gamma, Cout), (beta, Cout),
                 (mean, Cout), (var, Cout)):
        if t.shape != (n,) or t.dtype != torch.float32:
            raise ValueError("conv_int8_bn_act: s_in is (Cin,), s_w and the "
                             "BatchNorm tensors (Cout,), all float32")
    for t in (w8, s_in, s_w, gamma, beta, mean, var):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("conv_int8_bn_act: w8, the scales and the "
                             "BatchNorm tensors must be contiguous and on "
                             "x's device")
    if w8.data_ptr() % 16:
        raise ValueError("conv_int8_bn_act: w8 must be 16-byte aligned")
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    Ho, Wo = (H + 2 * ph - kh) // sh + 1, (W + 2 * pw - kw) // sw + 1
    if Ho <= 0 or Wo <= 0:
        raise ValueError(f"conv_int8_bn_act: empty output for {(H, W)}, "
                         f"kernel {(kh, kw)}, padding {(ph, pw)}")
    out = torch.empty((B, Cout, Ho, Wo),
                      dtype=x.dtype if epilogue else torch.int32,
                      device=x.device, memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        err = _build.library().icaf_conv_int8(
            x.data_ptr(), *x.stride(), w8.data_ptr(), s_in.data_ptr(),
            s_w.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            mean.data_ptr(), var.data_ptr(), ctypes.c_float(eps),
            out.data_ptr(), B, Cin, H, W, Cout, kh, kw, sh, sw, ph, pw, Ho,
            Wo, int(x.dtype == torch.bfloat16), int(bool(act)),
            int(bool(epilogue)), _build.stream_handle(x.device))
    _build.check(err, "conv_int8_bn_act")
    conv_int8_bn_act.launches += 1
    return out


conv_int8_bn_act.launches = 0

