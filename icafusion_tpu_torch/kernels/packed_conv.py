"""Fused 3x3 Conv + BatchNorm + SiLU at 64 channels, stride 1.

Replaces the Pallas TPU kernel ``icafusion_tpu/kernels/packed_conv.py:
packed_conv3x3_silu`` (body ``_kernel``, weights from ``pack_weights``),
which computes ``SiLU(conv3x3_same(x, w) * scale + bias)`` for 64 -> 64
channels. The TPU kernel packs pixel pairs into its 128 lanes; the CUDA
kernel of ``csrc/conv3x3_bn_silu.cu`` is an implicit GEMM instead: in bf16
channels_last (the serving path) a persistent kernel fed by TMA halo loads
that multiplies with wgmma; in bf16 NCHW WMMA tensor-core fragments; in
fp32 CUDA cores.

``conv3x3_bn_silu`` launches that kernel on CUDA tensors and runs
``conv3x3_bn_silu_reference``, the plain PyTorch version, on CPU tensors
only. x is (B, 64, H, W), any H, W >= 1, dense in NCHW or in channels_last
(NHWC) memory; the output has x's layout. The serving path's activations are
channels_last, because the engine permutes its (n, H, W, 3) uint8 input, so
the kernel reads that layout as it is instead of copying it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from icafusion_tpu_torch.kernels import _build

C = 64   # channels in and out


def conv3x3_bn_silu_reference(x, w, scale, bias):
    """F.conv2d in float32 on the inputs as given, then ``* scale + bias``,
    SiLU, and a cast to x's dtype."""
    y = F.conv2d(x.float(), w.float(), padding=1)
    y = y * scale.float()[:, None, None] + bias.float()[:, None, None]
    return F.silu(y).to(x.dtype)


def conv3x3_bn_silu(x, w, scale, bias):
    """x: (B, 64, H, W) float32 or bfloat16, contiguous or channels_last
    contiguous; w: (64, 64, 3, 3) contiguous in x's dtype; scale, bias:
    (64,) float32, the folded eval-mode BatchNorm. Returns
    SiLU(conv3x3(x, w, padding=1) * scale + bias) in x's dtype and memory
    layout, accumulated in float32."""
    if x.device.type == "cpu":
        return conv3x3_bn_silu_reference(x, w, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3x3_bn_silu: dtype {x.dtype} not supported")
    if x.dim() != 4 or x.shape[1] != C:
        raise ValueError(f"conv3x3_bn_silu: x {tuple(x.shape)}, want "
                         f"(B, {C}, H, W)")
    if w.shape != (C, C, 3, 3) or w.dtype != x.dtype:
        raise ValueError(f"conv3x3_bn_silu: w {tuple(w.shape)} {w.dtype}, "
                         f"want ({C}, {C}, 3, 3) {x.dtype}")
    for t in (scale, bias):
        if t.shape != (C,) or t.dtype != torch.float32:
            raise ValueError("conv3x3_bn_silu: scale and bias are (64,) "
                             "float32")
    for t in (w, scale, bias):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("conv3x3_bn_silu: w, scale and bias must be "
                             "contiguous and on x's device")
    # a tensor dense in both layouts (H = W = 1) takes the channels_last path
    nhwc = x.is_contiguous(memory_format=torch.channels_last)
    if not nhwc and not x.is_contiguous():
        raise ValueError("conv3x3_bn_silu: x must be contiguous in NCHW or "
                         "in channels_last")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv3x3_bn_silu: x and w must be 16-byte aligned")
    B, _, H, W = x.shape
    out = torch.empty_like(x)   # x's layout (preserve_format)
    bf16_nhwc = nhwc and x.dtype == torch.bfloat16
    # the bf16 channels_last kernel rearranges w itself; the others take a
    # pre-pass into this scratch
    packed = None if bf16_nhwc else torch.empty(w.numel(), dtype=w.dtype,
                                                device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().icaf_conv3x3_bn_silu(
            x.data_ptr(), w.data_ptr(),
            None if packed is None else packed.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), B, H, W,
            int(x.dtype == torch.bfloat16),
            int(nhwc), _build.stream_handle(x.device))
    _build.check(err, "conv3x3_bn_silu")
    conv3x3_bn_silu.launches += 1
    return out


conv3x3_bn_silu.launches = 0
