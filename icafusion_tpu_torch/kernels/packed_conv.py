"""Fused 3x3 Conv + BatchNorm + SiLU at 64 channels, stride 1.

Replaces the Pallas TPU kernel ``icafusion_tpu/kernels/packed_conv.py:
packed_conv3x3_silu`` (body ``_kernel``, weights from ``pack_weights``),
which computes ``SiLU(conv3x3_same(x, w) * scale + bias)`` for 64 -> 64
channels. The TPU kernel packs pixel pairs into its 128 lanes; the CUDA
kernels of ``csrc/conv3x3_bn_silu.cu`` are implicit GEMMs instead:
persistent, their halos in a ring of shared-memory buffers, multiplied
with wgmma. In bf16 one block holds all 64 output channels' weights; in
fp32 the products run on tf32 tensor cores with the 3xTF32 split (each
operand big + small, three products, fp32 accuracy, bound by 165
TFLOP/s), and the split weights of all 64 channels (295 KB) outgrow a
block, so a block owns 32 of them. Each dtype's kernel takes one of three
routes (``route``): channels_last maps by TMA; NCHW maps, which an
ordinary (B, 3, H, W) tensor gives (a ``.pt2`` program, ``cli.export
--validate``, Grad-CAM, ensembles, a ``hub.create`` model), by TMA over a
channel-major box where a row is a multiple of 16 bytes, else by the
threads' own loads.

``conv3x3_bn_silu`` launches that kernel on CUDA tensors and runs
``conv3x3_bn_silu_reference``, the plain PyTorch version, on CPU tensors
only. x is (B, 64, H, W), any H, W >= 1, dense in NCHW or in channels_last
(NHWC) memory; the output has x's layout. The serving path's activations are
channels_last, because the engine permutes its (n, H, W, 3) uint8 input, so
the kernel reads that layout as it is instead of copying it.

Where grad is enabled and an argument requires it, the CUDA call goes
through ``Conv3x3BnSilu`` (torch.autograd.Function): the kernel forward,
and the plain version's vjp recomputed on the saved inputs as its backward
(gradients for x, w, scale and bias). While ``torch.export`` traces, the
call is the custom operator ``icafusion::conv3x3_bn_silu``
(kernels/ops.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from icafusion_tpu_torch.kernels import _build
from icafusion_tpu_torch.kernels._vjp import plain_vjp

C = 64   # channels in and out


def conv3x3_bn_silu_reference(x, w, scale, bias):
    """F.conv2d in float32 on the inputs as given, then ``* scale + bias``,
    SiLU, and a cast to x's dtype."""
    y = F.conv2d(x.float(), w.float(), padding=1)
    y = y * scale.float()[:, None, None] + bias.float()[:, None, None]
    return F.silu(y).to(x.dtype)


# csrc/conv3x3_bn_silu.cu: Route (the C entry takes the index)
ROUTES = ("nhwc", "nchw_tma", "nchw_ld")


def route(x) -> str:
    """The kernel route of a (B, 64, H, W) x on the card (the C entry's
    route_of mirrors it and refuses another): "nhwc" where x is
    channels_last (a tensor dense in both layouts, H = W = 1, is); for
    NCHW "nchw_tma" where a row of x is a multiple of 16 bytes, as a TMA
    tensor map's strides must be (W % 8 == 0 in bf16, W % 4 == 0 in fp32),
    else "nchw_ld", where the kernel's threads load the halo themselves."""
    if x.is_contiguous(memory_format=torch.channels_last):
        return "nhwc"
    return ("nchw_tma" if x.shape[3] * x.element_size() % 16 == 0
            else "nchw_ld")


def conv3x3_bn_silu(x, w, scale, bias):
    """x: (B, 64, H, W) float32 or bfloat16, contiguous or channels_last
    contiguous; w: (64, 64, 3, 3) contiguous in x's dtype; scale, bias:
    (64,) float32, the folded eval-mode BatchNorm. Returns
    SiLU(conv3x3(x, w, padding=1) * scale + bias) in x's dtype and memory
    layout, accumulated in float32."""
    if torch.compiler.is_exporting():
        from icafusion_tpu_torch.kernels import ops
        return ops.conv3x3_bn_silu(x, w, scale, bias)
    if x.device.type == "cpu":
        return conv3x3_bn_silu_reference(x, w, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w, scale, bias)):
        return Conv3x3BnSilu.apply(x, w, scale, bias)
    return launch(x, w, scale, bias)


def launch(x, w, scale, bias):
    """Check the arguments, launch the kernel on CUDA tensors, count it."""
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
    r = route(x)
    if r != "nhwc" and not x.is_contiguous():
        raise ValueError("conv3x3_bn_silu: x must be contiguous in NCHW or "
                         "in channels_last")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv3x3_bn_silu: x and w must be 16-byte aligned")
    B, _, H, W = x.shape
    out = torch.empty_like(x)   # x's layout (preserve_format)
    with torch.cuda.device(x.device):
        err = _build.library().icaf_conv3x3_bn_silu(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, H, W, int(x.dtype == torch.bfloat16),
            int(r == "nhwc"), ROUTES.index(r), _build.stream_handle(x.device))
    _build.check(err, "conv3x3_bn_silu")
    conv3x3_bn_silu.launches += 1
    if x.dtype == torch.float32:
        conv3x3_bn_silu.tf32_launches += 1
    if r != "nhwc":
        conv3x3_bn_silu.nchw_launches += 1
    return out


conv3x3_bn_silu.launches = 0
# of them, the fp32 launches (the 3xTF32 kernels) and the NCHW launches
# (routes nchw_tma and nchw_ld)
conv3x3_bn_silu.tf32_launches = 0
conv3x3_bn_silu.nchw_launches = 0


class Conv3x3BnSilu(torch.autograd.Function):
    """The kernel forward with the plain version's vjp as its backward."""

    @staticmethod
    def forward(ctx, x, w, scale, bias):
        ctx.save_for_backward(x, w, scale, bias)
        return launch(x, w, scale, bias)

    @staticmethod
    def backward(ctx, g):
        return tuple(plain_vjp(conv3x3_bn_silu_reference, ctx.saved_tensors,
                               ctx.needs_input_grad, (g,)))
