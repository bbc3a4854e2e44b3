"""Fused dual cross-attention: the DMFF fusion step of the inference path.

Replaces the Pallas TPU kernel ``icafusion_tpu/kernels/cross_attention.py:
dual_cross_attention`` (body ``_dca_kernel``). For LayerNorm'd tokens
vis, ir of shape (B, N, D) and h heads of width dk = D / h it computes the six
projections q/k/v of both modalities and both attention directions

    out_vis = softmax(q_ir  k_vis^T / sqrt(dk)) v_vis
    out_ir  = softmax(q_vis k_ir^T  / sqrt(dk)) v_ir

and returns the concatenated heads (B, N, D) of each, before the output
projections. ``dual_cross_attention`` launches the CUDA kernel of
``csrc/dual_cross_attention.cu`` on CUDA tensors (the six projections as
one wgmma GEMM fed by TMA, then a flash-attention core on mma.sync tensor
cores; in fp32 both on tf32 tensor cores with the 3xTF32 split, each
operand big + small, three products, fp32 accuracy, bound by 165 TFLOP/s;
192 KB of shared memory in the GEMM and up to 205 KB in the core) and
runs ``dual_cross_attention_reference``, the plain PyTorch version, on CPU
tensors only.

Where grad is enabled and a tensor argument requires it, the CUDA call goes
through ``DualCrossAttention`` (torch.autograd.Function): its forward
launches the kernel and its backward is the vjp of the plain version,
recomputed on the saved inputs (the JAX kernel has no backward kernel of
its own). While ``torch.export`` traces, the call is the custom operator
``icafusion::dual_cross_attention`` (kernels/ops.py), whose CUDA
implementation launches the same kernel.

Weights are in torch Linear layout (out, in); biases are (D,).
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from icafusion_tpu_torch.kernels import _build
from icafusion_tpu_torch.kernels._vjp import plain_vjp

NAMES = ("q_vis", "k_vis", "v_vis", "q_ir", "k_ir", "v_ir")
MAX_DK = 256          # the widest head the kernel is built for
# the head widths each flash core is built for (the tf32 core's k8 steps
# take 8, the bf16 core's k16 steps 16): q/k/v rows are padded to the next
# one, the padding zero; the kernel takes the width chosen here and refuses
# any other
BF16_DK_PADS = (16, 32, 64, 128, 192, 256)
F32_DK_PADS = (8,) + BF16_DK_PADS


def dual_cross_attention_reference(vis, ir, weights: Sequence[torch.Tensor],
                                   biases: Sequence[torch.Tensor],
                                   num_heads: int = 8):
    """The einsum path of the JAX CrossAttention (nn/fusion.py:237-266):
    projections in the input dtype, logits and softmax in float32, the
    probabilities cast back to the input dtype, the value product
    accumulated in float32 and cast to the input dtype."""
    b, n, d = vis.shape
    dk = d // num_heads
    dt = vis.dtype
    w = dict(zip(NAMES, weights))
    bias = dict(zip(NAMES, biases))

    def heads(x, name):  # (b, n, d) -> (b, h, n, dk)
        y = x @ w[name].to(dt).t() + bias[name].to(dt)
        return y.reshape(b, n, num_heads, dk).transpose(1, 2)

    scale = 1.0 / math.sqrt(dk)

    def attend(q, k, v):
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
        a = torch.softmax(logits, dim=-1).to(dt)
        o = torch.einsum("bhqk,bhkd->bhqd", a.float(), v.float())
        return o.to(dt).transpose(1, 2).reshape(b, n, d)

    out_vis = attend(heads(ir, "q_ir"), heads(vis, "k_vis"),
                     heads(vis, "v_vis"))
    out_ir = attend(heads(vis, "q_vis"), heads(ir, "k_ir"),
                    heads(ir, "v_ir"))
    return out_vis, out_ir


def check_args(D: int, num_heads: int, dtype) -> int:
    """Raise unless the kernel takes tokens (B, N, D) of ``dtype`` with
    ``num_heads`` heads, for any B and N: float32 or bfloat16, D % h == 0
    and dk = D / h at most MAX_DK, and rows of D values a multiple of 16
    bytes (TMA reads them): D % 4 == 0 in float32, D % 8 == 0 in bfloat16.
    Depends on the shape and dtype alone, not the device. Returns the
    width of a row of the q/k/v scratch, which the kernel is given: dk
    padded to F32_DK_PADS in float32, to BF16_DK_PADS in bfloat16."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dual_cross_attention: dtype {dtype} not supported")
    if num_heads < 1 or D % num_heads or D // num_heads > MAX_DK:
        raise ValueError(f"dual_cross_attention: D={D}, h={num_heads}: "
                         f"needs D % h == 0 and D / h <= {MAX_DK}")
    dk = D // num_heads
    f32 = dtype == torch.float32
    if D % (4 if f32 else 8):
        raise ValueError(f"dual_cross_attention: {str(dtype)[6:]} needs "
                         f"D % {4 if f32 else 8} == 0, got D={D}")
    return next(p for p in (F32_DK_PADS if f32 else BF16_DK_PADS)
                if p >= dk)


def dual_cross_attention(vis, ir, weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor], num_heads: int = 8):
    """Both attention directions, projections included. weights: six
    (D, D) tensors in the order of NAMES, in vis's dtype; biases: six (D,).
    On CUDA: float32 or bfloat16 tokens, float32 accumulation and softmax,
    output in the token dtype; bfloat16 rounds q/k/v and the probabilities
    to bfloat16 before their products, as the plain version does."""
    if torch.compiler.is_exporting():
        from icafusion_tpu_torch.kernels import ops
        return ops.dual_cross_attention(vis, ir, list(weights), list(biases),
                                        num_heads)
    if vis.device.type == "cpu":
        return dual_cross_attention_reference(vis, ir, weights, biases,
                                              num_heads)
    if vis.device.type != "cuda":
        raise ValueError(f"unsupported device {vis.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (vis, ir, *weights, *biases)):
        return DualCrossAttention.apply(vis, ir, num_heads, *weights,
                                        *biases)
    return launch(vis, ir, weights, biases, num_heads)


def launch(vis, ir, weights: Sequence[torch.Tensor],
           biases: Sequence[torch.Tensor], num_heads: int):
    """Check the arguments, launch the kernel on CUDA tensors, count it."""
    B, N, D = vis.shape
    dt = vis.dtype
    dkp = check_args(D, num_heads, dt)
    if ir.shape != vis.shape or ir.dtype != dt or ir.device != vis.device:
        raise ValueError("dual_cross_attention: vis and ir must match")
    if len(weights) != 6 or len(biases) != 6:
        raise ValueError("dual_cross_attention: six weights and six biases")
    for t in (vis, ir, *weights, *biases):
        if t.device != vis.device or not t.is_contiguous():
            raise ValueError("dual_cross_attention: every tensor must be "
                             "contiguous and on the tokens' device")
    for w, bias in zip(weights, biases):
        if w.shape != (D, D) or w.dtype != dt:
            raise ValueError(f"dual_cross_attention: weight {tuple(w.shape)} "
                             f"{w.dtype}, want ({D}, {D}) {dt}")
        if bias.shape != (D,) or bias.dtype != torch.float32:
            raise ValueError("dual_cross_attention: biases are (D,) float32")
    # TMA reads rows of D values from 16-byte aligned bases
    if any(t.data_ptr() % 16 for t in (vis, ir, *weights)):
        raise ValueError("dual_cross_attention: needs 16-byte aligned "
                         "tokens and weights")
    # q/k/v rows padded to the flash kernel's width, the padding zero
    alloc = torch.empty if dkp == D // num_heads else torch.zeros
    qkv = alloc((6, B, num_heads, N, dkp), device=vis.device, dtype=dt)
    out_vis = torch.empty_like(vis)
    out_ir = torch.empty_like(vis)
    w_ptrs = (ctypes.c_void_p * 6)(*[w.data_ptr() for w in weights])
    b_ptrs = (ctypes.c_void_p * 6)(*[b.data_ptr() for b in biases])
    with torch.cuda.device(vis.device):
        err = _build.library().icaf_dual_cross_attention(
            vis.data_ptr(), ir.data_ptr(), ctypes.addressof(w_ptrs),
            ctypes.addressof(b_ptrs), qkv.data_ptr(), out_vis.data_ptr(),
            out_ir.data_ptr(), B, N, D, num_heads, dkp,
            int(dt == torch.bfloat16),
            _build.stream_handle(vis.device))
    _build.check(err, "dual_cross_attention")
    dual_cross_attention.launches += 1
    if dt == torch.float32:
        dual_cross_attention.tf32_launches += 1
    return out_vis, out_ir


dual_cross_attention.launches = 0
# of them, the fp32 launches (the 3xTF32 kernels)
dual_cross_attention.tf32_launches = 0


class DualCrossAttention(torch.autograd.Function):
    """The kernel forward with the plain version's vjp as its backward:
    gradients for the tokens, the six weights and the six biases."""

    @staticmethod
    def forward(ctx, vis, ir, num_heads: int, *params):
        ctx.num_heads = num_heads
        ctx.save_for_backward(vis, ir, *params)
        return launch(vis, ir, params[:6], params[6:], num_heads)

    @staticmethod
    def backward(ctx, g_vis, g_ir):
        need = ctx.needs_input_grad
        grads = plain_vjp(
            lambda vis, ir, *p: dual_cross_attention_reference(
                vis, ir, p[:6], p[6:], ctx.num_heads),
            ctx.saved_tensors, need[:2] + need[3:], (g_vis, g_ir))
        return (*grads[:2], None, *grads[2:])
