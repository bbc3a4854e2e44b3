"""Fused dual cross-attention: the DMFF fusion step of the inference path.

Replaces the Pallas TPU kernel ``icafusion_tpu/kernels/cross_attention.py:
dual_cross_attention`` (body ``_dca_kernel``). For LayerNorm'd tokens
vis, ir of shape (B, N, D) and h heads of width dk = D / h it computes the six
projections q/k/v of both modalities and both attention directions

    out_vis = softmax(q_ir  k_vis^T / sqrt(dk)) v_vis
    out_ir  = softmax(q_vis k_ir^T  / sqrt(dk)) v_ir

and returns the concatenated heads (B, N, D) of each, before the output
projections. ``dual_cross_attention`` launches the CUDA kernel of
``csrc/dual_cross_attention.cu`` on CUDA tensors (in bf16: the six
projections as one wgmma GEMM fed by TMA, then a flash-attention core on
mma.sync tensor cores; in fp32: CUDA cores, no TF32) and runs
``dual_cross_attention_reference``, the plain PyTorch version, on CPU
tensors only.

Weights are in torch Linear layout (out, in); biases are (D,).
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from icafusion_tpu_torch.kernels import _build

NAMES = ("q_vis", "k_vis", "v_vis", "q_ir", "k_ir", "v_ir")


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


def dual_cross_attention(vis, ir, weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor], num_heads: int = 8):
    """Both attention directions, projections included. weights: six
    (D, D) tensors in the order of NAMES, in vis's dtype; biases: six (D,).
    On CUDA: float32 or bfloat16 tokens, float32 accumulation and softmax,
    output in the token dtype; bfloat16 rounds q/k/v and the probabilities
    to bfloat16 before their products, as the plain version does."""
    if vis.device.type == "cpu":
        return dual_cross_attention_reference(vis, ir, weights, biases,
                                              num_heads)
    if vis.device.type != "cuda":
        raise ValueError(f"unsupported device {vis.device}")
    B, N, D = vis.shape
    dt = vis.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dual_cross_attention: dtype {dt} not supported")
    if D % num_heads or D // num_heads > 128:
        raise ValueError(f"dual_cross_attention: D={D}, h={num_heads}: "
                         "needs D % h == 0 and D / h <= 128")
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
    dk = D // num_heads
    if dt == torch.bfloat16:
        # TMA reads rows of D values: 16-byte aligned rows and bases
        if D % 8 or any(t.data_ptr() % 16 for t in (vis, ir, *weights)):
            raise ValueError("dual_cross_attention: bfloat16 needs D % 8 == 0 "
                             "and 16-byte aligned tokens and weights")
        # q/k/v rows padded to the flash kernel's width, the padding zero
        dkp = next(p for p in (16, 32, 64, 128) if p >= dk)
        alloc = torch.empty if dkp == dk else torch.zeros
        qkv = alloc((6, B, num_heads, N, dkp), device=vis.device, dtype=dt)
    else:
        qkv = torch.empty((6, B, num_heads, N, dk), device=vis.device,
                          dtype=torch.float32)
    out_vis = torch.empty_like(vis)
    out_ir = torch.empty_like(vis)
    w_ptrs = (ctypes.c_void_p * 6)(*[w.data_ptr() for w in weights])
    b_ptrs = (ctypes.c_void_p * 6)(*[b.data_ptr() for b in biases])
    with torch.cuda.device(vis.device):
        err = _build.library().icaf_dual_cross_attention(
            vis.data_ptr(), ir.data_ptr(), ctypes.addressof(w_ptrs),
            ctypes.addressof(b_ptrs), qkv.data_ptr(), out_vis.data_ptr(),
            out_ir.data_ptr(), B, N, D, num_heads, int(dt == torch.bfloat16),
            _build.stream_handle(vis.device))
    _build.check(err, "dual_cross_attention")
    dual_cross_attention.launches += 1
    return out_vis, out_ir


dual_cross_attention.launches = 0
