"""Cross-modal fusion: the TransformerFusionBlock (DMFF) and its parts.

Counterparts of the JAX package's nn/fusion.py (reference
models/common.py:579-891), NCHW maps and (B, N, C) tokens:

- ``adaptive_pool2d``: floor-mode pooling when the map is at least the
  anchor grid, true adaptive pooling otherwise;
- ``LearnableWeights``: w1 * avg + w2 * max;
- ``CrossAttention``: per-modality LayerNorm (eps 1e-6), the fused dual
  cross-attention kernel (kernels/cross_attention.py) in eval mode, the
  differentiable einsum path with dropout in train mode, output
  projections;
- ``CrossTransformerBlock``: 8 learnable residual gains, the shared MLP
  LayerNorm, exact GELU, ``loops_num`` parameter-shared iterations;
- ``TransformerFusionBlock``: pool to the anchor grid, positional embedding,
  cross transformer, resize back (linear in eval mode, the reference's
  nearest in train mode), residual, concat, 1x1 Conv.

LayerNorms run in float32 whatever the model dtype, as the JAX modules do
(``nn.LayerNorm(dtype=jnp.float32)``); everything else runs in the dtype of
the activations (the parameters' dtype, or autocast's in training).
Dropout sits where flax has it: on the attention probabilities, on both
output projections and on each MLP's output, p = 0.1 by default.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from icafusion_tpu_torch.kernels.cross_attention import (NAMES,
                                                          dual_cross_attention)
from icafusion_tpu_torch.nn.layers import Conv

LN_EPS = 1e-6   # flax LayerNorm's default, not torch's 1e-5


def adaptive_pool2d(x, out_h: int, out_w: int, pool_type: str = "avg"):
    """Pool (B, C, H, W) to exactly (out_h, out_w) (JAX nn/fusion.py:124-144).

    When both dims are at least the target: floor mode, stride = in // out,
    kernel = in - (out - 1) * stride, no padding (reference
    common.py:868-891). Otherwise true adaptive pooling, whose windows
    [floor(i*n/m), ceil((i+1)*n/m)) are defined for every geometry."""
    h, w = x.shape[-2:]
    if h == out_h and w == out_w:
        return x
    if h >= out_h and w >= out_w:
        sh, sw = h // out_h, w // out_w
        k = (h - (out_h - 1) * sh, w - (out_w - 1) * sw)
        pool = F.avg_pool2d if pool_type == "avg" else F.max_pool2d
        return pool(x, k, (sh, sw))
    pool = (F.adaptive_avg_pool2d if pool_type == "avg"
            else F.adaptive_max_pool2d)
    return pool(x, (out_h, out_w))


@functools.lru_cache(maxsize=64)
def _linear_resize_matrix(n_in: int, n_out: int, device: torch.device,
                          dtype: torch.dtype) -> torch.Tensor:
    """(n_out, n_in) weights of jax.image.resize(method="linear") along one
    axis: half-pixel centres, a triangle kernel widened by in/out when
    downsampling (antialias), rows normalised to sum 1. Upsampling gives
    exactly bilinear interpolation with align_corners=False. Cached on the
    device, so a forward copies nothing from the host."""
    scale = np.float32(n_out) / np.float32(n_in)
    inv = np.float32(1.0) / scale
    kernel_scale = max(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0)
    return torch.from_numpy(np.ascontiguousarray(w.T, dtype=np.float32)).to(
        device, dtype)


def resize_linear(x, out_h: int, out_w: int):
    """Resize (B, C, H, W) to (out_h, out_w) as jax.image.resize 'linear'."""
    h, w = x.shape[-2:]
    wh = _linear_resize_matrix(h, out_h, x.device, x.dtype)
    ww = _linear_resize_matrix(w, out_w, x.device, x.dtype)
    return torch.einsum("bchw,Hh,Ww->bcHW", x, wh, ww)


class Dropout(nn.Module):
    """flax's nn.Dropout: in train mode each value is zeroed with
    probability p and the rest are scaled by 1 / (1 - p). The mask is drawn
    from ``generator`` where one is set (train/trainer.py sets its own),
    else from torch's default generator."""

    def __init__(self, p: float = 0.1):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0:
            return x
        keep = torch.empty_like(x).bernoulli_(1 - self.p,
                                              generator=self.generator)
        return x * keep / (1 - self.p)


def nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """torch's nearest resize: output i reads input floor(i * in / out)
    (asymmetric, not half-pixel), as the JAX package computes it."""
    return np.floor(np.arange(n_out) * (n_in / n_out)).astype(np.int64)


@functools.lru_cache(maxsize=64)
def _nearest_index_tensor(n_in: int, n_out: int,
                          device: torch.device) -> torch.Tensor:
    """nearest_indices on the device, cached: a forward copies nothing from
    the host (a copy from pageable memory would wait for the card)."""
    return torch.from_numpy(nearest_indices(n_in, n_out)).to(device)


class LearnableWeights(nn.Module):
    """x1 * w1 + x2 * w2, both scalars initialised to 0.5 (common.py:579-587)."""

    def __init__(self):
        super().__init__()
        self.w1 = nn.Parameter(torch.full((1,), 0.5))
        self.w2 = nn.Parameter(torch.full((1,), 0.5))

    def forward(self, x1, x2):
        return x1 * self.w1.to(x1.dtype) + x2 * self.w2.to(x2.dtype)


class CrossAttention(nn.Module):
    """Dual cross-attention (common.py:590-687): each modality's values are
    attended by the other modality's queries. Returns [out_vis, out_ir]."""

    def __init__(self, d_model: int, h: int = 8, attn_pdrop: float = 0.1,
                 resid_pdrop: float = 0.1):
        super().__init__()
        self.h = h
        for name in NAMES:
            self.add_module(name, nn.Linear(d_model, d_model))
        self.ln_vis = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ln_ir = nn.LayerNorm(d_model, eps=LN_EPS)
        self.out_vis = nn.Linear(d_model, d_model)
        self.out_ir = nn.Linear(d_model, d_model)
        self.attn_drop = Dropout(attn_pdrop)
        self.resid_drop = Dropout(resid_pdrop)

    def forward(self, vis, ir):
        if self.training:
            a_vis, a_ir = self._attend_train(vis, ir)
        else:
            dt = self.out_vis.weight.dtype
            vis_n = self.ln_vis(vis.float()).to(dt)
            ir_n = self.ln_ir(ir.float()).to(dt)
            lins = [getattr(self, n) for n in NAMES]
            a_vis, a_ir = dual_cross_attention(
                vis_n, ir_n, [m.weight for m in lins],
                [m.bias.float() for m in lins], num_heads=self.h)
        return [self.resid_drop(self.out_vis(a_vis)),
                self.resid_drop(self.out_ir(a_ir))]

    def _attend_train(self, vis, ir):
        """The JAX einsum path (nn/fusion.py:237-266), differentiable:
        projections in the activation dtype, logits and softmax in float32,
        dropout on the probabilities cast back to the activation dtype, the
        value product accumulated in float32."""
        b, n, d = vis.shape
        dk = d // self.h
        dt = vis.dtype
        vis_n = self.ln_vis(vis.float()).to(dt)
        ir_n = self.ln_ir(ir.float()).to(dt)

        def heads(x, name):  # (b, n, d) -> (b, h, n, dk)
            y = getattr(self, name)(x)
            return y.reshape(b, n, self.h, dk).transpose(1, 2)

        # products in float32 even under autocast (a meta tensor, traced
        # for shapes, takes the CPU's switch)
        dev = vis.device.type if vis.device.type == "cuda" else "cpu"

        def attend(q, k, v):
            with torch.autocast(dev, enabled=False):
                logits = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                                      k.float()) * (1.0 / math.sqrt(dk))
                a = torch.softmax(logits, dim=-1).to(q.dtype)
            a = self.attn_drop(a)
            with torch.autocast(dev, enabled=False):
                o = torch.einsum("bhqk,bhkd->bhqd", a.float(), v.float())
            return o.to(q.dtype).transpose(1, 2).reshape(b, n, d)

        return (attend(heads(ir_n, "q_ir"), heads(vis_n, "k_vis"),
                       heads(vis_n, "v_vis")),
                attend(heads(vis_n, "q_vis"), heads(ir_n, "k_ir"),
                       heads(ir_n, "v_ir")))


class CrossTransformerBlock(nn.Module):
    """Cross-attention block with 8 residual gains and parameter-shared
    iterations (common.py:690-759). One LayerNorm (``mlp_ln``) feeds both
    modalities' MLPs, as the reference's single LN2 does."""

    def __init__(self, d_model: int, h: int = 8, block_exp: int = 4,
                 loops_num: int = 1, attn_pdrop: float = 0.1,
                 resid_pdrop: float = 0.1):
        super().__init__()
        self.loops_num = loops_num
        self.crossatt = CrossAttention(d_model, h, attn_pdrop, resid_pdrop)
        self.mlp_ln = nn.LayerNorm(d_model, eps=LN_EPS)
        for m in ("mlp_vis", "mlp_ir"):
            self.add_module(f"{m}_fc1", nn.Linear(d_model, block_exp * d_model))
            self.add_module(f"{m}_fc2", nn.Linear(block_exp * d_model, d_model))
        self.coefficients = nn.Parameter(torch.ones(8))
        self.mlp_drop = Dropout(resid_pdrop)

    def _mlp(self, name: str, x):
        dt = self.coefficients.dtype
        y = self.mlp_ln(x.float()).to(dt)
        y = F.gelu(getattr(self, f"{name}_fc1")(y), approximate="none")
        return self.mlp_drop(getattr(self, f"{name}_fc2")(y))

    def forward(self, vis, ir):
        c = self.coefficients.to(vis.dtype)
        for _ in range(self.loops_num):
            a_vis, a_ir = self.crossatt(vis, ir)
            vis_att = c[0] * vis + c[1] * a_vis
            ir_att = c[2] * ir + c[3] * a_ir
            vis = c[4] * vis_att + c[5] * self._mlp("mlp_vis", vis_att)
            ir = c[6] * ir_att + c[7] * self._mlp("mlp_ir", ir_att)
        return vis, ir


class TransformerFusionBlock(nn.Module):
    """DMFF (common.py:762-865). YAML args [d_model, vert_anchors,
    horz_anchors]; the main path uses (256, 20, 20), (512, 16, 16) and
    (1024, 10, 10). flax declares an embedding dropout that it never
    applies; so none is here."""

    def __init__(self, d_model: int, vert_anchors: int = 16,
                 horz_anchors: int = 16, h: int = 8, block_exp: int = 4,
                 n_layer: int = 1, attn_pdrop: float = 0.1,
                 resid_pdrop: float = 0.1):
        super().__init__()
        self.grid = (vert_anchors, horz_anchors)
        seq = vert_anchors * horz_anchors
        self.pos_emb_vis = nn.Parameter(torch.zeros(1, seq, d_model))
        self.pos_emb_ir = nn.Parameter(torch.zeros(1, seq, d_model))
        self.vis_coefficient = LearnableWeights()
        self.ir_coefficient = LearnableWeights()
        self.n_layer = n_layer
        for i in range(n_layer):
            self.add_module(f"crosstransformer{i}",
                            CrossTransformerBlock(d_model, h, block_exp,
                                                  attn_pdrop=attn_pdrop,
                                                  resid_pdrop=resid_pdrop))
        self.conv1x1_out = Conv(d_model * 2, d_model, k=1, s=1, p=0)

    def _pool_flat(self, x, coeff: LearnableWeights, pos):
        va, ha = self.grid
        y = coeff(adaptive_pool2d(x, va, ha, "avg"),
                  adaptive_pool2d(x, va, ha, "max"))      # (b, c, va, ha)
        return y.flatten(2).transpose(1, 2) + pos.to(y.dtype)   # (b, va*ha, c)

    def _up_residual(self, flat, x):
        b, c, hh, ww = x.shape
        y = flat.transpose(1, 2).reshape(b, c, *self.grid)
        if self.training:       # nearest, as the reference trains
            iy, ix = (_nearest_index_tensor(g, n, y.device)
                      for g, n in zip(self.grid, (hh, ww)))
            y = y[:, :, iy][:, :, :, ix]
        else:
            y = resize_linear(y, hh, ww)
        return y.to(x.dtype) + x

    def forward(self, xs):
        vis, ir = xs
        vis_flat = self._pool_flat(vis, self.vis_coefficient, self.pos_emb_vis)
        ir_flat = self._pool_flat(ir, self.ir_coefficient, self.pos_emb_ir)
        for i in range(self.n_layer):
            vis_flat, ir_flat = getattr(self, f"crosstransformer{i}")(
                vis_flat, ir_flat)
        y = torch.cat([self._up_residual(vis_flat, vis),
                       self._up_residual(ir_flat, ir)], dim=1)
        return self.conv1x1_out(y)
