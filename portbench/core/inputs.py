"""Inputs and weights, made from the run's seed.

The pool: ``n`` RGB + thermal pairs of a FLIR-aligned frame (512 x 640),
the scene recipe of the measured package's synthetic set (coloured
rectangles on dark noise in RGB, the same boxes bright in IR, 1-3 boxes a
pair, the class the colour), drawn in bulk and letterboxed onto the square
canvas with gray (114) bands, as uint8 (n, H, W, 3) arrays in pageable host
memory. The weights: every tensor of the model's state dict drawn from one
CUDA (or CPU) generator in one call, each slice mapped onto its range.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

COLORS = np.array([(255, 40, 40), (40, 255, 40), (40, 40, 255)], np.uint8)
POOL_STREAM, ORDER_STREAM = 1, 2     # independent numpy streams of a seed


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def make_pool(seed: int, n: int, frame_hw: Tuple[int, int],
              canvas_hw: Tuple[int, int], nc: int = 3):
    """(rgb, ir, labels): two (n, H, W, 3) uint8 arrays on the canvas and,
    per pair, a (k, 5) float32 array [cls, cx, cy, w, h] normalised to the
    canvas."""
    g = rng(seed, POOL_STREAM)
    h, w = frame_hw
    H, W = canvas_hw
    r = min(H / h, W / w)
    if r != 1.0:
        raise ValueError("frames are letterboxed without a resize: the "
                         f"frame {frame_hw} must fit the canvas {canvas_hw}")
    top, left = int(round((H - h) / 2 - 0.1)), int(round((W - w) / 2 - 0.1))
    rgb = np.full((n, H, W, 3), 114, np.uint8)
    ir = np.full((n, H, W, 3), 114, np.uint8)
    rgb[:, top:top + h, left:left + w] = g.integers(0, 40, (n, h, w, 3),
                                                    dtype=np.uint8)
    ir[:, top:top + h, left:left + w] = g.integers(0, 30, (n, h, w, 3),
                                                   dtype=np.uint8)
    labels: List[np.ndarray] = []
    for i in range(n):
        rows = []
        for _ in range(int(g.integers(1, 4))):
            bw = int(g.uniform(0.15, 0.4) * w)
            bh = int(g.uniform(0.15, 0.4) * h)
            x1, y1 = int(g.uniform(0, w - bw)), int(g.uniform(0, h - bh))
            c = int(g.integers(0, nc))
            # filled corner to corner, inclusive, clipped to the frame
            ys = slice(top + y1, top + min(y1 + bh + 1, h))
            xs = slice(left + x1, left + min(x1 + bw + 1, w))
            rgb[i, ys, xs] = COLORS[c % len(COLORS)]
            ir[i, ys, xs] = 220
            rows.append([c, (left + x1 + bw / 2) / W, (top + y1 + bh / 2) / H,
                         bw / W, bh / H])
        labels.append(np.asarray(rows, np.float32))
    return rgb, ir, labels


def _ranges(name: str, t: torch.Tensor, owner: str):
    """(low, high) of the uniform draw of one state-dict entry, or None to
    leave it as constructed."""
    leaf = name.rsplit(".", 1)[-1]
    if t.dtype not in (torch.float32,):
        return None
    if owner == "conv_or_linear":
        fan_in = t[0].numel() if leaf == "weight" else None
        if leaf == "weight":
            b = math.sqrt(6.0 / fan_in)          # He-uniform
            return -b, b
        return None
    if owner == "batchnorm":
        # scale and shift put each SiLU's input at about N(0.3, 0.2^2)
        # once fit_batchnorm has set the statistics (see make_weights)
        if leaf == "weight":
            return 0.15, 0.25
        if leaf == "bias":
            return 0.25, 0.35
        return (0.8, 1.2) if leaf == "running_var" else (-0.1, 0.1)
    if owner == "norm":
        return (0.8, 1.2) if leaf == "weight" else (-0.1, 0.1)
    if leaf.startswith("pos_emb"):
        return -0.02, 0.02
    if leaf == "coefficients":
        return 0.8, 1.2
    if leaf in ("w1", "w2"):
        return 0.4, 0.6
    return None


@torch.no_grad()
def make_weights(model: torch.nn.Module, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """A state dict for ``model`` (the reference's module tree, whose names
    the measured package shares): conv and linear weights He-uniform, their
    biases U(+-1 / sqrt(fan_in)); BatchNorm scales U(0.15, 0.25) and shifts
    U(0.25, 0.35) (statistics U(0.8, 1.2) and U(-0.1, 0.1), which
    reference/model.py: fit_batchnorm then replaces); LayerNorm scales
    U(0.8, 1.2) and shifts U(-0.1, 0.1); positional embeddings
    U(-0.02, 0.02), residual gains U(0.8, 1.2), pooling blends U(0.4, 0.6).
    One generator call on ``device`` draws them all.

    Why these BatchNorm draws: with unit-variance inputs to every SiLU a
    deep random network amplifies a perturbation about 1.2x a layer
    (Var(SiLU(z)) < E[SiLU'(z)^2] for Gaussian z), and a bf16 rounding at
    the stem reaches the head as large as the signal. With a narrow input
    the SiLU is near-linear and a perturbation does not grow, as in a
    trained detector; with the input's mean small against its spread, an
    int8 step (absmax / 127) stays coarse against bf16's relative rounding,
    so a lower precision shows as a clearly larger error (PERF.md gives
    the readings of the draws tried on the card)."""
    owner: Dict[str, str] = {}
    fan: Dict[str, int] = {}
    for mname, m in model.named_modules():
        kind = ("conv_or_linear" if isinstance(m, (torch.nn.Conv2d,
                                                   torch.nn.Linear))
                else "batchnorm" if isinstance(m, torch.nn.BatchNorm2d)
                else "norm" if isinstance(m, torch.nn.LayerNorm)
                else None)
        if kind is None:
            continue
        for pname, _ in list(m.named_parameters(recurse=False)) + list(
                m.named_buffers(recurse=False)):
            full = f"{mname}.{pname}" if mname else pname
            owner[full] = kind
            if kind == "conv_or_linear":
                fan[full] = m.weight[0].numel()
    sd = {k: v for k, v in model.state_dict().items()}
    plan = []
    total = 0
    for k, v in sd.items():
        kind = owner.get(k, "other")
        rng_ = _ranges(k, v, kind)
        if kind == "conv_or_linear" and k.endswith(".bias"):
            b = 1.0 / math.sqrt(fan[k])
            rng_ = (-b, b)
        if rng_ is not None:
            plan.append((k, total, rng_))
            total += v.numel()
    dev = torch.device(device)
    gen = torch.Generator(dev)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    u = torch.rand(total, generator=gen, device=dev)
    out = {}
    for k, v in sd.items():
        if not v.is_meta:
            out[k] = v.to(dev)
        elif v.dtype == torch.long:          # BatchNorm's batch counter
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=dev)
    for k, off, (lo, hi) in plan:
        n = sd[k].numel()
        out[k] = (u[off:off + n] * (hi - lo) + lo).view(sd[k].shape)
    missing = set(sd) - set(out)
    if missing:
        raise ValueError(f"no draw for {sorted(missing)[:4]}")
    return out
