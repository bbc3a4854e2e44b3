"""Anchor-based YOLO Detect head with the inference decode.

Counterpart of the JAX package's models/detect.py (reference
models/yolo_test.py:26-70): a 1x1 conv per level to na * (nc + 5) channels.
In train mode it returns those raw maps, one (B, ny, nx, na, 5 + nc) tensor
per level, for the loss (the JAX ``decode=False``); in eval mode it decodes
them, in float32,

    xy = (sigmoid(t_xy) * 2 - 0.5 + grid) * stride
    wh = (sigmoid(t_wh) * 2) ** 2 * anchor_pixels

Candidates are emitted in the JAX package's (ny, nx, na) order per level
(the reference uses (na, ny, nx)), so that top-k and NMS ties agree index
for index.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn


def default_strides(nl: int) -> Tuple[int, ...]:
    """P3..P{3+nl-1} strides: 8, 16, 32, ..."""
    return tuple(8 * (2 ** i) for i in range(nl))


def check_anchor_order(anchors: np.ndarray, strides: Sequence[int]) -> np.ndarray:
    """Flip the anchor levels if their area order disagrees with the stride
    order (reference utils/autoanchor.py:12-19). anchors: (nl, na, 2)."""
    a = anchors.reshape(len(strides), -1, 2)
    da = a.prod(-1).mean(-1)[-1] - a.prod(-1).mean(-1)[0]
    if np.sign(da) != np.sign(strides[-1] - strides[0]):
        a = a[::-1]
    return a


class Detect(nn.Module):
    """YOLOv5 detection head; the level convs are named m0, m1, ... as in
    flax."""

    def __init__(self, nc: int, anchors: Sequence[Sequence[float]],
                 ch: Sequence[int]):
        super().__init__()
        self.nc, self.nl = nc, len(anchors)
        self.na, self.no = len(anchors[0]) // 2, nc + 5
        self.strides = default_strides(self.nl)
        a = np.asarray(anchors, np.float32).reshape(self.nl, self.na, 2)
        # (nl, na, 2) pixel anchors; not in the state dict, and kept float32
        # by ICAFusionModel.cast, which casts parameters only
        self.register_buffer("anchors_px", torch.from_numpy(
            check_anchor_order(a, self.strides).copy()), persistent=False)
        for i, c in enumerate(ch):
            self.add_module(f"m{i}", nn.Conv2d(c, self.no * self.na, 1))

    def forward(self, xs: List[torch.Tensor]):
        """Eval mode: decoded predictions (B, sum ny*nx*na, 5 + nc), float32:
        xywh in input pixels, objectness, class scores. Train mode: the raw
        maps per level, (B, ny, nx, na, 5 + nc) in the activation dtype."""
        if self.training:
            raw = []
            for i, x in enumerate(xs):
                t = getattr(self, f"m{i}")(x)
                b, _, ny, nx = t.shape
                raw.append(t.reshape(b, self.na, self.no, ny, nx)
                           .permute(0, 3, 4, 1, 2))
            return raw
        z = []
        for i, x in enumerate(xs):
            t = getattr(self, f"m{i}")(x)
            b, _, ny, nx = t.shape
            y = (t.float().view(b, self.na, self.no, ny, nx)
                 .permute(0, 3, 4, 1, 2).sigmoid())        # (b, ny, nx, na, no)
            gy, gx = torch.meshgrid(
                torch.arange(ny, device=t.device, dtype=torch.float32),
                torch.arange(nx, device=t.device, dtype=torch.float32),
                indexing="ij")
            grid = torch.stack([gx, gy], dim=-1)[:, :, None, :]
            anc = self.anchors_px[i]
            xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * float(self.strides[i])
            wh = (y[..., 2:4] * 2.0) ** 2 * anc
            out = torch.cat([xy, wh, y[..., 4:]], dim=-1)
            z.append(out.reshape(b, ny * nx * self.na, self.no))
        return torch.cat(z, dim=1)
