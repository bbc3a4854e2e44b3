"""Test-time augmentation: multi-scale and flipped inference.

Counterpart of the JAX package's models/tta.py (reference
Model.forward(augment=True), yolo_test.py:115-131, and scale_img,
torch_utils.py:237-251): scales (1, 0.83, 0.67) with flips (none,
left-right, none); each variant's decoded boxes are de-scaled and
de-flipped to the input frame, and the three are concatenated before NMS.

The resize is nn/fusion.resize_linear, which reproduces jax.image.resize
"linear", antialiasing included when it shrinks (F.interpolate does not
antialias). Scaled inputs are padded with 0.447 at the bottom and right to
multiples of the grid stride.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from icafusion_tpu_torch.nn.fusion import resize_linear

TTA_SCALES = (1.0, 0.83, 0.67)
TTA_FLIPS = (None, 3, None)   # 3: left-right (yolo_test.py:119)


def scale_img(img: torch.Tensor, ratio: float, gs: int = 32,
              pad_val: float = 0.447) -> torch.Tensor:
    """Resize img (B, C, H, W) to int(H * ratio) x int(W * ratio), then pad
    the bottom and right with pad_val up to multiples of gs."""
    if ratio == 1.0:
        return img
    h, w = img.shape[-2:]
    nh, nw = int(h * ratio), int(w * ratio)
    img = resize_linear(img, nh, nw)
    ph, pw = -(-nh // gs) * gs, -(-nw // gs) * gs
    return F.pad(img, (0, pw - nw, 0, ph - nh), value=pad_val)


def tta_inference(model, rgb: torch.Tensor, ir: torch.Tensor, gs: int = 32,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Decoded predictions (B, sum N, 5 + nc) of the TTA ensemble
    (yolo_test.py:116-131). rgb, ir: (B, 3, H, W) float images in [0, 1];
    each variant is scaled in their dtype, then cast to dtype (default
    theirs) for the model."""
    h, w = rgb.shape[-2:]
    outs = []
    for si, fi in zip(TTA_SCALES, TTA_FLIPS):
        xr, xi = rgb, ir
        if fi == 3:
            xr, xi = xr.flip(-1), xi.flip(-1)
        elif fi == 2:
            xr, xi = xr.flip(-2), xi.flip(-2)
        xr, xi = (scale_img(t, si, gs).to(dtype or t.dtype).contiguous(
            memory_format=torch.channels_last) for t in (xr, xi))
        pred = model(xr, xi)
        xy = pred[..., :2] / si
        wh = pred[..., 2:4] / si
        if fi == 2:
            xy = torch.stack([xy[..., 0], h - xy[..., 1]], -1)
        elif fi == 3:
            xy = torch.stack([w - xy[..., 0], xy[..., 1]], -1)
        outs.append(torch.cat([xy, wh, pred[..., 4:]], -1))
    return torch.cat(outs, 1)
