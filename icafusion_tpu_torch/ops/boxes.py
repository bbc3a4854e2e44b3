"""Box geometry (reference utils/general.py:332-340 xywh2xyxy, :386-407
scale_coords, :455-477 box_iou)."""

from __future__ import annotations

import numpy as np
import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2) along the last dim."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def box_iou(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes, (N, 4) x (M, 4) -> (N, M)."""
    area1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    lt = torch.maximum(box1[:, None, :2], box2[None, :, :2])
    rb = torch.minimum(box1[:, None, 2:4], box2[None, :, 2:4])
    inter = (rb - lt).clamp(min=0).prod(-1)
    return inter / (area1[:, None] + area2[None, :] - inter)


def scale_coords_np(img_hw, coords: np.ndarray, img0_hw,
                    ratio_pad=None) -> np.ndarray:
    """Rescale xyxy boxes from the letterboxed canvas img_hw back to the
    native image img0_hw and clip them to it (host side, numpy)."""
    if ratio_pad is None:
        gain = min(img_hw[0] / img0_hw[0], img_hw[1] / img0_hw[1])
        pad = ((img_hw[1] - img0_hw[1] * gain) / 2,
               (img_hw[0] - img0_hw[0] * gain) / 2)
    else:
        gain, pad = ratio_pad[0][0], ratio_pad[1]
    coords = coords.copy()
    coords[:, [0, 2]] -= pad[0]
    coords[:, [1, 3]] -= pad[1]
    coords[:, :4] /= gain
    coords[:, [0, 2]] = coords[:, [0, 2]].clip(0, img0_hw[1])
    coords[:, [1, 3]] = coords[:, [1, 3]].clip(0, img0_hw[0])
    return coords
