"""Box geometry (reference utils/general.py:322-340 xyxy2xywh and
xywh2xyxy, :386-407 scale_coords and clip_coords, :410-452 bbox_iou,
:455-477 box_iou, :480-485 wh_iou)."""

from __future__ import annotations

import math

import numpy as np
import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2) along the last dim."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h) along the last dim."""
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def clip_coords(boxes: torch.Tensor, img_hw) -> torch.Tensor:
    """xyxy boxes clipped to an (h, w) image, as a new tensor."""
    h, w = img_hw
    x1, y1, x2, y2 = boxes[..., :4].unbind(-1)
    return torch.stack([x1.clamp(0, w), y1.clamp(0, h), x2.clamp(0, w),
                        y2.clamp(0, h)], -1)


def scale_coords(img1_hw, coords: torch.Tensor, img0_hw,
                 ratio_pad=None) -> torch.Tensor:
    """xyxy boxes from the letterboxed canvas img1_hw back to the native
    image img0_hw, clipped to it; ratio_pad = (gain, (pad_w, pad_h)) as
    the JAX package takes it (the first four columns of ``coords``)."""
    if ratio_pad is None:
        gain = min(img1_hw[0] / img0_hw[0], img1_hw[1] / img0_hw[1])
        pad = ((img1_hw[1] - img0_hw[1] * gain) / 2,
               (img1_hw[0] - img0_hw[0] * gain) / 2)
    else:
        gain, pad = ratio_pad[0], ratio_pad[1]
    xy = coords[..., :4] - torch.tensor([pad[0], pad[1], pad[0], pad[1]],
                                        dtype=coords.dtype,
                                        device=coords.device)
    return clip_coords(xy / gain, img0_hw)


def wh_iou(wh1: torch.Tensor, wh2: torch.Tensor) -> torch.Tensor:
    """(N, 2) x (M, 2) -> (N, M) IoU of boxes given by width and height
    alone."""
    inter = torch.minimum(wh1[:, None, :], wh2[None, :, :]).prod(-1)
    return inter / (wh1.prod(-1)[:, None] + wh2.prod(-1)[None, :] - inter)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, x1y1x2y2: bool = True,
             GIoU: bool = False, DIoU: bool = False, CIoU: bool = False,
             eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU of broadcast-compatible boxes (last dim 4), with the
    reference's asymmetric eps on the heights; CIoU's alpha carries no
    gradient (the JAX package's ops/boxes.py:54-107)."""
    if x1y1x2y2:
        b1_x1, b1_y1, b1_x2, b1_y2 = box1.unbind(-1)
        b2_x1, b2_y1, b2_x2, b2_y2 = box2.unbind(-1)
    else:
        b1_x1, b1_x2 = box1[..., 0] - box1[..., 2] / 2, box1[..., 0] + box1[..., 2] / 2
        b1_y1, b1_y2 = box1[..., 1] - box1[..., 3] / 2, box1[..., 1] + box1[..., 3] / 2
        b2_x1, b2_x2 = box2[..., 0] - box2[..., 2] / 2, box2[..., 0] + box2[..., 2] / 2
        b2_y1, b2_y2 = box2[..., 1] - box2[..., 3] / 2, box2[..., 1] + box2[..., 3] / 2

    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0)
             * (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0))
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not (GIoU or DIoU or CIoU):
        return iou
    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    if CIoU or DIoU:
        c2 = cw ** 2 + ch ** 2 + eps
        rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2
                + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
        if DIoU:
            return iou - rho2 / c2
        v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
        with torch.no_grad():
            alpha = v / (v - iou + (1 + eps))
        return iou - (rho2 / c2 + v * alpha)
    c_area = cw * ch + eps
    return iou - (c_area - union) / c_area


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
