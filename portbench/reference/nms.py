"""Plain batched NMS of decoded predictions, the published YOLOv5 rule
(utils/general.py non_max_suppression, best class per box):

obj > conf, conf = cls * obj, best class above conf -> the top ``top_k``
candidates by score (stable descending sort, ties to the lower index) ->
xywh to xyxy plus a class offset of 4096 px -> greedy suppression: pick the
highest live score, drop every live box of IoU > iou_thres with it, at most
``max_det`` picks. IoU = inter / (area_a + area_b - inter + 1e-12), each
operation rounded once. Imports torch alone.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

MAX_WH = 4096.0


def greedy(boxes, scores, iou_thres: float, max_det: int):
    """(B, K, 4) xyxy, (B, K) scores (padding -1) -> keep (B, max_det)
    indices and ok (B, max_det): the argmax loop."""
    B = boxes.shape[0]
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    active = scores.clone()
    rows = torch.arange(B, device=boxes.device)
    keep = torch.zeros((B, max_det), dtype=torch.long, device=boxes.device)
    ok = torch.zeros((B, max_det), dtype=torch.bool, device=boxes.device)
    for step in range(max_det):
        i = active.argmax(1)
        s = active[rows, i]
        bx1, by1 = x1[rows, i, None], y1[rows, i, None]
        bx2, by2 = x2[rows, i, None], y2[rows, i, None]
        barea = (bx2 - bx1) * (by2 - by1)
        iw = (torch.minimum(x2, bx2) - torch.maximum(x1, bx1)).clamp(min=0.0)
        ih = (torch.minimum(y2, by2) - torch.maximum(y1, by1)).clamp(min=0.0)
        inter = iw * ih
        iou = inter / (area + barea - inter + 1e-12)
        active = torch.where(iou > iou_thres, -1.0, active)
        active[rows, i] = -1.0
        keep[:, step] = i
        ok[:, step] = s > 0.0
        if not bool((active > 0).any()):
            break
    return keep, ok


@torch.no_grad()
def nms(pred: torch.Tensor, conf_thres: float, iou_thres: float,
        max_det: int, top_k: int) -> List[np.ndarray]:
    """pred (B, N, 5 + nc) float -> per image a (k, 6) float32 array
    [x1, y1, x2, y2, conf, cls] in pick order."""
    x = pred.float()
    b, n, _ = x.shape
    obj, cls = x[..., 4], x[..., 5:]
    conf = cls * obj[..., None]
    best = conf.amax(-1)
    ci_all = conf.argmax(-1)
    scores = torch.where((best > conf_thres) & (obj > conf_thres), best, 0.0)
    s, bi = torch.sort(scores, dim=-1, descending=True, stable=True)
    k = min(top_k, n)
    s, bi = s[:, :k], bi[:, :k]
    cx, cy, w, h = x[..., :4].unbind(-1)
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    cand = torch.gather(boxes, 1, bi[..., None].expand(-1, -1, 4))
    ci = torch.gather(ci_all, 1, bi).float()
    s = torch.where(s > 0, s, -1.0)
    keep, ok = greedy(cand + ci[..., None] * MAX_WH, s, iou_thres, max_det)
    out = []
    for j in range(b):
        kj = keep[j][ok[j]]
        out.append(torch.cat([cand[j, kj], s[j, kj, None], ci[j, kj, None]],
                             1).cpu().numpy().astype(np.float32))
    return out
