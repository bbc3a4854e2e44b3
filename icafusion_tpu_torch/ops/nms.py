"""Fixed-shape batched NMS (reference utils/general.py:518-607).

Counterpart of the JAX package's ops/nms.py: obj gate -> conf = obj * cls
-> best class or multi-label expansion -> the top ``top_k`` candidates by
score -> xywh -> xyxy plus a per-class offset -> greedy suppression
(kernels/nms.py) -> at most ``max_det`` rows per image, padded, with a
validity mask.

The top-k is a stable descending sort, which breaks ties toward the lower
index as ``lax.top_k`` does; ``torch.topk`` makes no such promise.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from icafusion_tpu_torch.kernels.nms import greedy_nms
from icafusion_tpu_torch.ops.boxes import xywh2xyxy

MAX_WH = 4096.0   # class offset, the reference's max_wh (general.py:530)


class Detections(NamedTuple):
    """(B, max_det, ...) padded NMS output; ``valid`` marks real rows."""
    boxes: torch.Tensor    # (B, max_det, 4) xyxy
    scores: torch.Tensor   # (B, max_det)
    classes: torch.Tensor  # (B, max_det) int32
    valid: torch.Tensor    # (B, max_det) bool


def _top_k(x: torch.Tensor, k: int):
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for every image b; x is (B, K) or (B, K, C)."""
    idx = idx.long()
    if x.dim() == 3:
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
    return torch.gather(x, 1, idx)


def non_max_suppression(prediction: torch.Tensor, conf_thres: float = 0.25,
                        iou_thres: float = 0.45, multi_label: bool = False,
                        agnostic: bool = False, max_det: int = 300,
                        top_k: int = 4096,
                        classes: Optional[Sequence[int]] = None) -> Detections:
    """Batched NMS over decoded predictions (B, N, 5 + nc): xywh, obj, cls.

    ``classes`` keeps only those class ids; in best-class mode the filter
    applies after the argmax, so a row whose best class is excluded is
    dropped, as the reference's row filter drops it. Merge-NMS is not
    ported."""
    b, n, no = prediction.shape
    nc = no - 5
    multi_label = multi_label and nc > 1
    x = prediction.float()
    obj, cls = x[..., 4], x[..., 5:]
    gate = obj > conf_thres
    conf = cls * obj[..., None]
    boxes = xywh2xyxy(x[..., :4])
    allowed = None
    if classes is not None:
        allowed = torch.zeros(nc, dtype=torch.bool, device=x.device)
        allowed[list(classes)] = True

    if multi_label:
        scores_all = torch.where((conf > conf_thres) & gate[..., None],
                                 conf, 0.0)
        if allowed is not None:
            scores_all = torch.where(allowed, scores_all, 0.0)
        s, fi = _top_k(scores_all.reshape(b, -1), min(top_k, n * nc))
        bi = fi // nc
        ci = (fi % nc).float()
    else:
        best = conf.amax(dim=-1)
        ci_all = conf.argmax(dim=-1)
        scores_all = torch.where((best > conf_thres) & gate, best, 0.0)
        if allowed is not None:
            scores_all = torch.where(allowed[ci_all], scores_all, 0.0)
        s, bi = _top_k(scores_all, min(top_k, n))
        ci = _take(ci_all.float(), bi)

    cand_boxes = _take(boxes, bi)
    boxes_off = cand_boxes if agnostic else cand_boxes + ci[..., None] * MAX_WH
    s = torch.where(s > 0, s, -1.0)           # padding is never selected
    keep, ok = greedy_nms(boxes_off.contiguous(), s.contiguous(), iou_thres,
                          max_det)
    return Detections(_take(cand_boxes, keep), _take(s, keep).clamp(min=0.0),
                      _take(ci, keep).to(torch.int32), ok)


def detections_to_numpy(dets: Detections) -> List[np.ndarray]:
    """Per image, the valid rows as a (k, 6) float32 array
    [x1, y1, x2, y2, conf, cls] (reference general.py:523)."""
    boxes, scores, classes, valid = (t.cpu().numpy() for t in dets)
    return [np.concatenate([boxes[i][valid[i]], scores[i][valid[i]][:, None],
                            classes[i][valid[i]][:, None].astype(np.float32)],
                           axis=1)
            for i in range(boxes.shape[0])]
