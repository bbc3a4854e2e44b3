"""Fixed-shape batched NMS (reference utils/general.py:518-607).

Counterpart of the JAX package's ops/nms.py: obj gate -> conf = obj * cls
-> best class or multi-label expansion -> the top ``top_k`` candidates by
score -> xywh -> xyxy plus a per-class offset -> greedy suppression
(kernels/nms.py) -> at most ``max_det`` rows per image, padded, with a
validity mask; optionally the reference's merge-NMS on the kept rows.
``batched_nms`` is the lower-level entry over given boxes, scores and
classes, and ``detections_to_records`` the host's per-image records.

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


def _iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes (B, M, 4) x (B, K, 4) -> (B, M, K), in
    the JAX package's order of operations (ops/nms.py:_iou_matrix)."""
    lt = torch.maximum(a[:, :, None, :2], b[:, None, :, :2])
    rb = torch.minimum(a[:, :, None, 2:4], b[:, None, :, 2:4])
    inter = (rb - lt).clamp(min=0.0).prod(-1)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a[:, :, None] + area_b[:, None, :] - inter + 1e-12)


def non_max_suppression(prediction: torch.Tensor, conf_thres: float = 0.25,
                        iou_thres: float = 0.45, multi_label: bool = False,
                        agnostic: bool = False, max_det: int = 300,
                        top_k: int = 4096, merge: bool = False,
                        classes: Optional[Sequence[int]] = None) -> Detections:
    """Batched NMS over decoded predictions (B, N, 5 + nc): xywh, obj, cls.

    ``classes`` keeps only those class ids; in best-class mode the filter
    applies after the argmax, so a row whose best class is excluded is
    dropped, as the reference's row filter drops it.

    ``merge=True`` is the reference's merge-NMS (general.py:594-600): each
    kept box becomes the confidence-weighted mean of every candidate that
    overlaps it at IoU > iou_thres in class-offset space, and a keep that
    overlaps only itself is dropped. The keeps still come from the
    greedy_nms kernel; the merge is a batched product."""
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
    out_boxes = _take(cand_boxes, keep)
    if merge:
        live = s > 0.0                                      # not padding
        iou = (_iou_matrix(_take(boxes_off, keep), boxes_off) > iou_thres) \
            & live[:, None, :]
        w = iou * s.clamp(min=0.0)[:, None, :]
        merged = (w @ cand_boxes) / w.sum(2, keepdim=True).clamp(min=1e-12)
        redundant = iou.sum(2) > 1                          # general.py:599
        out_boxes = torch.where(redundant[..., None], merged, out_boxes)
        ok = ok & redundant
    return Detections(out_boxes, _take(s, keep).clamp(min=0.0),
                      _take(ci, keep).to(torch.int32), ok)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, iou_thres: float = 0.45,
                max_det: int = 300, agnostic: bool = False):
    """The lower-level entry of the JAX package's ops/nms.py: xyxy boxes
    (K, 4), scores (K,) and integer classes (K,) of one image; scores <= 0
    are padding. Returns (keep (max_det,) int64 indices into K, ok
    (max_det,) bool); a slot that keeps nothing holds index 0, as JAX's
    argmax over an all-suppressed pool gives.

    The greedy_nms kernel needs its scores in descending order, so the
    candidates are sorted first (stable: ties keep the lower index first,
    as the argmax loop picks them) and the keeps mapped back."""
    boxes = boxes.float()
    off = 0.0 if agnostic else classes.to(boxes.dtype)[:, None] * MAX_WH
    s = torch.where(scores > 0, scores.float(), -1.0)
    s, order = torch.sort(s, descending=True, stable=True)
    keep, ok = greedy_nms((boxes + off)[order][None].contiguous(),
                          s[None].contiguous(), iou_thres, max_det)
    keep, ok = keep[0], ok[0]
    return torch.where(ok, order[keep.long()], 0), ok


def detections_to_numpy(dets: Detections) -> List[np.ndarray]:
    """Per image, the valid rows as a (k, 6) float32 array
    [x1, y1, x2, y2, conf, cls] (reference general.py:523)."""
    boxes, scores, classes, valid = (t.cpu().numpy() for t in dets)
    return [np.concatenate([boxes[i][valid[i]], scores[i][valid[i]][:, None],
                            classes[i][valid[i]][:, None].astype(np.float32)],
                           axis=1)
            for i in range(boxes.shape[0])]


def records(arr: np.ndarray, names=None) -> List[dict]:
    """(k, 6) detections of one image -> dicts with xmin/ymin/xmax/ymax/
    confidence/class/name: the reference's Detections.pandas() records
    (common.py:534-543); a class without a name in ``names`` is named by
    its id."""
    return [{"xmin": float(x1), "ymin": float(y1), "xmax": float(x2),
             "ymax": float(y2), "confidence": float(conf), "class": int(cls),
             "name": (names[int(cls)] if names and int(cls) < len(names)
                      else str(int(cls)))}
            for x1, y1, x2, y2, conf, cls in arr]


def detections_to_records(dets: Detections, names=None) -> List[list]:
    """Per image, its records (``records``)."""
    return [records(arr, names) for arr in detections_to_numpy(dets)]
