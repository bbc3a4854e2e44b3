"""COCO-style detection evaluation (the AP/AR suite) in numpy.

A copy of the JAX package's eval/cocoeval.py: the counterpart of the
reference's pycocotools COCOeval run at test.py:329-352 (COCOeval(anno,
pred, 'bbox'): evaluate, accumulate, summarize, stats[:2]), with the
matching and accumulation of a stock pycocotools bbox evaluation:

- the IoU matrix is one broadcast expression, crowd semantics included;
- greedy matching keeps the per-detection loop; the choice of ground truth
  inside it is a masked argmax (prefer non-ignored, let crowds match again,
  ties to the later ground truth) in two masked passes;
- the PR interpolation is a reversed cumulative max.

Inputs are plain COCO-format dicts. ``evaluate_files`` reads a ground-truth
annotations json and the detections json that eval/evaluator.py writes.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
MAX_DETS = (1, 10, 100)
AREA_RNG = {"all": (0.0, 1e10), "small": (0.0, 32.0 ** 2),
            "medium": (32.0 ** 2, 96.0 ** 2), "large": (96.0 ** 2, 1e10)}


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    """IoU matrix (D, G) for xywh boxes; for crowd gts the denominator is the
    detection's own area (pycocotools maskUtils.iou bbox semantics)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    d = dt[:, None, :]
    g = gt[None, :, :]
    iw = np.minimum(d[..., 0] + d[..., 2], g[..., 0] + g[..., 2]) - \
        np.maximum(d[..., 0], g[..., 0])
    ih = np.minimum(d[..., 1] + d[..., 3], g[..., 1] + g[..., 3]) - \
        np.maximum(d[..., 1], g[..., 1])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    da = (d[..., 2] * d[..., 3])
    ga = (g[..., 2] * g[..., 3])
    union = np.where(crowd[None, :].astype(bool), da, da + ga - inter)
    return inter / np.maximum(union, 1e-12)


def _last_argmax(values: np.ndarray, idx: np.ndarray) -> int:
    """Index (into `idx`) of the maximum, later entries winning ties — the
    reference's `if ious < iou: continue` keeps replacing on >=."""
    v = values[idx]
    return int(idx[len(v) - 1 - int(np.argmax(v[::-1]))])


class CocoDetEval:
    """Bbox AP/AR evaluation over COCO-format gt/dt dicts.

    gt: {"images": [{"id", ...}], "annotations": [{"image_id", "category_id",
    "bbox" xywh, "area"?, "iscrowd"?, "ignore"?}], "categories": [{"id", ...}]}
    dt: [{"image_id", "category_id", "bbox" xywh, "score"}]
    """

    def __init__(self, gt: dict, dt: Sequence[dict],
                 img_ids: Optional[Sequence] = None):
        self.cat_ids = [c["id"] for c in gt.get("categories", [])]
        if not self.cat_ids:
            self.cat_ids = sorted({a["category_id"] for a in gt["annotations"]})
        all_imgs = [im["id"] for im in gt.get("images", [])] or \
            sorted({a["image_id"] for a in gt["annotations"]})
        self.img_ids = list(img_ids) if img_ids is not None else all_imgs
        self._gts: Dict[tuple, list] = defaultdict(list)
        self._dts: Dict[tuple, list] = defaultdict(list)
        for a in gt["annotations"]:
            bb = a["bbox"]
            self._gts[(a["image_id"], a["category_id"])].append({
                "bbox": np.asarray(bb, np.float64),
                "area": float(a.get("area", bb[2] * bb[3])),
                "crowd": int(a.get("iscrowd", 0)),
                # pycocotools' bbox path overwrites any 'ignore' field with
                # iscrowd (cocoeval.py:107-109 in the vendored fork == stock);
                # reproduced exactly for oracle parity
                "ignore": int(a.get("iscrowd", 0)),
            })
        for a in dt:
            bb = a["bbox"]
            self._dts[(a["image_id"], a["category_id"])].append({
                "bbox": np.asarray(bb, np.float64),
                "area": float(bb[2] * bb[3]),
                "score": float(a["score"]),
            })
        self.eval: Optional[dict] = None

    # -- per-(image, category) matching ------------------------------------
    def _match_one(self, gts: list, dts: list, area_rng) -> Optional[dict]:
        if not gts and not dts:
            return None
        lo, hi = area_rng
        g_ign = np.array([g["ignore"] or not (lo <= g["area"] <= hi)
                          for g in gts], bool)
        # gts sorted ignore-last, dts by descending score (stable)
        g_ord = np.argsort(g_ign, kind="stable")
        scores = np.array([d["score"] for d in dts])
        d_ord = np.argsort(-scores, kind="mergesort")[:MAX_DETS[-1]]
        g_ign = g_ign[g_ord]
        crowd = np.array([gts[i]["crowd"] for i in g_ord], int)
        ious = bbox_iou_xywh(
            np.array([dts[i]["bbox"] for i in d_ord]).reshape(-1, 4),
            np.array([gts[i]["bbox"] for i in g_ord]).reshape(-1, 4), crowd)

        T, G, D = len(IOU_THRS), len(gts), len(d_ord)
        gt_taken = np.zeros((T, G), bool)
        dt_match = np.zeros((T, D), bool)
        dt_ign = np.zeros((T, D), bool)
        for t, thr in enumerate(IOU_THRS):
            thr = min(thr, 1.0 - 1e-10)
            for di in range(D):
                free = ~gt_taken[t] | crowd.astype(bool)
                ok = free & (ious[di] >= thr)
                # prefer non-ignored gts; fall back to ignored ones
                for mask in (ok & ~g_ign, ok & g_ign):
                    cand = np.nonzero(mask)[0]
                    if cand.size:
                        m = _last_argmax(ious[di], cand)
                        gt_taken[t, m] = True
                        dt_match[t, di] = True
                        dt_ign[t, di] = g_ign[m]
                        break
        # unmatched detections outside the area range are ignored, not FPs
        d_out = np.array([not (lo <= dts[i]["area"] <= hi) for i in d_ord], bool)
        dt_ign |= ~dt_match & d_out[None, :]
        return {"scores": scores[d_ord], "match": dt_match, "dt_ign": dt_ign,
                "n_gt": int((~g_ign).sum())}

    # -- accumulation over images ------------------------------------------
    def accumulate(self) -> dict:
        T, R = len(IOU_THRS), len(REC_THRS)
        K, A, M = len(self.cat_ids), len(AREA_RNG), len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        for k, cat in enumerate(self.cat_ids):
            for a, rng in enumerate(AREA_RNG.values()):
                per_img = [self._match_one(self._gts[(i, cat)],
                                           self._dts[(i, cat)], rng)
                           for i in self.img_ids]
                per_img = [e for e in per_img if e is not None]
                if not per_img:
                    continue
                npig = sum(e["n_gt"] for e in per_img)
                if npig == 0:
                    continue
                for m, max_det in enumerate(MAX_DETS):
                    sc = np.concatenate([e["scores"][:max_det] for e in per_img])
                    order = np.argsort(-sc, kind="mergesort")
                    tp = np.concatenate(
                        [e["match"][:, :max_det] & ~e["dt_ign"][:, :max_det]
                         for e in per_img], axis=1)[:, order]
                    fp = np.concatenate(
                        [~e["match"][:, :max_det] & ~e["dt_ign"][:, :max_det]
                         for e in per_img], axis=1)[:, order]
                    tpc = np.cumsum(tp, axis=1).astype(np.float64)
                    fpc = np.cumsum(fp, axis=1).astype(np.float64)
                    rc = tpc / npig
                    pr = tpc / np.maximum(tpc + fpc, np.spacing(1))
                    recall[:, k, a, m] = rc[:, -1] if rc.shape[1] else 0.0
                    # make precision monotone (reversed cummax), then sample
                    # at the 101 recall points
                    pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
                    for t in range(T):
                        q = np.zeros(R)
                        idx = np.searchsorted(rc[t], REC_THRS, side="left")
                        valid = idx < pr.shape[1]
                        q[valid] = pr[t, idx[valid]]
                        precision[t, :, k, a, m] = q
        self.eval = {"precision": precision, "recall": recall}
        return self.eval

    # -- summary -------------------------------------------------------------
    def _sel(self, ap: bool, iou=None, area="all", max_det=100) -> float:
        e = self.eval if self.eval is not None else self.accumulate()
        a = list(AREA_RNG).index(area)
        m = MAX_DETS.index(max_det)
        s = e["precision"][..., a, m] if ap else e["recall"][..., a, m]
        if iou is not None:
            s = s[np.abs(IOU_THRS - iou) < 1e-6]
        s = s[s > -1]
        return float(s.mean()) if s.size else -1.0

    def summarize(self, verbose: bool = True) -> np.ndarray:
        """The standard 12-element stats vector, printed like pycocotools."""
        spec = [(1, None, "all", 100), (1, .5, "all", 100), (1, .75, "all", 100),
                (1, None, "small", 100), (1, None, "medium", 100),
                (1, None, "large", 100),
                (0, None, "all", 1), (0, None, "all", 10), (0, None, "all", 100),
                (0, None, "small", 100), (0, None, "medium", 100),
                (0, None, "large", 100)]
        stats = np.array([self._sel(bool(ap), iou, ar, md)
                          for ap, iou, ar, md in spec])
        if verbose:
            for (ap, iou, ar, md), v in zip(spec, stats):
                t = "Average Precision" if ap else "Average Recall   "
                ty = "(AP)" if ap else "(AR)"
                io = "0.50:0.95" if iou is None else f"{iou:0.2f}     "
                print(f" {t} {ty} @[ IoU={io} | area={ar:>6s} | "
                      f"maxDets={md:>3d} ] = {v:0.3f}")
        return stats


def evaluate_files(gt_json: str, dt_json: str, verbose: bool = True):
    """Run the AP/AR suite on a GT annotations json + a detections json (the
    file eval/evaluator.py writes for --save-json). Returns (stats, eval)."""
    with open(gt_json) as f:
        gt = json.load(f)
    with open(dt_json) as f:
        dt = json.load(f)
    ev = CocoDetEval(gt, dt)
    ev.accumulate()
    stats = ev.summarize(verbose=verbose)
    return stats, ev.eval
