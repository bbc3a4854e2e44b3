"""Detection metrics (host-side numpy): PR curves, AP, confusion matrix, fitness.

A copy of the JAX package's eval/metrics.py, names kept, without the curve
plots.

Behavioral counterpart of reference utils/metrics.py:12-185:
- ap_per_class: per-class PR curves sampled on a 1000-point confidence grid,
  101-point COCO interpolation for AP, TP/FP/FN/F1 at the max-F1 threshold
- compute_ap: sentinel-padded precision envelope + interp integration
- fitness: model-selection scalar = mAP@0.5 (weight vector metrics.py:12-15)
- ConfusionMatrix: IoU-matched confusion incl. background row/col
"""

from __future__ import annotations

import numpy as np


def fitness(metrics_row: np.ndarray) -> float:
    """Scalar used for best-checkpoint selection == mAP@0.5
    (metrics.py:12-15: weights [0,0,0,0,0,0,1,0] over
    [tp, fp, fn, f1, mp, mr, map50, map])."""
    w = np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0])
    return float((np.asarray(metrics_row)[:8] * w).sum())


# sampling grids: confidence axis for P/R/F1, recall axis for AP integration
CONF_GRID = np.linspace(0, 1, 1000)
RECALL_GRID = np.linspace(0, 1, 101)   # 101-point COCO interpolation


def _pad_envelope(recall, precision):
    """Sentinel-pad the PR steps and make precision monotone non-increasing
    (the precision envelope), vectorized over the trailing IoU axis.
    recall/precision: (n, k) -> padded (n+2, k)."""
    k = recall.shape[1]
    rec = np.vstack([np.zeros((1, k)), recall, recall[-1:] + 0.01])
    pre = np.vstack([np.ones((1, k)), precision, np.zeros((1, k))])
    pre = np.maximum.accumulate(pre[::-1], axis=0)[::-1]
    return rec, pre


def compute_ap(recall, precision):
    """AP of one PR curve via the 101-point interpolated envelope
    (metrics.py:85-110). Returns (ap, envelope precision, padded recall)."""
    rec, pre = _pad_envelope(np.asarray(recall)[:, None],
                             np.asarray(precision)[:, None])
    ap = np.trapezoid(np.interp(RECALL_GRID, rec[:, 0], pre[:, 0]), RECALL_GRID)
    return ap, pre[:, 0], rec[:, 0]


def ap_per_class(tp, conf, pred_cls, target_cls):
    """Per-class AP over the IoU grid; same outputs as reference metrics.py:18-82.

    tp: (n, niou) bool; conf, pred_cls: (n,); target_cls: (m,).
    Returns (tp_count, fp_count, fn_count, p, r, ap, f1, unique_classes) where
    p/r/f1 are at the max-mean-F1 confidence threshold and ap is (nc, niou).
    The curves are not plotted."""
    tp, conf = np.asarray(tp), np.asarray(conf)
    pred_cls, target_cls = np.asarray(pred_cls), np.asarray(target_cls)
    niou = tp.shape[1] if tp.ndim == 2 else 1

    # one global sort by confidence; per-class curves are cumulative slices
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    classes, gt_counts = np.unique(target_cls, return_counts=True)

    ap = np.zeros((len(classes), niou))
    p_curve = np.zeros((len(classes), CONF_GRID.size))
    r_curve = np.zeros((len(classes), CONF_GRID.size))
    for ci, (c, n_gt) in enumerate(zip(classes, gt_counts)):
        sel = pred_cls == c
        if n_gt == 0 or not sel.any():
            continue
        hits = tp[sel].cumsum(0).astype(np.float64)       # (n_c, niou)
        found = np.arange(1, len(hits) + 1)[:, None]      # hits + misses
        recall = hits / (n_gt + 1e-16)
        precision = hits / found
        # sample P/R onto the descending-confidence grid (interp wants
        # ascending x, hence the negated axes)
        r_curve[ci] = np.interp(-CONF_GRID, -conf[sel], recall[:, 0], left=0)
        p_curve[ci] = np.interp(-CONF_GRID, -conf[sel], precision[:, 0], left=1)
        rec_pad, pre_env = _pad_envelope(recall, precision)
        for j in range(niou):
            ap[ci, j] = np.trapezoid(
                np.interp(RECALL_GRID, rec_pad[:, j], pre_env[:, j]), RECALL_GRID)

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + 1e-16)
    best = f1_curve.mean(0).argmax()                      # max mean-F1 threshold
    # count reconstruction reuses the LAST class's gt count, a reference quirk
    # (metrics.py:78-80) that only matters for nc==1 where the counts are printed
    n_last = gt_counts[-1] if len(gt_counts) else 0
    tp_cnt = (r_curve * n_last).round()
    fn_cnt = n_last - tp_cnt
    fp_cnt = (tp_cnt / (p_curve + 1e-16) - tp_cnt).round()

    return (tp_cnt[:, best], fp_cnt[:, best], fn_cnt[:, best], p_curve[:, best],
            r_curve[:, best], ap, f1_curve[:, best], classes.astype(np.int32))


def summarize(stats, nc: int):
    """Aggregate per-image stats -> dict of headline metrics (test.py:288-312).

    stats: list of (correct (n,niou) bool, conf (n,), pred_cls (n,), tcls list)."""
    out = dict(mp=0.0, mr=0.0, map50=0.0, map75=0.0, map=0.0,
               tp=0.0, fp=0.0, fn=0.0, f1=0.0,
               per_class={}, nt=np.zeros(nc, np.int64))
    if not stats:
        return out
    arrs = [np.concatenate([np.asarray(s[k]) for s in stats], 0) for k in range(3)]
    tcls = np.concatenate([np.asarray(s[3]) for s in stats], 0) if stats else np.array([])
    if not len(arrs[0]):
        return out
    tp_c, fp_c, fn_c, p, r, ap, f1, classes = ap_per_class(
        arrs[0], arrs[1], arrs[2], tcls)
    ap50, ap75, ap_mean = ap[:, 0], ap[:, 5], ap.mean(1)
    out.update(mp=float(p.mean()), mr=float(r.mean()), map50=float(ap50.mean()),
               map75=float(ap75.mean()), map=float(ap_mean.mean()))
    if len(tp_c):
        # the reference's results tuple carries the FIRST class's counts/F1 at
        # the max-F1 threshold (test.py:363-367: tp[0], fp[0], fn[0], f1[0])
        out.update(tp=float(tp_c[0]), fp=float(fp_c[0]), fn=float(fn_c[0]),
                   f1=float(f1[0]))
    for k, c in enumerate(classes):
        out["per_class"][int(c)] = dict(p=float(p[k]), r=float(r[k]),
                                        ap50=float(ap50[k]), ap=float(ap_mean[k]))
    if len(tcls):
        nt = np.bincount(tcls.astype(np.int64), minlength=nc)
        out["nt"] = nt
    return out


class ConfusionMatrix:
    """IoU-matched confusion with background FP/FN row/col (metrics.py:113-185)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1), np.int64)
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections: np.ndarray, labels: np.ndarray):
        """detections (N,6) xyxy+conf+cls; labels (M,5) cls+xyxy.

        Matching is a two-round election, equivalent to the reference's
        dedup of the candidate-pair list (metrics.py:138-147) but computed
        by per-axis argmax + scatter-max instead of sort/unique passes:
        every detection above the IoU threshold first elects its best label,
        then each label keeps the best of its electors. Exact-tie IoUs break
        toward the HIGHEST index both rounds (the reference's
        argsort()[::-1] reverses a stable ascending sort, so tied pairs land
        in descending original order). One quirk preserved: when NO pair
        clears the threshold, unmatched detections are not counted into the
        background column (reference guards that loop on n>0)."""
        det = detections[detections[:, 4] > self.conf]
        gt_cls = labels[:, 0].astype(int)
        det_cls = det[:, 5].astype(int)
        m, n = len(labels), len(det)
        chosen = np.full(m, -1, np.int64)   # winning detection per label
        if m and n:
            lt = np.maximum(labels[:, None, 1:3], det[None, :, 0:2])
            rb = np.minimum(labels[:, None, 3:5], det[None, :, 2:4])
            inter = np.clip(rb - lt, 0, None).prod(-1)
            a1 = (labels[:, 3] - labels[:, 1]) * (labels[:, 4] - labels[:, 2])
            a2 = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
            iou = inter / (a1[:, None] + a2[None, :] - inter + 1e-16)
            elected = m - 1 - iou[::-1].argmax(0)         # best label per det
            d_iou = iou[elected, np.arange(n)]
            live = d_iou > self.iou_thres
            if live.any():
                d_idx = np.nonzero(live)[0]
                g_idx = elected[d_idx]
                best = np.zeros(m)
                np.maximum.at(best, g_idx, d_iou[d_idx])  # best elector per label
                winner = d_iou[d_idx] == best[g_idx]
                np.maximum.at(chosen, g_idx[winner], d_idx[winner])
        matched = chosen >= 0
        row = np.full(m, self.nc, np.int64)
        row[matched] = det_cls[chosen[matched]]
        np.add.at(self.matrix, (row, gt_cls), 1)
        if matched.any():
            taken = np.zeros(n, bool)
            taken[chosen[matched]] = True
            np.add.at(self.matrix, (det_cls[~taken],
                                    np.full(int((~taken).sum()), self.nc)), 1)
