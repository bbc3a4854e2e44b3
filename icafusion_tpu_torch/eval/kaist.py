"""KAIST multispectral pedestrian miss-rate evaluation in numpy.

A copy of the JAX package's eval/kaist.py.

Behavioral counterpart of reference evaluation_script/evaluation_script.py:32-646
(KAISTPedEval, a fork of cocoeval with Caltech-style log-average miss rate), with
no pycocotools dependency. Reproduces, bit-for-bit on the shipped fixtures:

- ignore rules: GT ignored when height/occlusion outside the setup's range or the
  box leaves bndRng [5,5,635,507] (evaluation_script.py:59-71)
- IoU vs ignored GTs uses detection-area union (crowd-style, :148-179)
- greedy matching per descending score: best non-ignored GT above thresh wins;
  matching an ignored GT marks the detection ignored (:226-258)
- accumulation: global mergesort by score, FPPI = FP/nImages, right-monotone
  recall envelope, sampled at 9 FPPI thresholds 1e-2..1 with searchsorted-1
  (including the reference's pi=-1 -> recall[-1] wraparound quirk, :376-386)
- log-average MR = exp(mean(log(mr + 1e-5))) over mr < 2 (:460-465)
- the standard 9-way report: all/day/night (day = first 1455 images), scale
  near/medium/far, occlusion none/partial/heavy (:546-646)

Detections: txt lines "image_idx,x,y,w,h,score" with image_id = idx-1
(txt2json, :502-521), or a COCO-style json list.
"""

from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from pathlib import Path
from typing import List, Sequence

import numpy as np

FPPI_THRS = np.array([0.0100, 0.0178, 0.0316, 0.0562, 0.1000,
                      0.1778, 0.3162, 0.5623, 1.0000])
# setups 0..6: Reasonable, near, medium, far, occ=none, occ=partial, occ=heavy
HT_RNG = [[55, 1e10], [115, 1e10], [45, 115], [1, 45], [1, 1e10], [1, 1e10], [1, 1e10]]
OCC_RNG = [[0, 1], [0], [0], [0], [0], [1], [2]]
SETUP_LBL = ["Reasonable", "scale=near", "scale=medium", "scale=far",
             "occ=none", "occ=partial", "occ=heavy"]
BND_RNG = [5, 5, 635, 507]
IOU_THR = 0.5
MAX_DETS = 1000


def load_kaist_gt(ann_file: str):
    """-> (img_ids sorted, {img_id: list of gt dicts with bbox/height/occlusion/ignore})."""
    d = json.load(open(ann_file))
    img_ids = sorted(im["id"] for im in d["images"])
    gts = defaultdict(list)
    for a in d["annotations"]:
        if a.get("category_id", 1) != 1:
            continue
        gts[a["image_id"]].append(dict(
            id=int(a.get("id", 1)),
            bbox=[float(x) for x in a["bbox"]],
            height=float(a.get("height", a["bbox"][3])),
            occlusion=int(a.get("occlusion", 0)),
            ignore=int(a.get("ignore", 0)),
        ))
    return img_ids, gts


def load_detections(res_file: str):
    """txt ('idx,x,y,w,h,score', image_id = idx-1) or COCO json -> {img_id: (n,5)}."""
    dts = defaultdict(list)
    if str(res_file).endswith(".txt"):
        for line in Path(res_file).read_text().strip().splitlines():
            v = [float(x) for x in line.split(",")]
            dts[int(v[0] - 1)].append([v[1], v[2], v[3], v[4], v[5]])
    else:
        for a in json.load(open(res_file)):
            if int(a.get("category_id", 1)) != 1:
                continue
            b = a["bbox"]
            dts[int(a["image_id"])].append(
                [float(b[0]), float(b[1]), float(b[2]), float(b[3]),
                 float(a["score"])])
    return {k: np.asarray(v, np.float64) for k, v in dts.items()}


def _iou_matrix(dt_boxes: np.ndarray, gt_boxes: np.ndarray,
                gt_ignore: np.ndarray) -> np.ndarray:
    """xywh IoU; ignored GTs use detection-area union (evaluation_script.py:148-179)."""
    if len(dt_boxes) == 0 or len(gt_boxes) == 0:
        return np.zeros((len(dt_boxes), len(gt_boxes)))
    dx1, dy1 = dt_boxes[:, 0], dt_boxes[:, 1]
    dx2, dy2 = dx1 + dt_boxes[:, 2], dy1 + dt_boxes[:, 3]
    darea = dt_boxes[:, 2] * dt_boxes[:, 3]
    gx1, gy1 = gt_boxes[:, 0], gt_boxes[:, 1]
    gx2, gy2 = gx1 + gt_boxes[:, 2], gy1 + gt_boxes[:, 3]
    garea = gt_boxes[:, 2] * gt_boxes[:, 3]
    iw = np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None])
    ih = np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None])
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    union = np.where(gt_ignore[None, :].astype(bool), darea[:, None],
                     darea[:, None] + garea[None, :] - inter)
    return inter / union


def _evaluate_img(gt_list: List[dict], dt: np.ndarray, setup: int):
    """One image of one setup: match detections (sorted by -score) to GTs
    (ignored-last), single IoU threshold (evaluation_script.py:181-294).
    Returns (dt_scores, dt_matched, dt_ignored, gt_ignore) or None."""
    if len(gt_list) == 0 and len(dt) == 0:
        return None
    ht_lo, ht_hi = HT_RNG[setup]
    occ_ok = OCC_RNG[setup]
    gt_ig = []
    gt_boxes = []
    gt_ids = np.asarray([g.get("id", 1) for g in gt_list], np.int64)
    for g in gt_list:
        b = g["bbox"]
        ig = g["ignore"]
        if (g["height"] < ht_lo or g["height"] > ht_hi
                or g["occlusion"] not in occ_ok
                or b[0] < BND_RNG[0] or b[1] < BND_RNG[1]
                or b[0] + b[2] > BND_RNG[2] or b[1] + b[3] > BND_RNG[3]):
            ig = 1
        gt_ig.append(ig)
        gt_boxes.append(b)
    gt_ig = np.asarray(gt_ig, np.int64)
    gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)

    dtind = np.argsort(-dt[:, 4], kind="mergesort") if len(dt) else np.zeros(0, int)
    dt = dt[dtind[:MAX_DETS]] if len(dt) else dt
    if len(dt) == 0:
        return None
    gtind = np.argsort(gt_ig, kind="mergesort")
    gt_boxes = gt_boxes[gtind]
    gt_ig = gt_ig[gtind]
    gt_ids = gt_ids[gtind]

    ious = _iou_matrix(dt[:, :4], gt_boxes, gt_ig)
    D, G = len(dt), len(gt_boxes)
    gtm = np.zeros(G, bool)
    # dtm stores the matched GT's annotation id, exactly as the reference does
    # (evaluation_script.py:256); downstream truthiness means a detection matched
    # to annotation id 0 counts as UNMATCHED — a reference off-by-one quirk we
    # keep for bit parity with the golden fixtures.
    dtm = np.zeros(D, np.int64)
    dt_ig = np.zeros(D, bool)
    thr = min(IOU_THR, 1 - 1e-10)
    for dind in range(D):
        best_iou = thr
        best_g = -2
        best_m = -2
        for gind in range(G):
            if gtm[gind]:
                continue
            if best_m != -2 and gt_ig[gind] == 1:
                break  # gts sorted ignored-last; a real match already found
            if ious[dind, gind] < best_iou:
                continue
            best_iou = ious[dind, gind]
            best_g = gind
            best_m = 1 if gt_ig[gind] == 0 else -1
        if best_g == -2:
            continue
        dt_ig[dind] = bool(gt_ig[best_g])
        dtm[dind] = gt_ids[best_g]
        if best_m == 1:
            gtm[best_g] = True
    return dt[:, 4], dtm != 0, dt_ig, gt_ig


def _accumulate(per_img, n_images: int):
    """Global FPPI/miss-rate accumulation (evaluation_script.py:296-395).
    Returns (mr9 at the FPPI grid, fppi curve, missrate curve)."""
    per_img = [e for e in per_img if e is not None]
    if not per_img:
        return np.full(len(FPPI_THRS), -1.0), np.zeros(0), np.zeros(0)
    scores = np.concatenate([e[0] for e in per_img])
    dtm = np.concatenate([e[1] for e in per_img])
    dtig = np.concatenate([e[2] for e in per_img])
    gtig = np.concatenate([e[3] for e in per_img])
    npig = int((gtig == 0).sum())
    if npig == 0:
        return np.full(len(FPPI_THRS), -1.0), np.zeros(0), np.zeros(0)
    order = np.argsort(-scores, kind="mergesort")
    dtm, dtig = dtm[order], dtig[order]
    keep = ~dtig
    tps = (dtm & keep)[keep]
    fps = (~dtm & keep)[keep]
    tp_sum = np.cumsum(tps).astype(np.float64)
    fp_sum = np.cumsum(fps).astype(np.float64)
    fppi = fp_sum / n_images
    recall = tp_sum / npig
    mr_curve = 1 - recall
    rec = recall.tolist()
    for i in range(len(rec) - 1, 0, -1):
        if rec[i] < rec[i - 1]:
            rec[i - 1] = rec[i]
    inds = np.searchsorted(fppi, FPPI_THRS, side="right") - 1
    q = np.zeros(len(FPPI_THRS))
    for ri, pi in enumerate(inds):
        # NOTE: pi == -1 wraps to the last element, reproducing the reference's
        # python negative-indexing behavior (evaluation_script.py:380-385)
        q[ri] = rec[pi]
    return q, fppi, mr_curve


def _log_avg_mr(recall9: np.ndarray) -> float:
    """exp(mean(log(mr + 1e-5))) over mr < 2 (evaluation_script.py:458-465)."""
    mrs = 1 - recall9
    valid = mrs[mrs < 2]
    if len(valid) == 0:
        return -1.0
    return float(np.exp(np.mean(np.log(valid + 1e-5))))


@dataclasses.dataclass
class KaistResult:
    MR_all: float
    MR_day: float
    MR_night: float
    MR_near: float
    MR_medium: float
    MR_far: float
    MR_none: float
    MR_partial: float
    MR_heavy: float
    recall_all: float

    def as_dict(self):
        return dataclasses.asdict(self)


def evaluate_kaist(ann_file: str, res_file: str, day_split: int = 1455) -> KaistResult:
    """Full 9-way KAIST MR report (evaluation_script.py:546-646). day_split: number
    of leading (sorted) image ids belonging to the day subset."""
    img_ids, gts = load_kaist_gt(ann_file)
    dts = load_detections(res_file)

    def run(setup: int, ids: Sequence[int]):
        per_img = [_evaluate_img(gts.get(i, []),
                                 dts.get(i, np.zeros((0, 5))), setup)
                   for i in ids]
        return _accumulate(per_img, len(ids))

    q_all, fppi_all, mr_all_curve = run(0, img_ids)
    q_day, _, _ = run(0, img_ids[:day_split])
    q_night, _, _ = run(0, img_ids[day_split:])
    q_near, _, _ = run(1, img_ids)
    q_medium, _, _ = run(2, img_ids)
    q_far, _, _ = run(3, img_ids)
    q_none, _, _ = run(4, img_ids)
    q_partial, _, _ = run(5, img_ids)
    q_heavy, _, _ = run(6, img_ids)
    recall_all = float(1 - mr_all_curve[-1]) if len(mr_all_curve) else 0.0

    return KaistResult(
        MR_all=_log_avg_mr(q_all), MR_day=_log_avg_mr(q_day),
        MR_night=_log_avg_mr(q_night), MR_near=_log_avg_mr(q_near),
        MR_medium=_log_avg_mr(q_medium), MR_far=_log_avg_mr(q_far),
        MR_none=_log_avg_mr(q_none), MR_partial=_log_avg_mr(q_partial),
        MR_heavy=_log_avg_mr(q_heavy), recall_all=recall_all)


def main(argv=None):
    """Standalone evaluation CLI (evaluation_script.py:681-697)."""
    import argparse
    ap = argparse.ArgumentParser("icafusion-kaist-eval")
    ap.add_argument("--annFile", required=True, help="KAIST annotation json")
    ap.add_argument("--rstFiles", nargs="+", required=True,
                    help="result files (txt 'idx,x,y,w,h,score' or COCO json)")
    ap.add_argument("--evalFig", default=None, help="MR-FPPI curve output path")
    args = ap.parse_args(argv)
    results = []
    for rst in args.rstFiles:
        r = evaluate_kaist(args.annFile, rst)
        results.append((rst, r))
        print(f"\n########## {rst} ##########")
        for k, val in r.as_dict().items():
            print(f"{k}: {val * 100:.2f}")
    if args.evalFig:
        img_ids, gts = load_kaist_gt(args.annFile)
        from icafusion_tpu_torch.utils.plots import plot_mr_fppi
        rst, r = results[0]
        dts = load_detections(rst)
        per_img = [_evaluate_img(gts.get(i, []), dts.get(i, np.zeros((0, 5))), 0)
                   for i in img_ids]
        _, fppi, mr = _accumulate(per_img, len(img_ids))
        plot_mr_fppi(fppi, mr, args.evalFig, label=Path(rst).stem)
        print(f"figure: {args.evalFig}")
    return results


if __name__ == "__main__":
    main()
