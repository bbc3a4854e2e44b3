"""Validation loop: batched paired inference, NMS on the device, mAP.

Counterpart of the JAX package's eval/evaluator.py (reference
test.py:23-367): multi-label NMS at conf 0.001 / IoU 0.5, predictions
rescaled to the native image, greedy per-class matching over the IoU grid
0.5:0.05:0.95, and the headline metrics P/R/mAP@.5/mAP@.75/mAP from
ap_per_class. Each batch runs forward, decode and NMS on the device; only
the kept detections come back to the host.

Options, as in the JAX Evaluator: TTA (``augment``), confluence on the host
in place of NMS, the validation loss from the raw maps of the same forward
(``loss_fn``), the MR-format txts with result.txt (the KAIST miss-rate
input), the COCO detections json, and the PR/F1/P/R curves. Data-parallel
evaluation (``n_devices``) is not ported (ROADMAP A8).
"""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path
from typing import Iterable, List, Optional

import numpy as np
import torch

from icafusion_tpu_torch.eval.metrics import ConfusionMatrix, summarize
from icafusion_tpu_torch.models.assembler import ICAFusionModel
from icafusion_tpu_torch.models.tta import tta_inference
from icafusion_tpu_torch.ops.boxes import scale_coords_np
from icafusion_tpu_torch.ops.confluence import confluence_process
from icafusion_tpu_torch.ops.nms import detections_to_numpy, non_max_suppression
from icafusion_tpu_torch.train.loss import pad_targets
from icafusion_tpu_torch.utils.general import resolve_device

IOUV = np.linspace(0.5, 0.95, 10)


def np_box_iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    a1 = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    a2 = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (a1[:, None] + a2[None, :] - inter + 1e-16)


def match_predictions(pred: np.ndarray, tbox: np.ndarray, tcls: np.ndarray,
                      iouv=IOUV) -> np.ndarray:
    """Greedy per-class matching (test.py:196-227). pred (n,6) xyxy+conf+cls in
    native space, tbox (m,4) native xyxy, tcls (m,). Returns correct (n, len(iouv))."""
    correct = np.zeros((len(pred), len(iouv)), bool)
    if not len(tcls) or not len(pred):
        return correct
    detected: set = set()
    for cls in np.unique(tcls):
        ti = np.nonzero(tcls == cls)[0]
        pi = np.nonzero(pred[:, 5] == cls)[0]
        if not len(pi):
            continue
        ious_all = np_box_iou(pred[pi, :4], tbox[ti])
        ious = ious_all.max(1)
        best = ious_all.argmax(1)
        for j in np.nonzero(ious > iouv[0])[0]:
            d = int(ti[best[j]])
            if d not in detected:
                detected.add(d)
                correct[pi[j]] = ious[j] > iouv
                if len(detected) == len(tcls):
                    break
    return correct


class Evaluator:
    """Evaluate ``model`` (an ICAFusionModel holding its weights; the
    evaluator keeps its own copy, cast to ``dtype`` and moved to
    ``device``). device=None means CUDA and raises where there is none; the
    CPU must be asked for.

    augment: the TTA ensemble (models/tta.py). confluence: the host
    clustering of ops/confluence.py on the decoded predictions in place of
    NMS, at conf_thres (raise it, e.g. to 0.1) and proximity confluence_p.
    loss_fn: a YoloLoss; run() then adds 'val_loss_items' [box, obj, cls,
    rank], the mean over batches of the loss of the eval forward's raw maps
    against at most max_targets labels an image. Not with augment."""

    def __init__(self, model: ICAFusionModel, nc: int,
                 conf_thres: float = 0.001, iou_thres: float = 0.5,
                 max_det: int = 300, top_k: int = 8192,
                 single_cls: bool = False, augment: bool = False,
                 confluence: bool = False, confluence_p: float = 0.6,
                 loss_fn=None, max_targets: int = 128,
                 n_devices: Optional[int] = None, dtype: str = "float32",
                 device=None):
        if n_devices not in (None, 1):
            raise NotImplementedError("Evaluator: n_devices is not ported "
                                      "(ROADMAP A8)")
        if loss_fn is not None and augment:
            raise ValueError("val loss is unavailable under TTA (the "
                             "ensembled prediction has no single raw-map "
                             "set)")
        self.device = resolve_device(device, "Evaluator")
        self.nc = nc
        self.conf_thres, self.iou_thres = conf_thres, iou_thres
        self.max_det, self.top_k = max_det, top_k
        self.single_cls = single_cls
        self.augment = augment
        self.confluence, self.confluence_p = confluence, confluence_p
        self.loss_fn, self.max_targets = loss_fn, max_targets
        self.dtype = getattr(torch, dtype)
        self.model = copy.deepcopy(model).cast(self.dtype).to(self.device)

    def _prep(self, a: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, 3, H, W) float32 in [0, 1] on the
        device, channels_last."""
        x = torch.from_numpy(a).to(self.device).permute(0, 3, 1, 2)
        return x.float() / 255.0

    @torch.inference_mode()
    def _infer(self, rgb: np.ndarray, ir: np.ndarray, targets=None):
        """(detections, or the decoded predictions under confluence; the
        loss items or None)."""
        x, y = self._prep(rgb), self._prep(ir)
        items = None
        if self.augment:
            pred = tta_inference(self.model, x, y, dtype=self.dtype)
        elif targets is not None:
            pred, maps = self.model(x.to(self.dtype), y.to(self.dtype),
                                    raw=True)
            _, items = self.loss_fn(maps, *targets)
        else:
            pred = self.model(x.to(self.dtype), y.to(self.dtype))
        if self.confluence:
            return pred, items
        return non_max_suppression(pred, conf_thres=self.conf_thres,
                                   iou_thres=self.iou_thres, multi_label=True,
                                   agnostic=self.single_cls,
                                   max_det=self.max_det,
                                   top_k=self.top_k), items

    def _targets(self, batch: dict, img_size: int):
        """The batch's labels moved to the letterboxed canvas, padded, on
        the device. As in the JAX Evaluator, normalised by img_size (on a
        rect canvas that is not the canvas's side: ROADMAP Queue C)."""
        canvas_labels = []
        for l, ((h0, w0), (ratio, pad)) in zip(batch["labels"],
                                               batch["shapes"]):
            l = np.asarray(l, np.float32).reshape(-1, 5).copy()
            g = ratio[0]
            l[:, 1] = (l[:, 1] * w0 * g + pad[0]) / img_size
            l[:, 2] = (l[:, 2] * h0 * g + pad[1]) / img_size
            l[:, 3] = l[:, 3] * w0 * g / img_size
            l[:, 4] = l[:, 4] * h0 * g / img_size
            canvas_labels.append(l)
        tgt, mask = pad_targets(canvas_labels, max_targets=self.max_targets)
        return (torch.from_numpy(tgt).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def run(self, val_batches: Iterable[dict], img_size: int,
            confusion: bool = False, mr_txt_dir: Optional[str] = None,
            names: Optional[List[str]] = None,
            coco_json: Optional[str] = None, plots_dir: Optional[str] = None):
        """val_batches: dicts from PairedLoader.val_batches() or
        rect_val_batches(). Returns the summarize() dict with 'seen',
        't_total_ms' (host-clock ms per image of forward, NMS and the copy
        of the detections to the host, the first two batches excluded),
        with confusion 'cm', and with a loss_fn 'val_loss_items'.

        mr_txt_dir: write "idx,x,y,w,h,conf" lines in native pixels, one
        file per image and all of them in result.txt (the KAIST miss-rate
        input). coco_json: write the COCO detections there
        (test.py:185-194). plots_dir: the PR/F1/P/R curves there, labelled
        with names."""
        stats = []
        cm = ConfusionMatrix(self.nc) if confusion else None
        mr_lines = {}
        jdict = []
        seen = 0
        t_infer, n_timed = 0.0, 0
        loss_sum, loss_n = np.zeros(4, np.float64), 0
        for batch_idx, batch in enumerate(val_batches):
            t0 = time.perf_counter()
            targets = (self._targets(batch, img_size)
                       if self.loss_fn is not None else None)
            dets, items = self._infer(batch["rgb"], batch["ir"], targets)
            if items is not None:
                loss_sum += items.double().cpu().numpy()
                loss_n += 1
            if self.confluence:
                det_list = confluence_process(
                    dets.float().cpu().numpy(), conf_thres=self.conf_thres,
                    p_thres=self.confluence_p)
            else:
                det_list = detections_to_numpy(dets)
            if batch_idx > 1:   # warm-up batches excluded, as in JAX
                t_infer += time.perf_counter() - t0
                n_timed += batch["count"]
            for si in range(batch["count"]):
                pred = det_list[si]
                labels = batch["labels"][si]
                (h0, w0), ratio_pad = batch["shapes"][si]
                tcls = labels[:, 0] if len(labels) else np.zeros(0)
                seen += 1
                if len(pred) == 0:
                    stats.append((np.zeros((0, len(IOUV)), bool), np.zeros(0),
                                  np.zeros(0), tcls))
                    continue
                predn = pred.copy()
                if self.single_cls:
                    predn[:, 5] = 0   # test.py:157-158
                predn[:, :4] = scale_coords_np((img_size, img_size),
                                               predn[:, :4], (h0, w0),
                                               ratio_pad)
                if len(labels):
                    # labels: normalised cls + xywh of the native image
                    tbox = np.empty((len(labels), 4), np.float32)
                    cx, cy, bw, bh = (labels[:, 1] * w0, labels[:, 2] * h0,
                                      labels[:, 3] * w0, labels[:, 4] * h0)
                    tbox[:, 0] = cx - bw / 2
                    tbox[:, 1] = cy - bh / 2
                    tbox[:, 2] = cx + bw / 2
                    tbox[:, 3] = cy + bh / 2
                    correct = match_predictions(predn, tbox, tcls)
                    if cm is not None:
                        cm.process_batch(predn, np.concatenate(
                            [tcls[:, None], tbox], 1))
                else:
                    correct = np.zeros((len(pred), len(IOUV)), bool)
                stats.append((correct, pred[:, 4], pred[:, 5], tcls))
                stem = Path(batch["paths"][si]).stem
                if mr_txt_dir is not None:
                    mr_lines[stem] = [f"{seen},{x1:g},{y1:g},{x2 - x1:g},"
                                      f"{y2 - y1:g},{conf:g}"
                                      for x1, y1, x2, y2, conf, _ in predn]
                if coco_json is not None:
                    image_id = int(stem) if stem.isnumeric() else stem
                    for x1, y1, x2, y2, conf, cls in predn:
                        jdict.append({
                            "image_id": image_id, "category_id": int(cls),
                            "bbox": [round(float(x1), 3), round(float(y1), 3),
                                     round(float(x2 - x1), 3),
                                     round(float(y2 - y1), 3)],
                            "score": round(float(conf), 5)})
        out = summarize(stats, self.nc, plot_dir=plots_dir, names=names or ())
        out["seen"] = seen
        if self.loss_fn is not None:
            out["val_loss_items"] = (loss_sum / max(loss_n, 1)).tolist()
        out["t_total_ms"] = (t_infer / n_timed * 1e3) if n_timed else 0.0
        if cm is not None:
            out["cm"] = cm.matrix
        if coco_json is not None:
            Path(coco_json).parent.mkdir(parents=True, exist_ok=True)
            Path(coco_json).write_text(json.dumps(jdict))
        if mr_txt_dir is not None:
            d = Path(mr_txt_dir)
            d.mkdir(parents=True, exist_ok=True)
            all_lines = []
            for stem, lines in mr_lines.items():
                (d / f"{stem}.txt").write_text(
                    "\n".join(lines) + "\n" if lines else "")
                all_lines.extend(lines)
            (d / "result.txt").write_text(
                "\n".join(all_lines) + "\n" if all_lines else "")
        return out
