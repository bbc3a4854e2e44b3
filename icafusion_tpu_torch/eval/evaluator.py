"""Validation loop: batched paired inference, NMS on the device, mAP.

Counterpart of the JAX package's eval/evaluator.py (reference
test.py:23-367): multi-label NMS at conf 0.001 / IoU 0.5, predictions
rescaled to the native image, greedy per-class matching over the IoU grid
0.5:0.05:0.95, and the headline metrics P/R/mAP@.5/mAP@.75/mAP from
ap_per_class. Each batch runs forward, decode and NMS on the device; only
the kept detections come back to the host.

Not ported: TTA (``augment``), confluence, the validation loss, data
parallel evaluation, the MR-format and COCO-json dumps and the plots.
"""

from __future__ import annotations

import copy
import time
from typing import Iterable, Optional

import numpy as np
import torch

from icafusion_tpu_torch.eval.metrics import ConfusionMatrix, summarize
from icafusion_tpu_torch.models.assembler import ICAFusionModel
from icafusion_tpu_torch.ops.boxes import scale_coords_np
from icafusion_tpu_torch.ops.nms import detections_to_numpy, non_max_suppression

IOUV = np.linspace(0.5, 0.95, 10)

_NOT_PORTED = ("augment", "confluence", "loss_fn", "n_devices")


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
    CPU must be asked for. The arguments of the JAX Evaluator that are not
    ported raise when set."""

    def __init__(self, model: ICAFusionModel, nc: int,
                 conf_thres: float = 0.001, iou_thres: float = 0.5,
                 max_det: int = 300, top_k: int = 8192,
                 single_cls: bool = False, dtype: str = "float32",
                 device=None, **not_ported):
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"Evaluator: unknown argument {name!r}")
            if value not in (None, False):
                raise NotImplementedError(f"Evaluator: {name} is not ported")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Evaluator: no CUDA device (pass device='cpu' "
                               "to evaluate on the CPU)")
        self.nc = nc
        self.conf_thres, self.iou_thres = conf_thres, iou_thres
        self.max_det, self.top_k = max_det, top_k
        self.single_cls = single_cls
        self.dtype = getattr(torch, dtype)
        self.model = copy.deepcopy(model).cast(self.dtype).to(self.device)

    @torch.inference_mode()
    def _infer(self, rgb: np.ndarray, ir: np.ndarray):
        def prep(a):
            x = torch.from_numpy(a).to(self.device).permute(0, 3, 1, 2)
            return (x.float() / 255.0).to(self.dtype)

        pred = self.model(prep(rgb), prep(ir))
        return non_max_suppression(pred, conf_thres=self.conf_thres,
                                   iou_thres=self.iou_thres, multi_label=True,
                                   agnostic=self.single_cls,
                                   max_det=self.max_det, top_k=self.top_k)

    def run(self, val_batches: Iterable[dict], img_size: int,
            confusion: bool = False, mr_txt_dir: Optional[str] = None,
            coco_json: Optional[str] = None, plots_dir: Optional[str] = None):
        """val_batches: dicts from PairedLoader.val_batches(). Returns the
        summarize() dict with 'seen', 't_total_ms' (host-clock ms per image
        of forward, NMS and the copy of the detections to the host, the
        first two batches excluded) and, with confusion, 'cm'."""
        for name, value in (("mr_txt_dir", mr_txt_dir),
                            ("coco_json", coco_json),
                            ("plots_dir", plots_dir)):
            if value is not None:
                raise NotImplementedError(f"Evaluator.run: {name} is not "
                                          "ported")
        stats = []
        cm = ConfusionMatrix(self.nc) if confusion else None
        seen = 0
        t_infer, n_timed = 0.0, 0
        for batch_idx, batch in enumerate(val_batches):
            t0 = time.perf_counter()
            det_list = detections_to_numpy(self._infer(batch["rgb"],
                                                       batch["ir"]))
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
        out = summarize(stats, self.nc)
        out["seen"] = seen
        out["t_total_ms"] = (t_infer / n_timed * 1e3) if n_timed else 0.0
        if cm is not None:
            out["cm"] = cm.matrix
        return out
