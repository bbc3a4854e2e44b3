"""Paired-image serving engine on one CUDA device.

Counterpart of the JAX package's serve/engine.py (``ServingEngine``), the
serving path of the port: letterboxed uint8 pairs are padded to the engine
batch, uploaded, scaled by 1/255, run through the two-stream model in the
engine dtype, decoded and reduced by batched NMS on the device; the valid
rows come back per image and are unpadded, and optionally rescaled to the
native image size.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from icafusion_tpu_torch.models.assembler import ICAFusionModel
from icafusion_tpu_torch.ops.boxes import scale_coords_np
from icafusion_tpu_torch.ops.nms import (Detections, detections_to_numpy,
                                         non_max_suppression)
from icafusion_tpu_torch.utils.general import resolve_device

TOP_K = 1024   # candidates entering NMS, as the JAX engine serves


class ServingEngine:
    """Serve ``model`` (an ICAFusionModel with its weights; the engine keeps
    its own copy, cast to ``dtype`` and moved to ``device``).

    img_size: a square side or an (H, W) rect canvas. device=None means
    CUDA and raises where there is none; the CPU must be asked for."""

    def __init__(self, model: ICAFusionModel, img_size: Union[int, Sequence[int]] = 640,
                 batch_size: int = 32, conf_thres: float = 0.25,
                 iou_thres: float = 0.45, max_det: int = 300,
                 dtype: str = "bfloat16", device=None):
        self.device = resolve_device(device, "ServingEngine")
        self.canvas = ((img_size, img_size) if isinstance(img_size, int)
                       else tuple(img_size))
        self.batch_size = batch_size
        self.conf_thres, self.iou_thres, self.max_det = (conf_thres, iou_thres,
                                                         max_det)
        self.dtype = getattr(torch, dtype)
        self.model = copy.deepcopy(model).cast(self.dtype).to(self.device)

    @torch.inference_mode()
    def _serve(self, rgb: np.ndarray, ir: np.ndarray) -> Detections:
        def prep(a):
            x = torch.from_numpy(a).to(self.device).permute(0, 3, 1, 2)
            return (x.float() / 255.0).to(self.dtype)

        pred = self.model(prep(rgb), prep(ir))
        return non_max_suppression(pred, conf_thres=self.conf_thres,
                                   iou_thres=self.iou_thres,
                                   max_det=self.max_det, top_k=TOP_K)

    def _dispatch(self, rgb: np.ndarray, ir: np.ndarray):
        """Pad to the engine batch and run; returns (detections, n)."""
        n = rgb.shape[0]
        (H, W), B = self.canvas, self.batch_size
        if n > B or rgb.shape[1:] != (H, W, 3) or ir.shape != rgb.shape:
            raise ValueError(f"predict_arrays: got {rgb.shape} / {ir.shape}, "
                             f"want at most {B} pairs of ({H}, {W}, 3)")
        if n < B:
            pad = np.zeros((B - n, H, W, 3), np.uint8)
            rgb = np.concatenate([rgb, pad])
            ir = np.concatenate([ir, pad])
        return self._serve(np.ascontiguousarray(rgb),
                           np.ascontiguousarray(ir)), n

    def _finalize(self, dets: Detections, n: int,
                  orig_hw=None) -> List[np.ndarray]:
        """Copy the detections to the host, drop the padding images and
        rescale to native coordinates where orig_hw is given."""
        out = detections_to_numpy(dets)[:n]
        if orig_hw is not None:
            for i, hw0 in enumerate(orig_hw[:n]):
                if hw0 is not None and len(out[i]):
                    out[i][:, :4] = scale_coords_np(self.canvas, out[i][:, :4],
                                                    tuple(hw0))
        return out

    def predict_arrays(self, rgb: np.ndarray, ir: np.ndarray,
                       orig_hw: Optional[Sequence] = None) -> List[np.ndarray]:
        """rgb/ir: (n, H, W, 3) uint8 letterboxed pairs on this engine's
        canvas, n <= batch_size. Returns per image a (k, 6) float32 array
        [x1, y1, x2, y2, conf, cls], k <= max_det, in canvas coordinates (or
        native ones where orig_hw gives the native (h, w))."""
        dets, n = self._dispatch(rgb, ir)
        return self._finalize(dets, n, orig_hw)
