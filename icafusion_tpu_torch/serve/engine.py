"""Paired-image serving engine on one CUDA device or a mesh of them.

Counterpart of the JAX package's serve/engine.py (``ServingEngine``), the
serving path of the port: letterboxed uint8 pairs are padded to the engine
batch (or a smaller bucket), uploaded, scaled by 1/255, run through the
two-stream model in the engine dtype, decoded and reduced by batched NMS on
the device; the valid rows come back per image and are unpadded, and
optionally rescaled to the native image size.

``predict_paths`` decodes image files (data/decode.py) and serves them,
pipelined; ``warmup`` runs one batch; ``throughput`` times steady serving;
``quantize`` switches to int8 W8A8 serving (utils/quantize.py).

Data parallel (``n_devices``, parallel/mesh.py): one replica of the model
on each mesh device and every batch split into contiguous row shards, each
replica's forward and NMS queued on its own device, as the JAX engine
shards the batch over its mesh.

``merge_streams=K`` serves the stream-merged graph (utils/stream_merge.py),
in every dtype and under int8, where the merged model is calibrated and
quantized.
"""

from __future__ import annotations

import copy
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from icafusion_tpu_torch.models.assembler import ICAFusionModel
from icafusion_tpu_torch.ops.boxes import scale_coords_np
from icafusion_tpu_torch.ops.nms import (Detections, detections_to_numpy,
                                         non_max_suppression)
from icafusion_tpu_torch.parallel.mesh import (Mesh, device_count,
                                               device_scope, make_mesh,
                                               replicate, shard_batch)
from icafusion_tpu_torch.utils.general import resolve_device

TOP_K = 1024   # candidates entering NMS, as the JAX engine serves


class ServingEngine:
    """Serve ``model`` (an ICAFusionModel with its weights; the engine keeps
    its own copy, cast to ``dtype`` and moved to ``device``).

    img_size: a square side or an (H, W) rect canvas. device=None means
    CUDA and raises where there is none; the CPU must be asked for.
    merge_streams: K (an int or a numeric string) runs the first K RGB/IR
    layer pairs as one block-diagonal module each, with the same outputs
    (utils/stream_merge.py). 0 and "auto" merge none: in the JAX package
    "auto" fills the TPU's 128 lanes, which the H100 does not pad, so the
    port keeps it at 0 until a measurement shows merging pays.

    n_devices: the replicas (parallel/mesh.make_mesh: the first n CUDA
    devices, raising where fewer exist, or logical replicas of the CPU);
    None takes gcd(batch_size, the devices present), as the JAX engine
    does, so a batch always divides over them; a device named by its index
    (``cuda:1``) serves alone unless n_devices says otherwise. Each batch,
    and each bucket, must divide over the replicas. ``model`` is the first
    replica.

    The engine may be called from several threads: a lock lets one of them
    launch the device work of a batch, on every replica, at a time. It
    keeps a reference to ``model``, whose float32 weights ``quantize``
    reads (its merged twin where merge_streams is set)."""

    def __init__(self, model: ICAFusionModel, img_size: Union[int, Sequence[int]] = 640,
                 batch_size: int = 32, conf_thres: float = 0.25,
                 iou_thres: float = 0.45, max_det: int = 300,
                 dtype: str = "bfloat16", device=None, merge_streams=0,
                 n_devices: Optional[int] = None):
        from icafusion_tpu_torch.utils.stream_merge import (merged_model,
                                                            resolve_merge)
        k = resolve_merge(merge_streams, model.cfg)
        if k:
            model = merged_model(model, k)    # raises on a merged model
        self.merge_streams = model.merge_pairs
        self.device = resolve_device(device, "ServingEngine")
        self.canvas = ((img_size, img_size) if isinstance(img_size, int)
                       else tuple(img_size))
        self.batch_size = batch_size
        self.conf_thres, self.iou_thres, self.max_det = (conf_thres, iou_thres,
                                                         max_det)
        self.dtype = getattr(torch, dtype)
        n = (math.gcd(batch_size, device_count(self.device))
             if n_devices is None else n_devices)
        self.mesh = (Mesh((self.device,)) if n == 1
                     else make_mesh(n, self.device))
        self._float_model = model
        self._place(copy.deepcopy(model).cast(self.dtype))
        self._lock = threading.Lock()

    def _place(self, model: ICAFusionModel):
        """Serve from ``model``: one copy on each mesh device."""
        self.replicas = replicate(model, self.mesh)
        self.model = self.replicas[0]

    @torch.inference_mode()
    def _serve(self, rgb, ir) -> Detections:
        """(B, H, W, 3) uint8 arrays or tensors -> detections on the first
        device, queued without a wait for the host: each replica runs its
        rows on its own device, and their detections are gathered."""
        def prep(x):
            return (x.permute(0, 3, 1, 2).float() / 255.0).to(self.dtype)

        with self._lock:
            out = []
            for model, dev, x, y in zip(self.replicas, self.mesh.devices,
                                        shard_batch(rgb, self.mesh),
                                        shard_batch(ir, self.mesh)):
                with device_scope(dev):
                    pred = model(prep(x), prep(y))
                    out.append(non_max_suppression(
                        pred, conf_thres=self.conf_thres,
                        iou_thres=self.iou_thres, max_det=self.max_det,
                        top_k=TOP_K))
            if len(out) == 1:
                return out[0]
            dev0 = self.mesh.devices[0]
            return Detections(*(torch.cat([t.to(dev0, non_blocking=True)
                                           for t in ts]) for ts in zip(*out)))

    def _dispatch(self, rgb: np.ndarray, ir: np.ndarray,
                  batch: Optional[int] = None):
        """Pad to the engine batch, or to an explicit smaller ``batch``
        bucket (serve/batcher.py), upload and run; returns (detections still
        on the device, n). The host waits only for the upload."""
        n = rgb.shape[0]
        (H, W), B = self.canvas, batch or self.batch_size
        if B > self.batch_size:
            raise ValueError(f"bucket {B} exceeds the engine batch "
                             f"{self.batch_size}")
        if n > B or rgb.shape[1:] != (H, W, 3) or ir.shape != rgb.shape:
            raise ValueError(f"predict_arrays: got {rgb.shape} / {ir.shape}, "
                             f"want at most {B} pairs of ({H}, {W}, 3)")
        if n < B:
            pad = np.zeros((B - n, H, W, 3), np.uint8)
            rgb = np.concatenate([rgb, pad])
            ir = np.concatenate([ir, pad])
        return self._serve(rgb, ir), n

    def _finalize(self, dets: Detections, n: int,
                  orig_hw=None) -> List[np.ndarray]:
        """Copy the detections to the host, drop the padding images and
        rescale to native coordinates where orig_hw is given (the blocking
        half of _dispatch)."""
        out = detections_to_numpy(dets)[:n]
        if orig_hw is not None:
            for i, hw0 in enumerate(orig_hw[:n]):
                if hw0 is not None and len(out[i]):
                    out[i][:, :4] = scale_coords_np(self.canvas, out[i][:, :4],
                                                    tuple(hw0))
        return out

    def warmup(self):
        """One full batch of zero images, end to end."""
        (H, W), B = self.canvas, self.batch_size
        z = np.zeros((B, H, W, 3), np.uint8)
        self._finalize(*self._dispatch(z, z))

    def quantize(self, calib_pairs: Sequence = (), cache: Optional[str] = None,
                 cache_key: Optional[dict] = None) -> bool:
        """Switch to int8 W8A8 serving (utils/quantize.py), as the JAX
        engine's quantize does: calibrate this engine's model (its dtype,
        its device) on ``calib_pairs``, (rgb, ir) batches of (n, H, W, 3)
        uint8 letterboxed pairs, divided by 255; quantize with the
        Detect-feeder skip; serve from the int8 model.

        cache: path of a calibration artifact. When it exists and carries
        the key (scheme, the merge count, this canvas and ``cache_key``),
        the calibration forward is skipped; on a miss the engine calibrates
        and writes it. Returns True on a hit. An engine already quantized
        raises: its model no longer runs the float convs that calibration
        records."""
        from icafusion_tpu_torch.utils.quantize import (
            calibrate, calibrate_cached, calibration_key, detect_feeder_skip,
            is_quantized, quantize_model)
        if is_quantized(self.model):
            raise RuntimeError("ServingEngine.quantize: the engine is "
                               "already quantized")

        def batches():
            return [(np.asarray(r, np.float32) / 255.0,
                     np.asarray(i, np.float32) / 255.0)
                    for r, i in calib_pairs]

        hit = False
        with self._lock:
            if cache:
                key = calibration_key(merge=self.merge_streams,
                                      extra={"canvas": list(self.canvas),
                                             **(cache_key or {})})
                calib, hit = calibrate_cached(self.model, batches, cache, key)
            else:
                calib = calibrate(self.model, batches())
            model = quantize_model(copy.deepcopy(self._float_model), calib,
                                   skip=detect_feeder_skip(self.model.cfg))
            self._place(model.cast(self.dtype))
        return hit

    def predict_arrays(self, rgb: np.ndarray, ir: np.ndarray,
                       orig_hw: Optional[Sequence] = None) -> List[np.ndarray]:
        """rgb/ir: (n, H, W, 3) uint8 letterboxed pairs on this engine's
        canvas, n <= batch_size. Returns per image a (k, 6) float32 array
        [x1, y1, x2, y2, conf, cls], k <= max_det, in canvas coordinates (or
        native ones where orig_hw gives the native (h, w))."""
        dets, n = self._dispatch(rgb, ir)
        return self._finalize(dets, n, orig_hw)

    def predict_paths(self, rgb_paths: List[str], ir_paths: List[str],
                      n_threads: Optional[int] = None,
                      pipeline: bool = True) -> List[np.ndarray]:
        """Decode (data/decode.py, scaleup=True) and serve image pairs in
        batches of batch_size; detections in native image coordinates.

        pipeline=True decodes batch i+1 on a worker thread while batch i
        runs on the device, and fetches batch i's detections only after
        batch i+1 is dispatched, as the JAX engine does. The results are
        equal and in order either way."""
        from icafusion_tpu_torch.data.decode import decode_letterbox_batch
        B = self.batch_size
        chunks = [(rgb_paths[s:s + B], ir_paths[s:s + B])
                  for s in range(0, len(rgb_paths), B)]

        def decode(chunk):
            rgb, ir, _, _, hw = decode_letterbox_batch(
                chunk[0], chunk[1], self.canvas, scaleup=True,
                n_threads=n_threads)
            return rgb, ir, hw.tolist()

        outs: List[np.ndarray] = []
        if not pipeline:
            for chunk in chunks:
                rgb, ir, hw = decode(chunk)
                outs.extend(self.predict_arrays(rgb, ir, orig_hw=hw))
            return outs
        pending = None                     # (device detections, n, hw)
        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(decode, chunks[0]) if chunks else None
            for i in range(len(chunks)):
                rgb, ir, hw = fut.result()
                fut = (ex.submit(decode, chunks[i + 1])
                       if i + 1 < len(chunks) else None)
                dets, n = self._dispatch(rgb, ir)
                if pending is not None:
                    outs.extend(self._finalize(*pending))
                pending = (dets, n, hw)
            if pending is not None:
                outs.extend(self._finalize(*pending))
        return outs

    def throughput(self, iters: int = 20) -> float:
        """Steady serving rate in pairs a second by the host clock: one
        batch of random pairs uploaded once, one warm-up call, then iters
        calls on the device tensors, with one synchronisation at the end
        (each replica's rows come from the first device)."""
        (H, W), B = self.canvas, self.batch_size
        rng = np.random.default_rng(0)
        rgb, ir = (torch.from_numpy(rng.integers(0, 256, (B, H, W, 3),
                                                 np.uint8)).to(self.device)
                   for _ in range(2))
        self._serve(rgb, ir).scores.sum().item()
        t0 = time.perf_counter()
        for _ in range(iters):
            dets = self._serve(rgb, ir)
        dets.scores.sum().item()
        return B * iters / (time.perf_counter() - t0)
