"""Greedy NMS selection loop: one CUDA block per image.

Replaces the Pallas TPU kernel ``icafusion_tpu/kernels/nms.py:
pallas_greedy_nms`` (body ``_nms_kernel``). Input per image: K candidate
boxes (xyxy, class offset applied) with scores in descending order, padding
at -1. ``max_det`` steps each pick the highest active score (ties to the
lowest index, all -1 picks index 0, as ``jnp.argmax`` does) and suppress the
pick and every box whose IoU with it exceeds the threshold. Returns the
picked indices (B, max_det) int32 and ``ok`` (B, max_det) bool, true where
the picked score was above 0.

``greedy_nms`` launches the CUDA kernel of ``csrc/greedy_nms.cu`` on CUDA
tensors and runs ``greedy_nms_reference``, the plain PyTorch loop, on CPU
tensors only. Both compute the IoU in the order of kernels/nms.py:50-55
without fused multiply-adds, so a box exactly at the threshold is
suppressed alike on both.

The kernel holds up to REGISTER_K candidates an image in registers; a larger
pool keeps the rest of its active scores in a (B, K) float32 scratch that
the wrapper allocates, so any K >= 1 runs, as in the JAX function.
"""

from __future__ import annotations

import torch

from icafusion_tpu_torch.kernels import _build

THREADS = 512          # csrc/greedy_nms.cu: block size
MAX_ITEMS = 16         # candidates a thread holds in registers
REGISTER_K = THREADS * MAX_ITEMS   # larger pools spill to a global scratch


def greedy_nms_reference(boxes, scores, iou_thres: float, max_det: int):
    """Plain loop with the semantics of the JAX ops/nms.py:_greedy_nms."""
    B, K, _ = boxes.shape
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    active = scores.float().clone()
    rows = torch.arange(B, device=boxes.device)
    keep = torch.zeros((B, max_det), dtype=torch.int32, device=boxes.device)
    ok = torch.zeros((B, max_det), dtype=torch.bool, device=boxes.device)
    for step in range(max_det):
        i = active.argmax(dim=1)
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
        keep[:, step] = i.to(torch.int32)
        ok[:, step] = s > 0.0
    return keep, ok


def greedy_nms(boxes, scores, iou_thres: float, max_det: int):
    """boxes: (B, K, 4) float32; scores: (B, K) float32, descending with
    padding <= 0. Returns (keep (B, max_det) int32, ok (B, max_det) bool)."""
    if boxes.device.type == "cpu":
        return greedy_nms_reference(boxes, scores, iou_thres, max_det)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    B, K, four = boxes.shape
    if four != 4 or scores.shape != (B, K):
        raise ValueError(f"greedy_nms: boxes {tuple(boxes.shape)}, scores "
                         f"{tuple(scores.shape)}")
    if K < 1 or max_det < 1:
        raise ValueError(f"greedy_nms: K={K} and max_det={max_det} must be "
                         ">= 1")
    for t in (boxes, scores):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != boxes.device):
            raise ValueError("greedy_nms: boxes and scores must be contiguous "
                             "float32 on one device")
    keep = torch.empty((B, max_det), dtype=torch.int32, device=boxes.device)
    ok = torch.empty((B, max_det), dtype=torch.bool, device=boxes.device)
    active = (torch.empty((B, K), dtype=torch.float32, device=boxes.device)
              if K > REGISTER_K else None)
    with torch.cuda.device(boxes.device):
        err = _build.library().icaf_greedy_nms(
            boxes.data_ptr(), scores.data_ptr(),
            0 if active is None else active.data_ptr(), keep.data_ptr(),
            ok.data_ptr(), B, K, max_det, float(iou_thres),
            _build.stream_handle(boxes.device))
    _build.check(err, "greedy_nms")
    greedy_nms.launches += 1
    return keep, ok


greedy_nms.launches = 0
