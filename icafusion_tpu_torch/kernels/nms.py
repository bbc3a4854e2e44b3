"""Greedy NMS on the card: a suppression bitmask, then a walk over it.

Replaces the Pallas TPU kernel ``icafusion_tpu/kernels/nms.py:
pallas_greedy_nms`` (body ``_nms_kernel``). Input per image: K candidate
boxes (xyxy, class offset applied) and their scores. ``max_det`` steps each
pick the highest active score (ties to the lowest index; all -1 picks index
0, as ``jnp.argmax`` does) and suppress the pick and every box whose IoU
with it exceeds the threshold. Returns the picked indices (B, max_det) int32
and ``ok`` (B, max_det) bool, true where the picked score was above 0.

``greedy_nms`` runs ``greedy_nms_reference``, the plain PyTorch loop, on CPU
tensors only. On CUDA tensors it launches the two kernels of
``csrc/greedy_nms.cu``: the first builds, across the card, a bitmask whose
bit j of row i is set iff j > i and IoU(i, j) > iou_thres; the second, one
block per image, walks the mask in index order in one warp. Both sides
compute the IoU in the order of kernels/nms.py:50-55 without fused
multiply-adds, so a box exactly at the threshold falls alike on both.

The walk relies on the contract of the JAX kernel and of
``ops/nms.py:non_max_suppression``, which sorts before it calls: scores are
finite and non-increasing along K. Under it, keep and ok equal the plain
loop's index for index, for any K >= 1 and max_det >= 1. On unsorted scores
the kernels do not reproduce the argmax loop.
"""

from __future__ import annotations

import torch

from icafusion_tpu_torch.kernels import _build


def mask_words(K: int) -> int:
    """64-bit words in a row of the suppression mask: ceil(K / 64), rounded
    up to even so that every row starts on 16 bytes, as the kernel's bulk
    copies need (csrc/greedy_nms.cu: Wp)."""
    words = -(-K // 64)
    return words + (words & 1)


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
    """boxes: (B, K, 4) float32; scores: (B, K) float32, finite and
    non-increasing along K, padding <= 0. Returns (keep (B, max_det) int32,
    ok (B, max_det) bool). One call counts one launch, though the card runs
    two kernels."""
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
    # bit j of row i of image b: word j // 64 of mask[b, i]
    mask = torch.empty((B, K, mask_words(K)), dtype=torch.int64,
                       device=boxes.device)
    with torch.cuda.device(boxes.device):
        err = _build.library().icaf_greedy_nms(
            boxes.data_ptr(), scores.data_ptr(), mask.data_ptr(),
            keep.data_ptr(), ok.data_ptr(), B, K, max_det, float(iou_thres),
            _build.stream_handle(boxes.device))
    _build.check(err, "greedy_nms")
    greedy_nms.launches += 1
    return keep, ok


greedy_nms.launches = 0
