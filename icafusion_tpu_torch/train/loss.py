"""The YOLOv5 loss over fixed-shape padded targets.

Counterpart of the JAX package's train/loss.py (reference utils/loss.py:
325-463, ComputeLoss and build_targets):

- box: mean(1 - CIoU) over the assigned candidates;
- objectness: BCE against an IoU-valued target map; where several
  candidates land in one cell the highest IoU wins, by a scatter-max
  (``scatter_reduce(..., "amax")``: order-free, so deterministic on the card
  too, where an ``index_put_`` would keep an arbitrary writer);
- classification: BCE against label-smoothed targets;
- per-level objectness balance [4.0, 1.0, 0.4];
- total = (box * box_gain + obj * obj_gain + cls * cls_gain) * batch.

Every (offset, anchor, target) combination is a candidate with a validity
mask, so no shape depends on the data: targets enter as a padded (B, T, 5)
tensor of (cls, x, y, w, h), normalised, with a (B, T) mask.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed
import torch.nn.functional as F

from icafusion_tpu_torch.config import HypConfig
from icafusion_tpu_torch.ops.boxes import bbox_iou
from icafusion_tpu_torch.parallel.mesh import world

# neighbour-cell offsets with the g = 0.5 bias (loss.py:417-421)
_G = 0.5
_OFFSETS = np.array([[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1]],
                    np.float32) * _G


def smooth_bce(eps: float = 0.0) -> Tuple[float, float]:
    """Positive and negative BCE targets of label smoothing (loss.py:15-17)."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def bce_with_logits(logits, targets, pos_weight: float = 1.0):
    """Elementwise BCE with logits, torch's pos_weight on the positive term."""
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def focal_bce_with_logits(logits, targets, gamma: float,
                          pos_weight: float = 1.0, alpha: float = 0.25):
    """FocalLoss around BCE (loss.py:37-64); the caller reduces."""
    loss = bce_with_logits(logits, targets, pos_weight)
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    alpha_factor = targets * alpha + (1 - targets) * (1 - alpha)
    return loss * alpha_factor * (1.0 - p_t) ** gamma


def qfocal_bce_with_logits(logits, targets, gamma: float,
                           pos_weight: float = 1.0, alpha: float = 0.25):
    """Quality focal loss (loss.py:67-90)."""
    loss = bce_with_logits(logits, targets, pos_weight)
    p = torch.sigmoid(logits)
    alpha_factor = targets * alpha + (1 - targets) * (1 - alpha)
    return loss * alpha_factor * (targets - p).abs() ** gamma


def bce_blur_with_logits(logits, targets, alpha: float = 0.05,
                         pos_weight: float = 1.0):
    """BCEBlurWithLogitsLoss (loss.py:20-34): confident positives on a 0
    target (likely missing labels) are down-weighted."""
    loss = bce_with_logits(logits, targets, pos_weight)
    dx = torch.sigmoid(logits) - targets
    return loss * (1.0 - torch.exp((dx - 1.0) / (alpha + 1e-4)))


def vf_bce_with_logits(logits, targets, gamma: float = 2.0,
                       alpha: float = 0.25, pos_weight: float = 1.0):
    """Varifocal loss (loss.py:94-117): positives weighted by their target,
    negatives by alpha * |p - t| ** gamma."""
    loss = bce_with_logits(logits, targets, pos_weight)
    p = torch.sigmoid(logits)
    pos = (targets > 0.0).to(logits.dtype)
    w = targets * pos + alpha * (p - targets).abs() ** gamma * (1 - pos)
    return loss * w


@dataclasses.dataclass
class YoloLoss:
    """Callable loss. anchors: (nl, na, 2) in grid units (pixels / stride).
    box/obj/cls gains are those after the trainer's nl/nc/imgsz rescale
    (train/trainer.py: scaled_gains)."""
    hyp: HypConfig
    nc: int
    anchors: np.ndarray
    strides: Tuple[int, ...] = (8, 16, 32)
    gr: float = 1.0               # iou/objectness mixing (train.py:249)
    box_gain: float = 0.05
    obj_gain: float = 1.0
    cls_gain: float = 0.5

    def __post_init__(self):
        self.anchors = np.asarray(self.anchors, np.float32)
        self.nl, self.na = self.anchors.shape[:2]
        self.balance = {3: [4.0, 1.0, 0.4]}.get(
            self.nl, [4.0, 1.0, 0.25, 0.06, 0.02])
        self.cp, self.cn = smooth_bce(self.hyp.label_smoothing)
        self._consts = {}

    def _device_consts(self, dev: torch.device):
        """(anchors, offsets) on ``dev``, copied there once: a copy from
        the host inside a step would wait for the card."""
        if dev not in self._consts:
            self._consts[dev] = (torch.from_numpy(self.anchors).to(dev),
                                 torch.from_numpy(_OFFSETS).to(dev))
        return self._consts[dev]

    def _level_candidates(self, level: int, ny: int, nx: int, targets, mask):
        """Every (offset, anchor, target) candidate of one level, flat of
        length 5 * na * B * T: image b, anchor a, cell (gj, gi), box target
        txy/twh and anchor in grid units, class and validity."""
        B, T, _ = targets.shape
        M = B * T
        dev = targets.device
        t = targets.reshape(M, 5).float()
        m = mask.reshape(M)
        b_idx = torch.arange(B, device=dev).repeat_interleave(T)

        all_anchors, offs = self._device_consts(dev)
        gxy = torch.stack([t[:, 1] * nx, t[:, 2] * ny], -1)   # grid units
        gwh = torch.stack([t[:, 3] * nx, t[:, 4] * ny], -1)
        cls = t[:, 0].long()

        anchors = all_anchors[level]                                # (na, 2)
        r = gwh[None] / anchors[:, None]                            # (na, M, 2)
        ratio_ok = torch.maximum(r, 1.0 / r).amax(-1) < self.hyp.anchor_t
        valid_am = ratio_ok & m[None]

        gxi = torch.stack([nx - gxy[:, 0], ny - gxy[:, 1]], -1)
        jk = (torch.remainder(gxy, 1.0) < _G) & (gxy > 1.0)         # (M, 2)
        lm = (torch.remainder(gxi, 1.0) < _G) & (gxi > 1.0)
        off_ok = torch.stack([torch.ones(M, dtype=torch.bool, device=dev),
                              jk[:, 0], jk[:, 1], lm[:, 0], lm[:, 1]])

        gij = torch.floor(gxy[None] - offs[:, None])                # (5, M, 2)
        gi = gij[..., 0].clamp(0, nx - 1)
        gj = gij[..., 1].clamp(0, ny - 1)
        txy = gxy[None] - torch.stack([gi, gj], -1)                 # post-clamp

        na = self.na
        shape5 = (5, na, M)
        return dict(
            b=b_idx[None, None].expand(shape5).reshape(-1),
            a=torch.arange(na, device=dev)[None, :, None].expand(shape5)
            .reshape(-1),
            gj=gj[:, None].expand(shape5).reshape(-1).long(),
            gi=gi[:, None].expand(shape5).reshape(-1).long(),
            txy=txy[:, None].expand(shape5 + (2,)).reshape(-1, 2),
            twh=gwh[None, None].expand(shape5 + (2,)).reshape(-1, 2),
            anc=anchors[None, :, None].expand(shape5 + (2,)).reshape(-1, 2),
            cls=cls[None, None].expand(shape5).reshape(-1),
            valid=(off_ok[:, None] & valid_am[None]).reshape(-1),
        )

    def _bce(self, logits, t, pw):
        if self.hyp.fl_gamma > 0:
            return focal_bce_with_logits(logits, t, self.hyp.fl_gamma, pw)
        return bce_with_logits(logits, t, pw)

    def terms(self, preds: Sequence[torch.Tensor], targets, mask):
        """The loss's sums before normalisation: (num, den), num (3, nl)
        the box, objectness and class sums of each level, den (2, nl) its
        count of valid candidates and of cells. Sums over disjoint parts of
        a batch add up to the whole batch's."""
        B = preds[0].shape[0]
        dev = preds[0].device
        num, den = [], []
        for i, p in enumerate(preds):
            p = p.float()
            _, ny, nx, na, no = p.shape
            c = self._level_candidates(i, ny, nx, targets, mask)
            valid = c["valid"]

            flat = ((c["b"] * ny + c["gj"]) * nx + c["gi"]) * na + c["a"]
            ps = p.reshape(-1, no)[flat]                         # (C, no)

            pxy = torch.sigmoid(ps[:, 0:2]) * 2.0 - 0.5
            pwh = (torch.sigmoid(ps[:, 2:4]) * 2.0) ** 2 * c["anc"]
            iou = bbox_iou(torch.cat([pxy, pwh], -1),
                           torch.cat([c["txy"], c["twh"]], -1),
                           x1y1x2y2=False, CIoU=True)
            box = torch.where(valid, 1.0 - iou, 0.0).sum()

            # objectness target: scatter-max of the candidates' IoU
            score = iou.detach().clamp(min=0.0)
            tobj_val = torch.where(valid, (1.0 - self.gr) + self.gr * score,
                                   0.0)
            tobj = torch.zeros(B * ny * nx * na, device=dev).scatter_reduce(
                0, flat, tobj_val, reduce="amax", include_self=True)
            obj = self._bce(p[..., 4].reshape(-1), tobj,
                            self.hyp.obj_pw).sum()

            cls = torch.zeros((), device=dev)
            if self.nc > 1:
                hot = F.one_hot(c["cls"], self.nc).bool()
                tcls = torch.where(hot, self.cp, self.cn)
                cls_loss = self._bce(ps[:, 5:], tcls, self.hyp.cls_pw)
                cls = torch.where(valid[:, None], cls_loss, 0.0).sum()
            num.append(torch.stack([box, obj, cls]))
            den.append(torch.stack([valid.sum().float(),
                                    torch.full((), float(tobj.numel()),
                                               device=dev)]))
        return torch.stack(num, 1), torch.stack(den, 1)

    def normalise(self, num, den, batch):
        """(total loss, items [box, obj, cls, 0]) from terms' sums and the
        batch size: box and class sums over max(valid, 1), objectness over
        the cells, per-level balance, gains, total times the batch."""
        lbox = lobj = lcls = torch.zeros((), device=num.device)
        for i in range(num.shape[1]):
            denom = den[0, i].clamp(min=1.0)
            lbox = lbox + num[0, i] / denom
            lobj = lobj + num[1, i] / den[1, i] * self.balance[i]
            if self.nc > 1:
                lcls = lcls + num[2, i] / (denom * self.nc)
        lbox = lbox * self.box_gain
        lobj = lobj * self.obj_gain
        lcls = lcls * self.cls_gain
        lrk = torch.zeros((), device=num.device)  # the ranking-loss slot
        return (lbox + lobj + lcls + lrk) * batch, torch.stack(
            [lbox, lobj, lcls, lrk])

    def __call__(self, preds: Sequence[torch.Tensor], targets, mask):
        """preds: nl tensors (B, ny, nx, na, 5 + nc); targets (B, T, 5);
        mask (B, T) bool. Returns (total loss, items [box, obj, cls, 0]),
        float32, as loss.py:400-407.

        Under a process group of more than one rank (parallel/mesh.py),
        as BatchNorm2d takes it, the rank holds one share of a global
        batch: the counts and the batch size are summed over the group
        first, so the rank's loss is its share of the global loss, and the
        shares (and their gradients) sum to it."""
        num, den = self.terms(preds, targets, mask)
        batch = torch.full((), float(preds[0].shape[0]), device=num.device)
        if world() > 1:
            counts = torch.cat([den.flatten(), batch[None]])
            torch.distributed.all_reduce(counts)
            den, batch = counts[:-1].view_as(den), counts[-1]
        return self.normalise(num, den, batch)


def pad_targets(label_list: Sequence[np.ndarray], max_targets: int):
    """Per-image (n_i, 5) label arrays -> padded (B, T, 5) float32 and a
    (B, T) bool mask, numpy; targets past max_targets are dropped."""
    B = len(label_list)
    out = np.zeros((B, max_targets, 5), np.float32)
    mask = np.zeros((B, max_targets), bool)
    for i, lab in enumerate(label_list):
        n = min(len(lab), max_targets)
        if n:
            out[i, :n] = lab[:n]
            mask[i, :n] = True
    return out, mask
