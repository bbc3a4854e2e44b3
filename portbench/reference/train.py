"""Plain float32 PyTorch reference of the detector's train step: the YOLOv5
loss (ultralytics utils/loss.py ComputeLoss, over fixed-shape padded
targets), three-group nesterov SGD with the per-step warmup (train.py),
and the model EMA (utils/torch_utils.py ModelEMA), for ``reference/
model.py``'s model in train mode.

- loss: box 1 - CIoU over the assigned candidates (every offset, anchor
  and target with a validity mask, anchor ratio under ``anchor_t``),
  objectness BCE against the candidates' scatter-max IoU, class BCE;
  levels balanced [4, 1, 0.4]; gains box * 3 / nl, cls * nc / 80 * 3 / nl,
  obj * (imgsz / 640)^2 * 3 / nl; total times the batch;
- SGD: group 0 BatchNorm scales, positional embeddings and pooling blends
  (no decay), group 1 conv and linear weights and LayerNorm scales (decay
  scaled by total batch * accumulate / 64), group 2 biases and residual
  gains; lr and momentum warmed up linearly over max(warmup_epochs epochs,
  ``warmup_min_steps``) steps from 0 (groups 0, 1) or warmup_bias_lr
  (group 2); buf = mom * buf + g, p -= lr * (g + mom * buf);
- EMA: d = decay * (1 - exp(-updates / 2000)), e = d e + (1 - d) v over
  the parameters and BatchNorm statistics;
- dropout: p = 0.1 in the attention blocks, each mask drawn as a bf16
  bernoulli(0.9) tensor from one CUDA generator, seeded and drawn in the
  order that the measured package's Trainer documents (``Masks``).

This file imports torch and numpy alone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

BALANCE = (4.0, 1.0, 0.4)
OFFSETS = ((0, 0), (1, 0), (0, 1), (-1, 0), (0, -1))
G = 0.5


class Masks:
    """Dropout with p: each mask a bf16 bernoulli(1 - p) tensor of x's
    shape from one generator on x's device, seeded as the Trainer seeds its
    own: (seed mod 2^32) * 1000003 + step (0 at its build) + (rank << 40),
    mod 2^63."""

    def __init__(self, seed: int, device, p: float = 0.1):
        self.p = p
        self.g = torch.Generator(torch.device(device))
        key = int(seed) & 0xFFFFFFFF
        self.g.manual_seed((key * 1_000_003) % 2 ** 63)

    def __call__(self, x):
        keep = torch.empty(x.shape, dtype=torch.bfloat16,
                           device=x.device).bernoulli_(1 - self.p,
                                                       generator=self.g)
        return x * keep.to(x.dtype) / (1 - self.p)


def fp8(x):
    """float8 e4m3 with a per-tensor scale (absmax at 448), the gradient
    passed straight through."""
    s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x).detach()


def ciou(b1, b2, eps=1e-7):
    """CIoU of xywh boxes, the height's eps asymmetric as ultralytics has
    it; alpha carries no gradient."""
    b1x1, b1x2 = b1[..., 0] - b1[..., 2] / 2, b1[..., 0] + b1[..., 2] / 2
    b1y1, b1y2 = b1[..., 1] - b1[..., 3] / 2, b1[..., 1] + b1[..., 3] / 2
    b2x1, b2x2 = b2[..., 0] - b2[..., 2] / 2, b2[..., 0] + b2[..., 2] / 2
    b2y1, b2y2 = b2[..., 1] - b2[..., 3] / 2, b2[..., 1] + b2[..., 3] / 2
    inter = ((torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1))
             .clamp(min=0) * (torch.minimum(b1y2, b2y2)
                              - torch.maximum(b1y1, b2y1)).clamp(min=0))
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2
            + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + v * alpha)


def bce(logits, t):
    return -(t * F.logsigmoid(logits) + (1 - t) * F.logsigmoid(-logits))


def yolo_loss(maps: Sequence[torch.Tensor], targets, mask, anchors_grid,
              hyp: dict, nc: int, imgsz: int) -> torch.Tensor:
    """maps: nl tensors (B, ny, nx, na, 5 + nc); targets (B, T, 5) of (cls,
    x, y, w, h) normalised, mask (B, T) bool; anchors_grid (nl, na, 2) in
    grid units. The total loss (a scalar, float32)."""
    nl = len(maps)
    box_g = hyp["box"] * 3.0 / nl
    cls_g = hyp["cls"] * nc / 80.0 * 3.0 / nl
    obj_g = hyp["obj"] * (imgsz / 640.0) ** 2 * 3.0 / nl
    B, T, _ = targets.shape
    dev = targets.device
    t = targets.reshape(B * T, 5).float()
    m = mask.reshape(B * T)
    b_idx = torch.arange(B, device=dev).repeat_interleave(T)
    offs = torch.tensor(OFFSETS, dtype=torch.float32, device=dev) * G
    lbox = lobj = lcls = torch.zeros((), device=dev)
    for i, p in enumerate(maps):
        p = p.float()
        _, ny, nx, na, no = p.shape
        anc = torch.as_tensor(np.asarray(anchors_grid[i], np.float32),
                              device=dev)
        gxy = torch.stack([t[:, 1] * nx, t[:, 2] * ny], -1)
        gwh = torch.stack([t[:, 3] * nx, t[:, 4] * ny], -1)
        r = gwh[None] / anc[:, None]
        ok_am = (torch.maximum(r, 1 / r).amax(-1) < hyp["anchor_t"]) & m[None]
        gxi = torch.stack([nx - gxy[:, 0], ny - gxy[:, 1]], -1)
        jk = (torch.remainder(gxy, 1.0) < G) & (gxy > 1.0)
        lm = (torch.remainder(gxi, 1.0) < G) & (gxi > 1.0)
        ok_off = torch.stack([torch.ones_like(m), jk[:, 0], jk[:, 1],
                              lm[:, 0], lm[:, 1]])
        gij = torch.floor(gxy[None] - offs[:, None])
        gi, gj = gij[..., 0].clamp(0, nx - 1), gij[..., 1].clamp(0, ny - 1)
        txy = gxy[None] - torch.stack([gi, gj], -1)
        shape = (5, na, B * T)
        b = b_idx[None, None].expand(shape).reshape(-1)
        a = torch.arange(na, device=dev)[None, :, None].expand(shape) \
            .reshape(-1)
        cj = gj[:, None].expand(shape).reshape(-1).long()
        ci = gi[:, None].expand(shape).reshape(-1).long()
        ctxy = txy[:, None].expand(shape + (2,)).reshape(-1, 2)
        ctwh = gwh[None, None].expand(shape + (2,)).reshape(-1, 2)
        canc = anc[None, :, None].expand(shape + (2,)).reshape(-1, 2)
        ccls = t[:, 0].long()[None, None].expand(shape).reshape(-1)
        valid = (ok_off[:, None] & ok_am[None]).reshape(-1)
        flat = ((b * ny + cj) * nx + ci) * na + a
        ps = p.reshape(-1, no)[flat]
        pxy = torch.sigmoid(ps[:, 0:2]) * 2.0 - 0.5
        pwh = (torch.sigmoid(ps[:, 2:4]) * 2.0) ** 2 * canc
        iou = ciou(torch.cat([pxy, pwh], -1), torch.cat([ctxy, ctwh], -1))
        n_valid = valid.sum().float().clamp(min=1.0)
        lbox = lbox + torch.where(valid, 1.0 - iou, 0.0).sum() / n_valid
        tval = torch.where(valid, iou.detach().clamp(min=0.0), 0.0)
        tobj = torch.zeros(B * ny * nx * na, device=dev).scatter_reduce(
            0, flat, tval, reduce="amax", include_self=True)
        lobj = lobj + bce(p[..., 4].reshape(-1), tobj).mean() * BALANCE[i]
        if nc > 1:
            tcls = F.one_hot(ccls, nc).float()
            lc = torch.where(valid[:, None], bce(ps[:, 5:], tcls), 0.0)
            lcls = lcls + lc.sum() / (n_valid * nc)
    return (lbox * box_g + lobj * obj_g + lcls * cls_g) * B


def param_group(name: str) -> int:
    """0: BatchNorm scales, positional embeddings, pooling blends (no
    decay); 2: biases and residual gains; 1: the rest (decay)."""
    last = name.rsplit(".", 1)[-1]
    if last == "bias" or last == "coefficients":
        return 2
    if name.endswith(".bn.weight") or last in ("pos_emb_vis", "pos_emb_ir",
                                                "w1", "w2"):
        return 0
    return 1


class SGD:
    """The three-group nesterov SGD with the one-cycle lr and the warmup."""

    def __init__(self, hyp: dict, epochs: int, steps_per_epoch: int,
                 total_batch: int, warmup_min_steps: int = 1000,
                 nbs: int = 64):
        self.hyp, self.epochs, self.spe = hyp, epochs, steps_per_epoch
        accumulate = max(round(nbs / total_batch), 1)
        self.wd = hyp["weight_decay"] * total_batch * accumulate / nbs
        self.warmup = max(round(hyp["warmup_epochs"] * steps_per_epoch),
                          warmup_min_steps)
        self.step_n = 0
        self.buf: Dict[str, torch.Tensor] = {}

    def schedule(self, step: int):
        h, f = self.hyp, np.float32
        e = np.floor(f(step) / f(self.spe))
        lf = ((f(1) - np.cos(e * f(math.pi) / f(self.epochs))) / f(2)
              * f(h["lrf"] - 1) + f(1))
        base = f(h["lr0"]) * lf
        if step < self.warmup:
            x = np.clip(f(step) / f(self.warmup), f(0), f(1))
            lrs = [f(s) + x * (base - f(s))
                   for s in (0.0, 0.0, h["warmup_bias_lr"])]
            mom = f(h["warmup_momentum"]) + x * f(h["momentum"]
                                                  - h["warmup_momentum"])
        else:
            lrs, mom = [base] * 3, f(h["momentum"])
        return [float(v) for v in lrs], float(mom)

    def decayed(self, params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each gradient as the update takes it: with decay in group 1."""
        return {k: grads[k] + self.wd * params[k].detach()
                if param_group(k) == 1 else grads[k] for k in params}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor]) -> None:
        lrs, mom = self.schedule(self.step_n)
        for k, g in self.decayed(params, grads).items():
            b = self.buf.get(k)
            b = g.clone() if b is None else b.mul_(mom).add_(g)
            self.buf[k] = b
            params[k].sub_(lrs[param_group(k)] * (g + mom * b))
        self.step_n += 1


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor],
               updates: int, decay: float = 0.9999) -> None:
    d = decay * (1 - math.exp(-updates / 2000))
    for k, e in ema.items():
        e.mul_(d).add_(state[k].detach().float(), alpha=1 - d)


def level_maps(logits: List[torch.Tensor], na: int, no: int):
    return [t.view(t.shape[0], na, no, t.shape[2], t.shape[3])
            .permute(0, 3, 4, 1, 2) for t in logits]


def run_steps(model, batches, hyp: dict, nc: int, imgsz: int, anchors_grid,
              sgd: SGD, accum: int, seed: int, fq=None,
              ema_decay: float = 0.9999) -> List[dict]:
    """``len(batches)`` train steps of ``model`` (in place) on batches of
    (rgb, ir, targets, mask), each ``accum`` microbatches whose gradients
    are summed. Returns per step {"loss"}, with "grad" (the gradients as
    the update took them) and "grad_norm" (their norms before the decay)
    after the first step, "params" and "ema" after the last. BatchNorm momentum 0.03, statistics of each microbatch;
    ``fq``: the products' rounding (the control)."""
    for bn in model.modules():
        if isinstance(bn, torch.nn.BatchNorm2d):
            bn.momentum = 0.03
    model.train()
    model.set_drop(Masks(seed, next(model.parameters()).device))
    model.fake_quant(fq)
    params = dict(model.named_parameters())
    state = {k: v for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    ema = {k: v.detach().float().clone() for k, v in state.items()}
    det = model.get_submodule(f"m{model.rows[-1][0]}")
    out = []
    for s, (rgb, ir, tg, mk) in enumerate(batches):
        for p in params.values():
            p.grad = None
        total = 0.0
        for r, i, t, m in zip(*(x.chunk(accum) for x in (rgb, ir, tg, mk))):
            _, logits = model(r, i)
            loss = yolo_loss(level_maps(logits, det.na, det.no), t, m,
                             anchors_grid, hyp, nc, imgsz)
            loss.backward()
            total += float(loss.detach())
            del logits, loss
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in params.items()}
        rec = {"loss": total / accum}
        if s == 0:
            rec["grad"] = {k: v.clone() for k, v in
                           sgd.decayed(params, grads).items()}
            rec["grad_norm"] = {k: float(v.double().norm())
                                for k, v in grads.items()}
        sgd.update(params, grads)
        ema_update(ema, state, s + 1, ema_decay)
        out.append(rec)
    for p in params.values():
        p.grad = None
    out[-1]["params"] = {k: v.detach().clone() for k, v in params.items()}
    out[-1]["ema"] = ema
    model.set_drop(None)
    model.fake_quant(None)
    return out
