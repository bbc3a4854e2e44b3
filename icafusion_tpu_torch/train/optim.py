"""The reference's optimizers: three-group SGD (nesterov) or Adam, with the
one-cycle or linear schedule and the per-iteration warmup.

Counterpart of the JAX package's train/optim.py (reference
train.py:123-155, :314-323):

- group 0: BatchNorm scales, and the parameters the reference never routes
  (pos_emb_*, w1/w2): no weight decay;
- group 1: conv and dense kernels, LayerNorm scales: weight decay;
- group 2: biases and the residual gains (``coefficients``): no decay, own
  warmup start (warmup_bias_lr);
- weight decay pre-scaled by total_batch * accumulate / nbs;
- lr factor per epoch: one-cycle cosine or linear to lrf;
- warmup over max(warmup_epochs epochs, warmup_min_steps iterations): each
  group's lr and the momentum interpolated per iteration.

Groups and freezing are decided on each parameter's flax path
(utils/convert.flax_paths), never on torch names: a LayerNorm ``weight`` is
group 1 and a BatchNorm ``weight`` group 0, though torch names them alike.
A frozen parameter gets neither decay nor update. The schedule is computed
on the host in float32, as the JAX package computes it on the device; the
updates run as torch._foreach ops over each group, in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from icafusion_tpu_torch.config import HypConfig

Path = Tuple[str, ...]
_F = np.float32


def _path_str(path: Path) -> str:
    return "/".join(path)


def _is_bias(path: Path) -> bool:
    return path[-1] == "bias"


def _is_bn_scale(path: Path) -> bool:
    """BatchNorm scales live under .../bn*/scale; LayerNorm scales do not."""
    return path[-1] == "scale" and "bn" in path[-2]


def _is_frozen(path: Path, freeze: Tuple[str, ...]) -> bool:
    """The reference's freeze hook (train.py:115-120) on the slash-joined
    flax path with a leading slash: a bare entry matches anywhere
    (substring), an entry with a leading slash must match from the start.
    So '/m2' also freezes '/m23/...', as in the JAX package."""
    if not freeze:
        return False
    k = "/" + _path_str(path)
    return any(k.startswith(x) if x.startswith("/") else x in k
               for x in freeze)


def _is_unrouted(path: Path) -> bool:
    """Parameters the reference's optimizer never sees."""
    return path[-1] in ("pos_emb_vis", "pos_emb_ir", "w1", "w2")


def param_group(path: Path) -> int:
    """0 = BN scale (no decay), 1 = kernels (decay), 2 = biases (no decay,
    warmup bias lr)."""
    if path[-1] == "coefficients" or _is_bias(path):
        return 2
    if _is_bn_scale(path) or _is_unrouted(path):
        return 0
    return 1


@dataclasses.dataclass
class OptState:
    """Optimizer buffers by state-dict name (SGD: the momentum; Adam:
    {"m": ..., "v": ...}) and the count of optimizer steps taken."""
    momentum: Dict
    step: int = 0


@dataclasses.dataclass(frozen=True)
class YoloSGD:
    """torch SGD(nesterov) with the reference's groups and schedule."""
    hyp: HypConfig
    epochs: int
    steps_per_epoch: int
    total_batch_size: int          # batch * accumulate
    nbs: int = 64                  # nominal batch size (train.py:123)
    linear_lr: bool = False
    freeze_unrouted: bool = False
    freeze: Tuple[str, ...] = ()
    warmup_min_steps: int = 1000   # the reference's floor (train.py:264)

    @property
    def weight_decay(self) -> float:
        accumulate = max(round(self.nbs / self.total_batch_size), 1)
        return (self.hyp.weight_decay * self.total_batch_size * accumulate
                / self.nbs)

    @property
    def warmup_steps(self) -> int:
        return max(round(self.hyp.warmup_epochs * self.steps_per_epoch),
                   self.warmup_min_steps)

    def lr_factor(self, epoch) -> np.float32:
        """lf(epoch) of the reference's scheduler (train.py:148-152)."""
        e, lrf = _F(epoch), self.hyp.lrf
        if self.linear_lr:
            return ((_F(1) - e / _F(max(self.epochs - 1, 1)))
                    * _F(1.0 - lrf) + _F(lrf))
        return ((_F(1) - np.cos(e * _F(math.pi) / _F(self.epochs))) / _F(2)
                * _F(lrf - 1) + _F(1))

    def schedules(self, step: int):
        """((lr of groups 0, 1, 2), momentum) at optimizer step ``step``,
        as python floats computed in float32."""
        h = self.hyp
        s = _F(step)
        base_lr = _F(h.lr0) * self.lr_factor(np.floor(
            s / _F(self.steps_per_epoch)))
        nw = _F(self.warmup_steps)
        t = np.clip(s / nw, _F(0), _F(1))
        if s < nw:
            warm = lambda start: _F(start) + t * (base_lr - _F(start))
            lrs = (warm(0.0), warm(0.0), warm(h.warmup_bias_lr))
            mom = _F(h.warmup_momentum) + t * _F(h.momentum
                                                 - h.warmup_momentum)
        else:
            lrs, mom = (base_lr,) * 3, _F(h.momentum)
        return tuple(float(x) for x in lrs), float(mom)

    def _skip(self, path: Path) -> bool:
        return ((self.freeze_unrouted and _is_unrouted(path))
                or _is_frozen(path, self.freeze))

    def _groups(self, params: Mapping[str, torch.Tensor], grads,
                paths: Mapping[str, Path]) -> Dict[int, List]:
        """Group -> [(name, param, fp32 grad with decay)] of the params that
        are not frozen; a missing gradient counts as zero."""
        out: Dict[int, List] = {0: [], 1: [], 2: []}
        for name, p in params.items():
            path = paths[name]
            if self._skip(path):
                continue
            g = grads.get(name)
            g = torch.zeros_like(p) if g is None else g.float()
            out[param_group(path)].append((name, p, g))
        wd = self.weight_decay
        if out[1]:
            decayed = torch._foreach_add([g for _, _, g in out[1]],
                                         [p.detach() for _, p, _ in out[1]],
                                         alpha=wd)
            out[1] = [(n, p, g) for (n, p, _), g in zip(out[1], decayed)]
        return out

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        return OptState(momentum={k: torch.zeros_like(v, dtype=torch.float32)
                                  for k, v in params.items()})

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor], grads: Mapping,
               state: OptState, paths: Mapping[str, Path]) -> OptState:
        """One nesterov step: buf = mom * buf + g; p -= lr * (g + mom * buf).
        ``params`` are updated in place, and so are the buffers."""
        lrs, mom = self.schedules(state.step)
        for grp, items in self._groups(params, grads, paths).items():
            if not items:
                continue
            ps = [p for _, p, _ in items]
            gs = [g for _, _, g in items]
            bufs = [state.momentum[n] for n, _, _ in items]
            torch._foreach_mul_(bufs, mom)
            torch._foreach_add_(bufs, gs)
            d = torch._foreach_add(gs, bufs, alpha=mom)
            torch._foreach_add_(ps, d, alpha=-lrs[grp])
        state.step += 1
        return state


@dataclasses.dataclass(frozen=True)
class YoloAdam(YoloSGD):
    """The reference's --adam (train.py:128-146): torch Adam with betas
    (hyp.momentum, 0.999), eps 1e-8, decay added to the gradient of group
    1, the same lr warmup; no momentum warmup (Adam groups carry none)."""

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        zeros = lambda: {k: torch.zeros_like(v, dtype=torch.float32)
                         for k, v in params.items()}
        return OptState(momentum={"m": zeros(), "v": zeros()})

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor], grads: Mapping,
               state: OptState, paths: Mapping[str, Path]) -> OptState:
        lrs, _ = self.schedules(state.step)
        b1, b2, eps = self.hyp.momentum, 0.999, 1e-8
        t = _F(state.step + 1)
        bc1, bc2 = float(_F(1) - _F(b1) ** t), float(_F(1) - _F(b2) ** t)
        for grp, items in self._groups(params, grads, paths).items():
            if not items:
                continue
            ps = [p for _, p, _ in items]
            gs = [g for _, _, g in items]
            ms = [state.momentum["m"][n] for n, _, _ in items]
            vs = [state.momentum["v"][n] for n, _, _ in items]
            torch._foreach_mul_(ms, float(_F(b1)))
            torch._foreach_add_(ms, gs, alpha=float(_F(1.0 - b1)))
            torch._foreach_mul_(vs, float(_F(b2)))
            torch._foreach_add_(vs, torch._foreach_mul(gs, gs),
                                alpha=float(_F(1.0 - b2)))
            den = torch._foreach_div(vs, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            num = torch._foreach_div(ms, bc1)
            torch._foreach_mul_(num, lrs[grp])
            torch._foreach_div_(num, den)
            torch._foreach_sub_(ps, num)
        state.step += 1
        return state
