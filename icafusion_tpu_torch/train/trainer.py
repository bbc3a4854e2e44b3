"""The train step and its state: forward (optionally bf16 autocast over
float32 parameters) -> YoloLoss -> backward -> three-group SGD or Adam ->
EMA.

Counterpart of the JAX package's train/trainer.py (reference
train.py:263-366):

- AMP/GradScaler -> bf16 autocast over float32 parameters and gradients
  (no scaler needed for bf16); LayerNorm, BatchNorm statistics and the loss
  stay float32;
- gradient accumulation to a nominal batch -> ``accum_steps``
  microbatches whose gradients are summed before one optimizer step, the
  BatchNorm statistics updated in sequence;
- ModelEMA after each optimizer step;
- the loss gains rescaled by nl, nc and imgsz (``scaled_gains``);
- data parallel over a process group (parallel/mesh.py): each rank holds
  its share of every microbatch, BatchNorm and the loss's normalisers are
  global, and after the last microbatch's backward the gradients and the
  metrics are summed across the ranks in one all-reduce (a sum: each
  share already carries the global normalisers), so every rank takes the
  same optimizer and EMA step and the state stays equal across them.
  ``batch_size`` is then the global microbatch.

The Trainer owns the state: the model on its device in train mode, the
optimizer buffers, the EMA shadow, and the torch.Generator its dropout
draws from, seeded from (seed, step, rank): the JAX package draws one mask
over the global batch, so runs with dropout on differ from it by design.
It runs on CUDA unless the CPU is asked for.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from icafusion_tpu_torch.config import HypConfig
from icafusion_tpu_torch.models.assembler import (ICAFusionModel,
                                                  anchors_grid_units,
                                                  model_strides)
from icafusion_tpu_torch.nn.fusion import Dropout, resize_linear
from icafusion_tpu_torch.parallel.mesh import rank, world
from icafusion_tpu_torch.train.ema import ema_init, ema_update, ema_variables
from icafusion_tpu_torch.train.loss import YoloLoss
from icafusion_tpu_torch.train.optim import YoloAdam, YoloSGD
from icafusion_tpu_torch.utils.convert import flax_paths
from icafusion_tpu_torch.utils.general import resolve_device
from icafusion_tpu_torch.utils.profiling import span


def scaled_size(v: int, scale: float) -> int:
    """Multi-scale size: round(v * scale) on the stride-32 grid
    (train.py:327-329)."""
    return max(round(v * scale / 32), 1) * 32


def scaled_gains(hyp: HypConfig, nc: int, nl: int,
                 imgsz: int) -> Tuple[float, float, float]:
    """box/obj/cls gain rescale (train.py:238-241)."""
    box = hyp.box * 3.0 / nl
    cls = hyp.cls * nc / 80.0 * 3.0 / nl
    obj = hyp.obj * (imgsz / 640.0) ** 2 * 3.0 / nl
    return box, obj, cls


@dataclasses.dataclass
class Trainer:
    model: ICAFusionModel
    hyp: HypConfig
    epochs: int
    steps_per_epoch: int
    batch_size: int                 # images per (global) microbatch
    imgsz: int = 640
    accum_steps: int = 1
    ema_decay: float = 0.9999
    warmup_min_steps: int = 1000
    adam: bool = False              # reference --adam (train.py:128-146)
    linear_lr: bool = False         # reference --linear-lr
    freeze: tuple = ()              # substring freeze (train.py:115-120)
    bf16: bool = False              # autocast the forward to bfloat16
    device: Optional[str] = None    # None: CUDA, raising without it
    seed: int = 0                   # of the dropout generator

    def __post_init__(self):
        self.device = resolve_device(self.device, "Trainer")
        cfg = self.model.cfg
        box, obj, cls = scaled_gains(self.hyp, cfg.nc, cfg.nl, self.imgsz)
        self.loss_fn = YoloLoss(hyp=self.hyp, nc=cfg.nc,
                                anchors=anchors_grid_units(cfg),
                                strides=model_strides(cfg), box_gain=box,
                                obj_gain=obj, cls_gain=cls)
        opt_cls = YoloAdam if self.adam else YoloSGD
        self.optimizer = opt_cls(
            hyp=self.hyp, epochs=self.epochs,
            steps_per_epoch=self.steps_per_epoch,
            total_batch_size=self.batch_size * self.accum_steps,
            warmup_min_steps=self.warmup_min_steps,
            linear_lr=self.linear_lr, freeze=tuple(self.freeze))
        self.model = self.model.to(self.device).train()
        self.paths = {k: p for k, (c, p) in flax_paths(self.model).items()
                      if c == "params"}
        self.params = dict(self.model.named_parameters())
        self.opt = self.optimizer.init(self.params)
        self.ema = ema_init(ema_variables(self.model))
        # the JAX key's layout, so checkpoints cross: [0, seed]
        self.rng = np.array([0, self.seed & 0xFFFFFFFF], np.uint32)
        self.generator = torch.Generator(self.device)
        self.reseed()

    def reseed(self):
        """Seed the dropout generator from (rng, optimizer step, rank) and
        hand it to every Dropout of the model."""
        key = int(self.rng[0]) << 32 | int(self.rng[1])
        self.generator.manual_seed((key * 1_000_003 + self.opt.step
                                    + (rank() << 40)) % 2 ** 63)
        for m in self.model.modules():
            if isinstance(m, Dropout):
                m.generator = self.generator

    def _forward_loss(self, rgb, ir, targets, mask):
        with span("train.forward"), torch.autocast(
                self.device.type, dtype=torch.bfloat16, enabled=self.bf16):
            preds = self.model(rgb, ir)
        with span("train.loss"):
            return self.loss_fn(preds, targets, mask)

    def _all_reduce(self, grads: dict, *metrics):
        """Sum the gradients and the metrics over the process group in one
        flat all-reduce, in place."""
        flat = torch.cat([g.reshape(-1) for g in grads.values()]
                         + [m.reshape(-1) for m in metrics])
        torch.distributed.all_reduce(flat)
        i = 0
        for t in list(grads.values()) + list(metrics):
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()

    def make_train_step(self, scale: float = 1.0,
                        grad_mask=None) -> Callable:
        """step(rgb, ir, targets, mask) -> metrics, the state updated in
        place. rgb/ir: (A*B, 3, H, W) float in [0, 1] on the device;
        targets (A*B, T, 5); mask (A*B, T), A = accum_steps; under a
        process group, this rank's rows of each microbatch in turn
        (parallel/mesh.process_rows). Metrics are tensors on the device
        (loss, lbox, lobj, lcls: the global batch's) and the group-1 lr of
        this step.

        scale != 1 resizes the batch to round(H * scale / 32) * 32 before
        the forward (jax.image.resize 'linear', antialiased).

        grad_mask: {parameter name: 0/1 tensor} (utils/stream_merge.
        grad_mask), multiplied into those gradients after the ranks' sum
        and before the optimizer, so that the zero blocks of a
        stream-merged model stay exactly 0.

        Its stages are ``span``s (utils/profiling.py): ``train.step``
        around it, ``train.forward``, ``train.loss`` and ``train.backward``
        a microbatch, then ``train.optimizer`` and ``train.ema``."""
        A = self.accum_steps
        masks = list((grad_mask or {}).items())
        unknown = sorted(k for k, _ in masks if k not in self.params)
        if unknown:
            raise KeyError(f"grad_mask names no parameter: {unknown[:5]}")

        def resize(x):
            if scale == 1.0:
                return x
            return resize_linear(x, scaled_size(x.shape[2], scale),
                                 scaled_size(x.shape[3], scale))

        def step(rgb, ir, targets, mask):
            with span("train.step"):
                self.model.train()
                for p in self.params.values():
                    p.grad = None
                lr = self.optimizer.schedules(self.opt.step)[0][1]
                loss_sum = torch.zeros((), device=self.device)
                items_sum = torch.zeros(4, device=self.device)
                for r, i, t, m in zip(*(x.chunk(A) for x in
                                        (rgb, ir, targets, mask))):
                    loss, items = self._forward_loss(resize(r), resize(i),
                                                     t, m)
                    with span("train.backward"):
                        loss.backward()
                    loss_sum += loss.detach()
                    items_sum += items.detach()
                with span("train.optimizer"):
                    grads = {k: torch.zeros_like(p) if p.grad is None
                             else p.grad for k, p in self.params.items()}
                    if world() > 1:
                        self._all_reduce(grads, loss_sum, items_sum)
                    for k, m in masks:
                        grads[k].mul_(m)
                    self.optimizer.update(self.params, grads, self.opt,
                                          self.paths)
                with span("train.ema"):
                    ema_update(self.ema, ema_variables(self.model),
                               self.ema_decay)
                loss, items = loss_sum / A, items_sum / A
                return {"loss": loss, "lbox": items[0], "lobj": items[1],
                        "lcls": items[2], "lr": lr}

        return step
