"""Training: a closed loop of the measured package's ``Trainer`` steps on
pre-letterboxed pairs of the pool with their boxes as targets, ``batch``
images a microbatch, ``accum_steps`` microbatches a step, bf16 autocast
over float32 parameters where the configuration says bf16.

Set-up builds the one Trainer, collates the pool on the device once (the
pool holds ``checked_steps`` x ``batch`` x ``accum_steps`` pairs in a
seed-drawn order, so the checked steps' rows all differ) and drives it
through its first ``checked_steps`` steps by the window's own call and
feed, keeping what the check compares: each step's loss, the momentum
buffers after the first step (buf = g: the gradients as the optimizer got
them) and the parameters and EMA after the last. These steps warm every
shape up. The window then goes on stepping, round the same batches.

Workload keys: ``batch``, ``accum_steps``, ``pool``, ``checked_steps``,
``max_targets`` (boxes a pair padded to). End-to-end:
``train_images_per_s``, the images stepped over the window's wall time
(the card synchronised at its end).

The check (after the Trainer is freed) runs ``reference/train.py`` over
the same steps in float32 with TF32 off, from the same state dict, with
the dropout masks drawn again from the Trainer's documented seed, and
compares by the worst leaf (``train_numbers``). The control is that
reference with its products rounded to fp8, in the program's place.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.autograd.profiler import record_function

from portbench.core import serving as S
from portbench.core.inputs import ORDER_STREAM, rng
from portbench.reference import train as reft


@dataclasses.dataclass
class State:
    inputs: Any
    batches: List[tuple]
    trainer: Any = None
    step: Any = None
    snap: Dict[str, Any] = dataclasses.field(default_factory=dict)
    steps: int = 0


def served_model(state):
    return state.trainer.model


def collate(ctx, inputs) -> List[tuple]:
    """The pool on the device as (rgb, ir, targets, mask) step batches of
    ``batch * accum_steps`` pairs, float images in [0, 1], in a seed-drawn
    order."""
    spec = ctx.spec
    n = int(spec["batch"]) * int(spec["accum_steps"])
    T = int(spec["max_targets"])
    perm = rng(ctx.seed, ORDER_STREAM).permutation(len(inputs.rgb))
    out = []
    for s in range(0, len(perm) - n + 1, n):
        idx = perm[s:s + n]
        tg = np.zeros((n, T, 5), np.float32)
        mk = np.zeros((n, T), bool)
        for j, p in enumerate(idx):
            lab = inputs.labels[p][:T]
            tg[j, :len(lab)], mk[j, :len(lab)] = lab, True
        out.append((S.to_nchw(inputs.rgb[idx], ctx.device),
                    S.to_nchw(inputs.ir[idx], ctx.device),
                    torch.from_numpy(tg).to(ctx.device),
                    torch.from_numpy(mk).to(ctx.device)))
    return out


def build_trainer(ctx, inputs):
    from icafusion_tpu_torch.config import HypConfig, load_model_config
    from icafusion_tpu_torch.models.assembler import ICAFusionModel
    from icafusion_tpu_torch.train.trainer import Trainer
    cfg, spec = ctx.config, ctx.spec
    dev = torch.device(ctx.device)
    with torch.device(dev):
        model = ICAFusionModel(load_model_config(cfg["model"]))
    model.load_state_dict(inputs.state, strict=True)
    return Trainer(model, HypConfig(**cfg["hyp"]),
                   epochs=int(cfg["train"]["epochs"]),
                   steps_per_epoch=int(cfg["train"]["steps_per_epoch"]),
                   batch_size=int(spec["batch"]),
                   imgsz=int(max(cfg["canvas"])),
                   accum_steps=int(spec["accum_steps"]),
                   ema_decay=float(cfg["train"]["ema_decay"]),
                   bf16=cfg["precision"] == "bf16", device=str(dev),
                   seed=ctx.seed)


def one_step(st: State) -> dict:
    """The window's call: the Trainer's step on the next batch."""
    b = st.batches[st.steps % len(st.batches)]
    with record_function("portbench.call"):
        out = st.step(*b)
    st.steps += 1
    return out


def setup(ctx) -> State:
    spec = ctx.spec
    inputs = S.Inputs(ctx.config, ctx.seed, int(spec["pool"]), ctx.device)
    st = State(inputs, collate(ctx, inputs))
    k = int(spec["checked_steps"])
    if ctx.control:
        st.snap = reference_steps(ctx, st, fq=reft.fp8)
        return st
    st.trainer = build_trainer(ctx, inputs)
    st.step = st.trainer.make_train_step()
    losses = []
    for s in range(k):
        losses.append(one_step(st)["loss"])
        if s == 0:
            st.snap["grad"] = {n: v.clone() for n, v in
                               st.trainer.opt.momentum.items()}
    st.snap["loss"] = [float(x) for x in losses]
    st.snap["params"] = {n: v.detach().clone()
                         for n, v in st.trainer.params.items()}
    st.snap["ema"] = {n: v.clone() for n, v in st.trainer.ema.tree.items()}
    return st


def window(ctx, st: State, seconds: float) -> dict:
    n = int(ctx.spec["batch"]) * int(ctx.spec["accum_steps"])
    if st.trainer is None:                  # the control: no window
        return {"metrics": {}, "attempted": 0, "failed": 0}
    steps = failed = 0
    last = None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        try:
            last = one_step(st)["loss"]
        except Exception as e:  # noqa: BLE001 - counted, reported below
            failed += n
            print(f"step {st.steps} failed: {e!r}", file=sys.stderr)
        steps += 1
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    if last is not None and not bool(torch.isfinite(last)):
        failed += n
    return {"metrics": {"train_images_per_s": (steps * n - failed)
                        / (t1 - t0)},
            "attempted": steps * n, "failed": failed, "steps": steps,
            "seconds": t1 - t0}


def reference_steps(ctx, st: State, fq=None) -> Dict[str, Any]:
    """The plain reference's checked steps from the run's state dict."""
    cfg, spec = ctx.config, ctx.spec
    k = int(spec["checked_steps"])
    ref = S.reference_model(cfg, st.inputs.state, ctx.device)
    det = ref.get_submodule(f"m{ref.rows[-1][0]}")
    anchors = det.anchors_px / np.asarray(det.strides,
                                          np.float32).reshape(-1, 1, 1)
    n = int(spec["batch"]) * int(spec["accum_steps"])
    sgd = reft.SGD(cfg["hyp"], int(cfg["train"]["epochs"]),
                   int(cfg["train"]["steps_per_epoch"]), n)
    with S.tf32_off():
        recs = reft.run_steps(ref, st.batches[:k], cfg["hyp"],
                              int(cfg["model"]["nc"]), int(max(cfg["canvas"])),
                              anchors, sgd, int(spec["accum_steps"]),
                              ctx.seed, fq=fq,
                              ema_decay=float(cfg["train"]["ema_decay"]))
    out = {"loss": [r["loss"] for r in recs], "grad": recs[0]["grad"],
           "grad_norm": recs[0]["grad_norm"], "params": recs[-1]["params"],
           "ema": recs[-1]["ema"]}
    del ref, recs
    gc.collect()
    return out


def check(ctx, st: State) -> dict:
    st.trainer = st.step = None
    gc.collect()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(ctx, st)
    return S.judge(ctx.config, train_numbers(st.snap, ref, st.inputs.state))


def leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             base: Optional[Dict[str, torch.Tensor]], keep) -> tuple:
    """(worst gap, its leaf, the median leaf's gap): over the leaves in
    ``keep``, |norm(got - base) - norm(want - base)| over the larger of
    norm(want - base) and the median leaf's; no base: the norms of the
    tensors themselves."""
    def norm(d, k):
        x = d[k].double()
        return float((x - base[k].double()).norm() if base else x.norm())

    w = {k: norm(want, k) for k in keep}
    med = float(np.median(list(w.values())))
    gaps = {k: abs(norm(got, k) - w[k]) / max(w[k], med, 1e-30)
            for k in keep}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst, float(np.median(list(gaps.values())))


def train_numbers(prog: Dict[str, Any], ref: Dict[str, Any],
                  state0: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The compared numbers: ``loss_gap``, the largest relative gap of a
    checked step's loss; ``grad_gap``, ``change_gap`` and ``ema_gap``, the
    worst leaf's gap of the first step's gradient (as the optimizer got
    it), of the parameters' change over the checked steps, and of the EMA's
    change (parameters and BatchNorm statistics). Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out of the three."""
    gn = ref["grad_norm"]
    med = float(np.median(list(gn.values())))
    keep = [k for k in ref["params"] if gn[k] >= 1e-3 * med]
    ema_keep = keep + [k for k in ref["ema"] if k not in ref["params"]]
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog["loss"], ref["loss"]))
    g, gk, gm = leaf_gap(prog["grad"], ref["grad"], None, keep)
    c, ck, cm = leaf_gap(prog["params"], ref["params"], state0, keep)
    e, ek, em = leaf_gap(prog["ema"], ref["ema"], state0, ema_keep)
    return {"loss_gap": loss_gap, "grad_gap": g, "change_gap": c,
            "ema_gap": e, "grad_gap_median": gm, "change_gap_median": cm,
            "ema_gap_median": em,
            "parts": {"loss": prog["loss"], "ref_loss": ref["loss"],
                      "grad_leaf": gk, "change_leaf": ck, "ema_leaf": ek,
                      "left_out": sorted(set(ref["params"]) - set(keep))}}
