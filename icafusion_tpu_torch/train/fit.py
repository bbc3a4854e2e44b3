"""The training loop, single process: the counterpart of the JAX
package's train/fit.py (reference train.py:42-490).

Config -> datasets and loaders -> anchor check -> model (init_weights, or
pretrained from a .ckpt) -> Trainer steps on the card -> per-epoch
evaluation of the EMA weights by the Evaluator (the port's three CUDA
kernels) -> results.csv -> last/best checkpoints in the JAX package's
format -> the stripped EMA checkpoint.

results.csv is the native 11-column row or the reference's 29-key row
(results_format="reference": val losses from the Evaluator's loss_fn on the
same eval forward); with kaist_ann each evaluation writes the MR txts and
the reference row gets the KAIST miss rates. The last evaluation draws the
PR/F1/P/R curves, and the run ends with results.png and the confusion
matrix, where matplotlib imports (else the plots are skipped and logged).

Not ported, and refused with the ROADMAP item named: distributed and
multi-device training, stream-merged training, a reference .pt as
pretrained weights. The label and batch plots and the TensorBoard facade
of the JAX fit are left out (they never gate a run there either).
"""

from __future__ import annotations

import csv
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from icafusion_tpu_torch.config import (DataConfig, HypConfig, ModelConfig,
                                        with_anchors)
from icafusion_tpu_torch.data.datasets import PairedDetectionDataset
from icafusion_tpu_torch.data.loader import PairedLoader
from icafusion_tpu_torch.eval.evaluator import Evaluator
from icafusion_tpu_torch.eval.kaist import evaluate_kaist
from icafusion_tpu_torch.eval.metrics import fitness
from icafusion_tpu_torch.models.assembler import (ICAFusionModel, build_model,
                                                  init_weights)
from icafusion_tpu_torch.train.optim import _is_frozen, _path_str
from icafusion_tpu_torch.train.trainer import Trainer, scaled_size
from icafusion_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  restore_train_state,
                                                  save_checkpoint,
                                                  strip_checkpoint,
                                                  wait_pending_saves)
from icafusion_tpu_torch.utils.convert import load_jax_variables
from icafusion_tpu_torch.utils.plots import plot_confusion_matrix, plot_results
from icafusion_tpu_torch.utils.general import (increment_path,
                                               labels_to_class_weights,
                                               not_ported, resolve_device)

RESULTS_HEADER = ["epoch", "lbox", "lobj", "lcls", "P", "R", "mAP50", "mAP",
                  "fitness", "lr", "time_s"]
# The reference's 29-key row (train.py:398-411), which its plot_results
# reads (plots.py:457-480); results_format="reference". The MR columns are
# zeros unless kaist_ann is set.
REFERENCE_RESULTS_KEYS = [
    "train/box_loss", "train/obj_loss", "train/cls_loss", "train/rank_loss",
    "TP", "FP", "FN", "F1", "metrics/precision", "metrics/recall",
    "metrics/mAP_0.5", "metrics/mAP_0.5:0.95",
    "val/box_loss", "val/obj_loss", "val/cls_loss", "val/rank_loss",
    "x/lr0", "x/lr1", "x/lr2",
    "MR_all", "MR_day", "MR_night", "MR_near", "MR_medium", "MR_far",
    "MR_none", "MR_partial", "MR_heavy", "Recall_all"]
MULTI_SCALES = (0.75, 0.875, 1.0, 1.125, 1.25)   # train.py:325-331 buckets


def viable_train_scales(cfg: ModelConfig, h: int, w: int, scales, log):
    """Drop the multi-scale sizes the model cannot run at: each is traced
    once in train mode on the meta device (no memory, no arithmetic). The
    1.0 size is never dropped: an error there is the run's own."""
    with torch.device("meta"):
        model = ICAFusionModel(cfg).train()
    keep = []
    for s in scales:
        if s == 1.0:
            keep.append(s)
            continue
        nh, nw = scaled_size(h, s), scaled_size(w, s)
        x = torch.zeros(1, 3, nh, nw, device="meta")
        try:
            with torch.no_grad():
                model(x, x)
            keep.append(s)
        except (RuntimeError, ValueError, IndexError) as e:
            reason = str(e).splitlines()[0] if str(e) else type(e).__name__
            log(f"multi-scale: dropping x{s} ({nh}x{nw}): {reason}")
    return tuple(keep)


class EpochMeter:
    """Running sums of the step losses on the device; means() copies them
    to the host once per epoch."""
    KEYS = ("lbox", "lobj", "lcls", "loss")

    def __init__(self):
        self.sums = None
        self.n = 0

    def add(self, metrics):
        s = torch.stack([metrics[k].detach().float() for k in self.KEYS])
        self.sums = s if self.sums is None else self.sums + s
        self.n += 1

    def means(self) -> np.ndarray:
        if self.sums is None:
            return np.zeros(len(self.KEYS))
        return self.sums.cpu().double().numpy() / max(self.n, 1)


@dataclasses.dataclass
class FitConfig:
    model_cfg: ModelConfig
    data_cfg: DataConfig
    hyp: HypConfig
    epochs: int = 60
    batch_size: int = 8
    imgsz: int = 640
    project: str = "runs/train"
    name: str = "exp"
    seed: int = 0
    bf16: bool = False
    max_targets: int = 128
    eval_every: int = 1
    save_every: int = 1                  # last.ckpt period (epochs)
    pretrained: Optional[str] = None     # a .ckpt (a reference .pt: A10)
    resume: Optional[str] = None
    n_devices: Optional[int] = None      # > 1: A8
    workers: int = 8
    warmup_min_steps: int = 1000         # the reference's floor
    autoanchor: bool = True
    image_weights: bool = False
    multi_scale: bool = False
    accum_steps: Optional[int] = None    # microbatches per optimizer step
    distributed: bool = False            # A8
    adam: bool = False
    merge_streams: int = 0               # A10
    linear_lr: bool = False
    freeze: tuple = ()
    single_cls: bool = False
    nosave: bool = False                 # checkpoints on the final epoch only
    notest: bool = False                 # evaluation on the final epoch only
    results_format: str = "native"       # or "reference", the 29-key row
    kaist_ann: Optional[str] = None      # KAIST annotation json: MR columns
    device: Optional[str] = None         # None: CUDA, raising without it


def _check_ported(cfg: FitConfig):
    if cfg.distributed:
        not_ported("distributed training", "A8")
    if cfg.n_devices not in (None, 1):
        not_ported("n_devices > 1", "A8")
    if cfg.merge_streams:
        not_ported("merge_streams", "A10")
    if cfg.results_format not in ("native", "reference"):
        raise ValueError(f"results_format {cfg.results_format!r}: 'native' "
                         "or 'reference'")
    if cfg.pretrained and not cfg.pretrained.endswith(".ckpt"):
        not_ported("a reference .pt as pretrained weights", "A10")


def _write_run_files(run_dir: Path, cfg: FitConfig):
    """hyp.yaml, opt.json and train_args.txt (the arguments without
    --resume), as the reference keeps them (train.py:56-59)."""
    import yaml
    (run_dir / "hyp.yaml").write_text(yaml.safe_dump(cfg.hyp.as_dict()))
    opt = {k: v for k, v in dataclasses.asdict(cfg).items()
           if k not in ("model_cfg", "data_cfg", "hyp")}
    (run_dir / "opt.json").write_text(json.dumps(opt, indent=2, default=str))
    if len(sys.argv) > 1:
        argv, skip = [], False
        for a in sys.argv[1:]:
            if skip or a == "--resume":
                skip = not skip
                continue
            argv.append(a)
        (run_dir / "train_args.txt").write_text(" ".join(argv))


def _load_pretrained(path: str, model: ICAFusionModel):
    """The EMA tree of a .ckpt (else its weights) into ``model``."""
    ckpt = load_checkpoint(path)
    tree = ckpt.get("ema_tree", ckpt)
    load_jax_variables(model, {k: tree[k] for k in ("params", "batch_stats")
                               if k in tree})
    print(f"pretrained: {path}")


def ema_model(trainer: Trainer) -> ICAFusionModel:
    """A model on the trainer's device holding its EMA weights."""
    model = build_model(trainer.model.cfg).to(trainer.device)
    missing, unexpected = model.load_state_dict(trainer.ema.tree,
                                                strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked")
                         for k in missing):
        raise KeyError(f"EMA tree: missing {missing}, unexpected "
                       f"{unexpected}")
    return model


def fit(cfg: FitConfig) -> dict:
    device = resolve_device(cfg.device, "fit")
    _check_ported(cfg)
    log = print
    run_dir = increment_path(Path(cfg.project) / cfg.name)
    wdir = run_dir / "weights"
    wdir.mkdir(parents=True, exist_ok=True)
    log(f"run dir: {run_dir}")
    _write_run_files(run_dir, cfg)

    # --- data ---
    root = Path(cfg.data_cfg.path)
    nc = cfg.data_cfg.nc
    cache_dir = str(run_dir / ".cache")
    train_ds = PairedDetectionDataset(
        str(root / cfg.data_cfg.train_rgb), str(root / cfg.data_cfg.train_ir),
        img_size=cfg.imgsz, nc=nc, single_cls=cfg.single_cls, hyp=cfg.hyp,
        augment=True, cache_dir=cache_dir)
    val_ds = PairedDetectionDataset(
        str(root / cfg.data_cfg.val_rgb), str(root / cfg.data_cfg.val_ir),
        img_size=cfg.imgsz, nc=nc, single_cls=cfg.single_cls, hyp=cfg.hyp,
        cache_dir=cache_dir)
    accum = max(int(cfg.accum_steps or 1), 1)
    loader = PairedLoader(train_ds, batch_size=cfg.batch_size * accum,
                          max_targets=cfg.max_targets, seed=cfg.seed,
                          num_workers=cfg.workers,
                          image_weights=cfg.image_weights,
                          class_weights=labels_to_class_weights(
                              train_ds.labels, nc))
    val_loader = PairedLoader(val_ds, batch_size=cfg.batch_size,
                              shuffle=False, num_workers=cfg.workers)
    if loader.steps_per_epoch <= 0:
        raise ValueError(f"{len(train_ds)} training pairs make no batch of "
                         f"{cfg.batch_size * accum}")

    # --- anchors (train.py:227-228) ---
    model_cfg = cfg.model_cfg
    if cfg.autoanchor:
        from icafusion_tpu_torch.train.autoanchor import maybe_autoanchor
        anchors_px = np.asarray(model_cfg.anchors, np.float32).reshape(
            model_cfg.nl, -1, 2)
        new, changed = maybe_autoanchor(train_ds, anchors_px, cfg.imgsz,
                                        thr=cfg.hyp.anchor_t)
        if changed:
            model_cfg = with_anchors(model_cfg, new)
            log("autoanchor: updated model anchors")

    # --- model + trainer ---
    model = init_weights(build_model(model_cfg),
                         torch.Generator().manual_seed(cfg.seed))
    if cfg.pretrained:
        _load_pretrained(cfg.pretrained, model)
    trainer = Trainer(model=model, hyp=cfg.hyp, epochs=cfg.epochs,
                      steps_per_epoch=loader.steps_per_epoch,
                      batch_size=cfg.batch_size, imgsz=cfg.imgsz,
                      warmup_min_steps=cfg.warmup_min_steps,
                      accum_steps=accum, adam=cfg.adam,
                      linear_lr=cfg.linear_lr, freeze=tuple(cfg.freeze),
                      bf16=cfg.bf16, device=device, seed=cfg.seed)
    if cfg.freeze:
        frozen = [_path_str(p) for p in trainer.paths.values()
                  if _is_frozen(p, tuple(cfg.freeze))]
        if not frozen:
            raise ValueError(f"--freeze {cfg.freeze} matched no parameters")
        for k in frozen:
            log(f"freezing {k}")
        log(f"frozen: {len(frozen)}/{len(trainer.paths)} params")
    start_epoch, best_fit = 0, 0.0
    if cfg.resume:
        ckpt = load_checkpoint(cfg.resume)
        restore_train_state(ckpt, trainer)
        start_epoch = int(ckpt["meta"]["epoch"]) + 1
        best_fit = float(ckpt["meta"]["best_fitness"])
        log(f"resumed from {cfg.resume} at epoch {start_epoch}")

    scales = (1.0,)
    if cfg.multi_scale:
        scales = viable_train_scales(model_cfg, cfg.imgsz, cfg.imgsz,
                                     MULTI_SCALES, log)
    steps = {s: trainer.make_train_step(scale=s) for s in scales}
    scale_rng = np.random.default_rng(cfg.seed + 1)

    ref_csv = cfg.results_format == "reference"
    names = list(cfg.data_cfg.names or [])
    can_plot = importlib.util.find_spec("matplotlib") is not None
    if not can_plot:
        log("matplotlib is not installed: the plots are skipped")
    results_csv = run_dir / "results.csv"
    if not results_csv.exists():
        with open(results_csv, "w", newline="") as f:
            if ref_csv:     # the reference's header (train.py:407-409)
                f.write(",".join(["epoch"] + REFERENCE_RESULTS_KEYS) + "\n")
            else:
                csv.writer(f).writerow(RESULTS_HEADER)

    def put(b):
        """Upload a batch; uint8 images become float in [0, 1] on the
        device (channels_last: the NHWC bytes, permuted)."""
        def up(a):
            t = torch.from_numpy(a)
            if device.type == "cuda":
                t = t.pin_memory()
            return t.to(device, non_blocking=True)
        img = lambda a: up(a).permute(0, 3, 1, 2).float().div_(255.0)
        return (img(b["rgb"]), img(b["ir"]), up(b["targets"]),
                up(b["mask"]))

    def run_step(batch):
        s = (scales[scale_rng.integers(len(scales))] if cfg.multi_scale
             else 1.0)
        return steps[s](*batch)

    final = {}
    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.time()
        meter = EpochMeter()
        pending = None
        metrics = None
        for batch in loader.epoch(epoch):
            nxt = put(batch)
            if pending is not None:
                metrics = run_step(pending)
                meter.add(metrics)
            pending = nxt
        metrics = run_step(pending)
        meter.add(metrics)
        means = meter.means()
        lr_now = float(metrics["lr"])

        ev = {"mp": 0.0, "mr": 0.0, "map50": 0.0, "map": 0.0}
        mr_vals = [0.0] * 10
        last_epoch = epoch == cfg.epochs - 1
        if ((epoch + 1) % cfg.eval_every == 0 and not cfg.notest) \
                or last_epoch:
            evaluator = Evaluator(ema_model(trainer), nc=nc,
                                  single_cls=cfg.single_cls,
                                  loss_fn=trainer.loss_fn if ref_csv else None,
                                  max_targets=cfg.max_targets,
                                  dtype="bfloat16" if cfg.bf16 else "float32",
                                  device=device)
            ev = evaluator.run(
                val_loader.val_batches(), cfg.imgsz, confusion=last_epoch,
                names=names,
                mr_txt_dir=str(run_dir / "mr_txt") if cfg.kaist_ann else None,
                plots_dir=str(run_dir) if last_epoch and can_plot else None)
            if cfg.kaist_ann:
                # the MR columns the reference reserves (train.py:398-411)
                try:
                    kr = evaluate_kaist(cfg.kaist_ann, str(
                        run_dir / "mr_txt" / "result.txt"))
                    mr_vals = [kr.MR_all, kr.MR_day, kr.MR_night, kr.MR_near,
                               kr.MR_medium, kr.MR_far, kr.MR_none,
                               kr.MR_partial, kr.MR_heavy, kr.recall_all]
                except Exception as e:
                    log(f"KAIST MR eval failed: {e}")
            fit_val = fitness(np.array([0, 0, 0, 0, ev["mp"], ev["mr"],
                                        ev["map50"], ev["map"]]))
            if fit_val > best_fit:
                best_fit = fit_val
                if not cfg.nosave or last_epoch:
                    save_checkpoint(wdir / "best.ckpt", trainer, epoch,
                                    best_fit, background=True)
        if (not cfg.nosave or last_epoch) and (
                (epoch + 1) % cfg.save_every == 0 or last_epoch):
            save_checkpoint(wdir / "last.ckpt", trainer, epoch, best_fit,
                            background=True)
        dt = time.time() - t0
        with open(results_csv, "a", newline="") as f:
            if ref_csv:
                vals = [*means[:3], 0.0,                     # train losses
                        ev.get("tp", 0.0), ev.get("fp", 0.0),
                        ev.get("fn", 0.0), ev.get("f1", 0.0),
                        ev["mp"], ev["mr"], ev["map50"], ev["map"],
                        *ev.get("val_loss_items", [0.0] * 4),
                        lr_now, lr_now, lr_now, *mr_vals]
                f.write(",".join(f"{v:g}" for v in [epoch] + vals) + "\n")
            else:
                csv.writer(f).writerow(
                    [epoch, *[f"{x:.5f}" for x in means[:3]],
                     f"{ev['mp']:.5f}", f"{ev['mr']:.5f}",
                     f"{ev['map50']:.5f}", f"{ev['map']:.5f}",
                     f"{best_fit:.5f}", f"{lr_now:.6f}", f"{dt:.1f}"])
        log(f"epoch {epoch}/{cfg.epochs - 1}: loss={means[3]:.4f} "
            f"mAP50={ev['map50']:.4f} best={best_fit:.4f} ({dt:.0f}s)")
        final = ev

    wait_pending_saves()
    best = wdir / "best.ckpt"
    strip_checkpoint(best if best.exists() else wdir / "last.ckpt",
                     wdir / "stripped.ckpt")
    if can_plot:
        try:   # results.png and the confusion matrix (plots.py:457)
            plot_results(results_csv)
            if isinstance(final.get("cm"), np.ndarray):
                plot_confusion_matrix(final["cm"], names,
                                      run_dir / "confusion_matrix.png")
        except Exception as e:
            log(f"final plots failed: {e}")
    final.pop("cm", None)
    final["best_fitness"] = best_fit
    final["run_dir"] = str(run_dir)
    return final
