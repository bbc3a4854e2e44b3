"""The training loop: the counterpart of the JAX package's train/fit.py
(reference train.py:42-490).

Config -> datasets and loaders -> anchor check -> model (init_weights, or
pretrained from a .ckpt or a reference .pt) -> Trainer steps on the card ->
per-epoch evaluation of the EMA weights by the Evaluator (the port's three
CUDA kernels) -> results.csv and TensorBoard scalars -> last/best
checkpoints in the JAX package's format -> the stripped EMA checkpoint.

results.csv is the native 11-column row or the reference's 29-key row
(results_format="reference": val losses from the Evaluator's loss_fn on the
same eval forward); with kaist_ann each evaluation writes the MR txts and
the reference row gets the KAIST miss rates. Where matplotlib imports, the
run starts with labels.png and the mosaics of its first three batches
(train_batch0-2.jpg), the last evaluation draws the PR/F1/P/R curves, and
the run ends with results.png and the confusion matrix; where it does not,
the plots are skipped and logged.

Data parallel (parallel/mesh.py), one process per device: with
``distributed`` the run joins the env:// process group a torchrun launch
gives it; ``n_devices`` > 1 without a group starts that many local ranks
(CUDA devices 0..n-1, or gloo ranks on the CPU) and returns rank 0's
result; ``n_devices`` None means every local card, or the one card that
``device`` names by its index (``cuda:1``). Each rank feeds its rows
of every microbatch, and BatchNorm, the loss's normalisers and the
gradients are the global batch's, as over the JAX package's mesh. Rank 0
picks the run directory and the anchors and alone writes files and
evaluates; the other ranks wait for it at a barrier. A rank's failure fails
the call.

pretrained is a .ckpt of either package or a reference .pt
(utils/torch_convert), a single-stream one remapped onto both towers.
Rank 0 writes the nine TensorBoard scalars of each epoch (losses, P, R,
mAP, lr) where torch.utils.tensorboard imports (utils/loggers.py).

merge_streams=K trains the stream-merged graph (utils/stream_merge.py):
the state is merged before the first step, the merged modules' gradients
are masked so that the zero blocks stay exactly 0, the EMA model is
evaluated merged, and every checkpoint is written in the standard
(unmerged) layout, as the JAX package's ckpt_view writes it.
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
from icafusion_tpu_torch.parallel import mesh
from icafusion_tpu_torch.train.optim import _is_frozen, _path_str
from icafusion_tpu_torch.train.trainer import Trainer, scaled_size
from icafusion_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  restore_train_state,
                                                  save_checkpoint,
                                                  strip_checkpoint,
                                                  wait_pending_saves)
from icafusion_tpu_torch.utils.convert import load_jax_variables
from icafusion_tpu_torch.utils.loggers import Loggers
from icafusion_tpu_torch.utils.plots import (plot_confusion_matrix,
                                             plot_images, plot_labels,
                                             plot_results)
from icafusion_tpu_torch.utils.general import (increment_path,
                                               labels_to_class_weights,
                                               resolve_device)
from icafusion_tpu_torch.utils.stream_merge import (grad_mask,
                                                    merge_train_state,
                                                    resolve_merge,
                                                    unmerge_train_state)
from icafusion_tpu_torch.utils.torch_convert import (
    convert_state_dict, load_torch_checkpoint,
    remap_single_stream_to_two_stream)

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
    pretrained: Optional[str] = None     # a .ckpt or a reference .pt
    resume: Optional[str] = None
    n_devices: Optional[int] = None      # local ranks (None: every card,
                                         # or the one card named)
    workers: int = 8
    warmup_min_steps: int = 1000         # the reference's floor
    autoanchor: bool = True
    image_weights: bool = False
    multi_scale: bool = False
    accum_steps: Optional[int] = None    # microbatches per optimizer step
    distributed: bool = False            # join torchrun's env:// group
    adam: bool = False
    merge_streams: int = 0               # stream-merged pairs (0: none)
    linear_lr: bool = False
    freeze: tuple = ()
    single_cls: bool = False
    nosave: bool = False                 # checkpoints on the final epoch only
    notest: bool = False                 # evaluation on the final epoch only
    results_format: str = "native"       # or "reference", the 29-key row
    kaist_ann: Optional[str] = None      # KAIST annotation json: MR columns
    device: Optional[str] = None         # None: CUDA, raising without it


def _check_config(cfg: FitConfig):
    resolve_merge(cfg.merge_streams, cfg.model_cfg)
    if cfg.pretrained and not Path(cfg.pretrained).is_file():
        raise FileNotFoundError(f"no pretrained weights {cfg.pretrained}")
    if cfg.results_format not in ("native", "reference"):
        raise ValueError(f"results_format {cfg.results_format!r}: 'native' "
                         "or 'reference'")


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
    """A reference .pt (utils/torch_convert; a single-stream one, with no
    model.10 key, has its backbone copied into the IR tower, reference
    train.py:94-99; tensors it does not name keep their init), or the EMA
    tree of a .ckpt (else its weights), into ``model``."""
    if path.endswith(".pt"):
        sd = load_torch_checkpoint(path)
        if not any(k.startswith("model.10.") for k in sd):
            sd = remap_single_stream_to_two_stream(sd)
        _, unused = convert_state_dict(sd, model, strict=False)
        print(f"pretrained: converted {path} ({len(unused)} unused ref keys)")
        return
    ckpt = load_checkpoint(path)
    tree = ckpt.get("ema_tree", ckpt)
    load_jax_variables(model, {k: tree[k] for k in ("params", "batch_stats")
                               if k in tree})
    print(f"pretrained: {path}")


def ema_model(trainer: Trainer) -> ICAFusionModel:
    """A model on the trainer's device holding its EMA weights (merged
    where the trainer's model is)."""
    model = build_model(trainer.model.cfg,
                        merge_pairs=trainer.model.merge_pairs
                        ).to(trainer.device)
    missing, unexpected = model.load_state_dict(trainer.ema.tree,
                                                strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked")
                         for k in missing):
        raise KeyError(f"EMA tree: missing {missing}, unexpected "
                       f"{unexpected}")
    return model


def fit(cfg: FitConfig) -> dict:
    """Train as FitConfig says; returns the last evaluation's metrics with
    best_fitness and run_dir (rank 0's)."""
    device = resolve_device(cfg.device, "fit")
    _check_config(cfg)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if cfg.distributed and not torch.distributed.is_initialized():
        mesh.init_distributed(backend)
        try:
            return _fit(cfg, _rank_device(device))
        finally:
            torch.distributed.destroy_process_group()
    if mesh.world() > 1:
        return _fit(cfg, _rank_device(device))
    n = mesh.make_mesh(cfg.n_devices, device).size
    if n > 1:
        return mesh.spawn(_fit_rank, n, (cfg,), backend=backend)
    return _fit(cfg, device)


def _rank_device(device: torch.device) -> torch.device:
    """A rank's device: its current CUDA device (init_distributed set it
    from LOCAL_RANK), or the CPU. A card named by its index must be that
    one."""
    if device.type != "cuda":
        return device
    cur = torch.device("cuda", torch.cuda.current_device())
    if device.index is not None and device != cur:
        raise ValueError(f"fit: this rank runs on {cur}, not the {device} "
                         "asked for; ask for 'cuda'")
    return cur


def _fit_rank(cfg: FitConfig) -> dict:
    """One local rank of fit(n_devices > 1) (parallel/mesh.spawn): rank r
    runs on cuda:r, in the mesh that fit checked."""
    device = resolve_device(cfg.device, "fit")
    return _fit(cfg, _rank_device(torch.device(device.type)))


def _fit(cfg: FitConfig, device: torch.device) -> dict:
    is_main, world = mesh.is_main(), mesh.world()
    log = print if is_main else (lambda *a, **k: None)
    run_dir = wdir = None
    if is_main:
        run_dir = increment_path(Path(cfg.project) / cfg.name)
        wdir = run_dir / "weights"
        wdir.mkdir(parents=True, exist_ok=True)
        _write_run_files(run_dir, cfg)
    # every rank takes rank 0's choice (increment_path would race)
    run_dir = Path(mesh.broadcast_object(str(run_dir)))
    wdir = run_dir / "weights"
    log(f"run dir: {run_dir}")

    # --- data ---
    root = Path(cfg.data_cfg.path)
    nc = cfg.data_cfg.nc
    # a cache of its own for each rank: no two write one file
    cache_dir = str(run_dir / (".cache" if world == 1
                               else f".cache_p{mesh.rank()}"))
    train_ds = PairedDetectionDataset(
        str(root / cfg.data_cfg.train_rgb), str(root / cfg.data_cfg.train_ir),
        img_size=cfg.imgsz, nc=nc, single_cls=cfg.single_cls, hyp=cfg.hyp,
        augment=True, cache_dir=cache_dir)
    val_ds = PairedDetectionDataset(
        str(root / cfg.data_cfg.val_rgb), str(root / cfg.data_cfg.val_ir),
        img_size=cfg.imgsz, nc=nc, single_cls=cfg.single_cls, hyp=cfg.hyp,
        cache_dir=cache_dir)
    accum = max(int(cfg.accum_steps or 1), 1)
    local_rows = None
    if world > 1:
        local_rows = mesh.process_rows(cfg.batch_size, accum)
        log(f"data parallel: {world} ranks; each feeds "
            f"{len(local_rows) // accum} rows of every global microbatch of "
            f"{cfg.batch_size}")
    loader = PairedLoader(train_ds, batch_size=cfg.batch_size * accum,
                          max_targets=cfg.max_targets, seed=cfg.seed,
                          num_workers=cfg.workers,
                          image_weights=cfg.image_weights,
                          class_weights=labels_to_class_weights(
                              train_ds.labels, nc),
                          local_rows=local_rows)
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
        new = changed = None
        if is_main:
            new, changed = maybe_autoanchor(train_ds, anchors_px, cfg.imgsz,
                                            thr=cfg.hyp.anchor_t)
        new, changed = mesh.broadcast_object((new, changed))
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

    # --- stream-merged training ---
    merge_k = resolve_merge(cfg.merge_streams, model_cfg)
    gmask = None
    if merge_k:
        trainer = merge_train_state(model_cfg, trainer, merge_k)
        gmask = grad_mask(model_cfg, trainer.params, merge_k)
        log(f"stream-merge: the first {merge_k} RGB/IR layer pairs run "
            "block-diagonal, their gradients masked")

    def ckpt_view(tr: Trainer) -> Trainer:
        """Checkpoints keep the standard layout: a merged trainer is
        unmerged on the host first (lossless: its zero blocks are 0)."""
        if not merge_k:
            return tr
        return unmerge_train_state(model_cfg, tr, merge_k, device="cpu")

    scales = (1.0,)
    if cfg.multi_scale:
        scales = viable_train_scales(model_cfg, cfg.imgsz, cfg.imgsz,
                                     MULTI_SCALES, log)
    steps = {s: trainer.make_train_step(scale=s, grad_mask=gmask)
             for s in scales}
    scale_rng = np.random.default_rng(cfg.seed + 1)

    ref_csv = cfg.results_format == "reference"
    names = list(cfg.data_cfg.names or [])
    can_plot = is_main and importlib.util.find_spec("matplotlib") is not None
    if is_main and not can_plot:
        log("matplotlib is not installed: the plots are skipped")
    elif can_plot and any(len(l) for l in train_ds.labels):
        try:   # the label distributions (train.py:222, plots.py:330)
            plot_labels(train_ds.labels, names, run_dir)
        except Exception as e:
            log(f"plot_labels failed: {e}")
    # TensorBoard scalars each epoch, rank 0 (train.py:586)
    loggers = Loggers(run_dir, enable_tb=is_main)
    results_csv = run_dir / "results.csv"
    if is_main and not results_csv.exists():
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
        for i, batch in enumerate(loader.epoch(epoch)):
            if can_plot and epoch == start_epoch and i < 3:
                try:   # the first three mosaics (train.py:361-365)
                    plot_images(batch["rgb"], batch["targets"], batch["mask"],
                                run_dir / f"train_batch{i}.jpg", names)
                except Exception as e:
                    log(f"plot_images failed: {e}")
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
        if is_main and (((epoch + 1) % cfg.eval_every == 0
                         and not cfg.notest) or last_epoch):
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
                    save_checkpoint(wdir / "best.ckpt", ckpt_view(trainer),
                                    epoch, best_fit, background=True)
        if is_main and (not cfg.nosave or last_epoch) and (
                (epoch + 1) % cfg.save_every == 0 or last_epoch):
            save_checkpoint(wdir / "last.ckpt", ckpt_view(trainer), epoch,
                            best_fit, background=True)
        mesh.barrier()           # the other ranks wait for rank 0's evaluation
        dt = time.time() - t0
        final = ev
        if not is_main:
            continue
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
        loggers.log_scalars(
            {"train/box_loss": means[0], "train/obj_loss": means[1],
             "train/cls_loss": means[2], "train/loss": means[3],
             "metrics/precision": ev["mp"], "metrics/recall": ev["mr"],
             "metrics/mAP_0.5": ev["map50"],
             "metrics/mAP_0.5:0.95": ev["map"], "x/lr": lr_now}, epoch)
        log(f"epoch {epoch}/{cfg.epochs - 1}: loss={means[3]:.4f} "
            f"mAP50={ev['map50']:.4f} best={best_fit:.4f} ({dt:.0f}s)")

    if is_main:
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
    loggers.close()
    final.pop("cm", None)
    final["best_fitness"] = best_fit
    final["run_dir"] = str(run_dir)
    return final
