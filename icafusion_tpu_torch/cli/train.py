"""Training CLI of the port, with the flags of the JAX package's
cli/train.py (reference train.py:493-588):

    python -m icafusion_tpu_torch.cli.train --cfg yolov5l_Transfusion.yaml \\
        --data flir_align_3class.yaml --hyp hyp.scratch.yaml --epochs 60 \\
        --batch-size 8 --bf16

It trains on the CUDA card (--device cpu for the CPU), over every local
card with one process each (--devices N for N of them), or as one rank of a
torchrun launch:

    torchrun --nproc-per-node 4 -m icafusion_tpu_torch.cli.train \\
        --distributed --cfg ... --data ... --batch-size 32

--batch-size is the global batch in both. Flags whose paths are not ported
raise with the ROADMAP item that holds them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser("icafusion-torch-train")
    ap.add_argument("--cfg", required=True,
                    help="model yaml or zoo:<fusion>:<scale> / zoo:tiny / "
                         "zoo:vgg16 / zoo:resnet50")
    ap.add_argument("--data", required=True, help="dataset yaml")
    ap.add_argument("--hyp", default=None, help="hyperparameter yaml")
    ap.add_argument("--weights", default=None,
                    help="pretrained .ckpt, or a reference .pt (a "
                         "single-stream one seeds both towers)")
    ap.add_argument("--resume", default=None, help="checkpoint to resume from")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--project", default="runs/train")
    ap.add_argument("--name", default="exp")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 autocast over float32 parameters")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--eval-every", type=int, default=1)
    ap.add_argument("--devices", type=int, default=None,
                    help="number of devices, one training process each "
                         "(default: all)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    ap.add_argument("--save-every", type=int, default=1)
    ap.add_argument("--warmup-min", type=int, default=1000,
                    help="warmup floor in iterations (reference: 1000)")
    ap.add_argument("--multi-scale", action="store_true",
                    help="multi-scale training over 5 sizes")
    ap.add_argument("--image-weights", action="store_true",
                    help="class-aware image resampling per epoch")
    ap.add_argument("--noautoanchor", action="store_true")
    ap.add_argument("--accum", default=None,
                    help="gradient accumulation: an integer, or 'auto' for "
                         "the reference's nbs=64 rule")
    ap.add_argument("--freeze", nargs="+", default=[], metavar="NAME",
                    help="freeze parameters whose /-joined flax path "
                         "contains NAME; a leading slash anchors at the top "
                         "level ('/m0/' is layer 0 only)")
    ap.add_argument("--adam", action="store_true",
                    help="Adam, betas=(momentum, 0.999)")
    ap.add_argument("--evolve", type=int, default=0, metavar="N",
                    help="hyperparameter evolution (not ported)")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process training under torchrun: join its "
                         "env:// process group (RANK, WORLD_SIZE, "
                         "MASTER_ADDR, MASTER_PORT); rank 0 alone writes "
                         "and evaluates")
    ap.add_argument("--merge-streams", default="0", metavar="K",
                    help="stream-merged training (not ported)")
    ap.add_argument("--linear-lr", action="store_true",
                    help="linear lr decay instead of one-cycle cosine")
    ap.add_argument("--label-smoothing", type=float, default=0.0,
                    metavar="EPS", help="BCE target smoothing epsilon")
    ap.add_argument("--single-cls", action="store_true",
                    help="train as one class: labels collapse to class 0, "
                         "model built with nc=1")
    ap.add_argument("--nosave", action="store_true",
                    help="save checkpoints on the final epoch only")
    ap.add_argument("--notest", action="store_true",
                    help="evaluate on the final epoch only")
    ap.add_argument("--results-format", default="native",
                    choices=["native", "reference"],
                    help="results.csv layout: 'native' (11 columns) or "
                         "'reference' (the reference's 29-key row, val "
                         "losses and MR columns included)")
    ap.add_argument("--kaist-ann", default=None, metavar="JSON",
                    help="KAIST annotation json: the MR submission txts "
                         "each evaluation and the MR columns of the "
                         "reference row")
    return ap.parse_args(argv)


def resolve_accum(accum, batch_size: int, nbs: int = 64) -> int:
    """'auto' -> the reference's max(round(nbs / batch), 1)."""
    if accum in (None, "", "none"):
        return 1
    if str(accum).lower() == "auto":
        return max(round(nbs / batch_size), 1)
    return max(int(accum), 1)


def main(argv=None):
    args = parse_args(argv)
    from icafusion_tpu_torch.cli._common import resolve_model_config
    from icafusion_tpu_torch.config import load_data_config, load_hyp_config
    from icafusion_tpu_torch.train.fit import FitConfig, fit
    from icafusion_tpu_torch.utils.general import check_img_size, not_ported

    if args.evolve:
        not_ported("--evolve", "A10")
    if str(args.merge_streams) not in ("0", ""):
        not_ported("--merge-streams", "A10")
    random.seed(args.seed)
    np.random.seed(args.seed)
    data_cfg = load_data_config(args.data)
    hyp = load_hyp_config(args.hyp)
    if args.label_smoothing:
        hyp = hyp.replace(label_smoothing=args.label_smoothing)
    if args.single_cls:
        names = (tuple(data_cfg.names) if len(data_cfg.names) == 1
                 else ("item",))
        data_cfg = dataclasses.replace(data_cfg, nc=1, names=names)
    model_cfg = resolve_model_config(args.cfg, nc=data_cfg.nc)
    cfg = FitConfig(
        model_cfg=model_cfg, data_cfg=data_cfg, hyp=hyp, epochs=args.epochs,
        batch_size=args.batch_size, imgsz=check_img_size(args.img_size, 32),
        project=args.project, name=args.name, seed=args.seed, bf16=args.bf16,
        workers=args.workers, eval_every=args.eval_every,
        pretrained=args.weights, resume=args.resume, n_devices=args.devices,
        save_every=args.save_every, warmup_min_steps=args.warmup_min,
        multi_scale=args.multi_scale, image_weights=args.image_weights,
        autoanchor=not args.noautoanchor,
        accum_steps=resolve_accum(args.accum, args.batch_size),
        distributed=args.distributed, adam=args.adam,
        results_format=args.results_format, kaist_ann=args.kaist_ann,
        linear_lr=args.linear_lr, single_cls=args.single_cls,
        nosave=args.nosave, notest=args.notest, freeze=tuple(args.freeze),
        device=args.device)
    result = fit(cfg)
    if not args.distributed or os.environ.get("RANK", "0") == "0":
        print(f"done: mAP50={result.get('map50', 0):.4f} "
              f"best_fitness={result.get('best_fitness', 0):.4f} "
              f"run={result.get('run_dir')}")
    return result


if __name__ == "__main__":
    main()
