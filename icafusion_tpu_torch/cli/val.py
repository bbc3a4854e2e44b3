"""Validation CLI of the port, with the flags of the JAX package's
cli/val.py (reference test.py:370-438):

    python -m icafusion_tpu_torch.cli.val --weights best.ckpt \\
        --cfg yolov5s_Transfusion.yaml --data flir_align_3class.yaml \\
        [--task val|test|speed|study] [--rect] [--save-txt] [--kaist-ann ...]

It evaluates on the CUDA card (--device cpu for the CPU). --int8
evaluates the int8 W8A8 model, calibrated on the first two val batches
(and persisted beside a checkpoint file as <weights>.calib). --merge K
evaluates the stream-merged graph (utils/stream_merge.py), --int8 then
calibrates and quantizes the merged model.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser("icafusion-torch-val")
    ap.add_argument("--weights", required=True,
                    help=".ckpt of either package, or a reference .pt")
    ap.add_argument("--cfg", required=True,
                    help="model yaml or zoo:<fusion>:<scale> / zoo:tiny / "
                         "zoo:vgg16 / zoo:resnet50")
    ap.add_argument("--data", required=True, help="dataset yaml")
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--conf-thres", type=float, default=0.001)
    ap.add_argument("--iou-thres", type=float, default=0.5)
    ap.add_argument("--task", default="val",
                    choices=["val", "test", "speed", "study"],
                    help="speed: conf 0.25 / IoU 0.45 throughput run "
                         "(test.py:421-423); study: sweep image sizes, write "
                         "study_*.txt and study.png (test.py:425-438)")
    ap.add_argument("--study-sizes", default="256:1664:128",
                    help="--task study size sweep as start:stop:step")
    ap.add_argument("--rect", action="store_true",
                    help="rect pad-0.5 letterbox val (the reference's eval "
                         "protocol, test.py:100): per-image stride-aligned "
                         "canvases grouped by shape. Default: the square")
    ap.add_argument("--save-txt", action="store_true",
                    help="write MR-format detection txts")
    ap.add_argument("--save-dir", default="runs/val/exp")
    ap.add_argument("--kaist-ann", default=None,
                    help="KAIST annotation json: also compute the miss-rate "
                         "suite")
    ap.add_argument("--confusion", action="store_true")
    ap.add_argument("--single-cls", action="store_true",
                    help="treat as single-class (test.py:157-158)")
    ap.add_argument("--augment", action="store_true",
                    help="TTA multi-scale/flip ensemble (test.py:128)")
    ap.add_argument("--save-json", action="store_true",
                    help="dump COCO-format detections json (test.py:185-194)")
    ap.add_argument("--int8", action="store_true",
                    help="W8A8 quantized evaluation: calibrate on the first "
                         "two val batches at --img-size (persisted as "
                         "<weights>.calib and reused), Detect feeders kept "
                         "in float")
    ap.add_argument("--merge", default="0", metavar="K",
                    help="stream-merge the first K RGB/IR layer pairs "
                         "(block-diagonal kernels, the same outputs; "
                         "utils/stream_merge.py); 'auto' is 0 in the port")
    ap.add_argument("--confluence", action="store_true",
                    help="replace NMS with confluence clustering (the "
                         "reference's optional swap-in, test.py:140). On "
                         "the host and quadratic in candidates per class: "
                         "raise --conf-thres (e.g. 0.1) with it")
    ap.add_argument("--confluence-p", type=float, default=0.6,
                    help="confluence proximity threshold")
    ap.add_argument("--coco-gt", default=None,
                    help="COCO annotations json: run the AP/AR suite on the "
                         "saved detections (test.py:329-352; implies "
                         "--save-json)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    return ap.parse_args(argv)


def _dataset(nc: int, rgb: str, ir: str, img_size: int,
             single_cls: bool = False):
    """The val pairs; single_cls collapses every label to class 0, as the
    reference's dataset does (datasets.py:393)."""
    from icafusion_tpu_torch.config import load_hyp_config
    from icafusion_tpu_torch.data.datasets import PairedDetectionDataset
    return PairedDetectionDataset(rgb, ir, img_size=img_size,
                                  hyp=load_hyp_config(), nc=nc,
                                  single_cls=single_cls)


def quantize_from_dir(args, ev, nc: int, rgb: str, ir: str) -> None:
    """Quantize the Evaluator's model in place (the JAX package's
    cli/val.py _quantize_from_dir): calibrate on the first two val batches
    at args.img_size, normalised as the Evaluator normalises them. When
    --weights is a file, the calibration is persisted beside it
    (<weights>.calib, keyed by the checkpoint's sha1, the scheme, the image
    size, the calibration set, the batch and the stream-merge count) and
    loaded on later runs."""
    from icafusion_tpu_torch.data.loader import PairedLoader
    from icafusion_tpu_torch.utils.quantize import (calibrate,
                                                    calibrate_cached,
                                                    calibration_key,
                                                    detect_feeder_skip,
                                                    quantize_model)

    def calib_batches():
        loader = PairedLoader(_dataset(nc, rgb, ir, args.img_size),
                              batch_size=args.batch_size, shuffle=False)
        batches = []
        for batch in loader.val_batches():
            batches.append((batch["rgb"].astype(np.float32) / 255.0,
                            batch["ir"].astype(np.float32) / 255.0))
            if len(batches) >= 2:
                break
        print(f"int8: calibrated on {len(batches)} batches")
        return batches

    w = Path(args.weights)
    if w.is_file():
        key = calibration_key(str(w), merge=ev.model.merge_pairs,
                              extra={"imgsz": args.img_size,
                                     "calib_set": rgb,
                                     "batch": args.batch_size})
        calib, hit = calibrate_cached(ev.model, calib_batches,
                                      str(w) + ".calib", key)
        print(f"int8: loaded persisted calibration ({w}.calib)" if hit else
              f"int8: calibration persisted to {w}.calib")
    else:
        calib = calibrate(ev.model, calib_batches())
    skip = detect_feeder_skip(ev.model.cfg)
    print(f"int8: Detect-feeder convs kept in float ({', '.join(skip)})")
    quantize_model(ev.model, calib, skip=skip)


def run_study(args, ev, nc: int, rgb: str, ir: str):
    """--task study: evaluate at each size of --study-sizes, write the
    reference-layout study_*.txt (10 columns: P R mAP50 mAP lbox lobj lcls
    t_inf t_nms t_total) and plot it. NMS runs inside the timed call, so
    t_nms is 0 and t_inf equals t_total."""
    from icafusion_tpu_torch.data.loader import PairedLoader
    from icafusion_tpu_torch.utils.plots import plot_study_txt

    start, stop, step = (int(v) for v in args.study_sizes.split(":"))
    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for s in range(start, stop, step):
        print(f"study point: imgsz={s} ...")
        loader = PairedLoader(_dataset(nc, rgb, ir, s, args.single_cls),
                              batch_size=args.batch_size, shuffle=False)
        out = ev.run(loader.val_batches(), s)
        t = out["t_total_ms"]
        rows.append([out["mp"], out["mr"], out["map50"], out["map"],
                     0.0, 0.0, 0.0, t, 0.0, t])
        print(f"  mAP50={out['map50']:.4f} mAP={out['map']:.4f} "
              f"{t:.2f} ms/img")
    stem = f"study_{Path(args.data).stem}_{Path(args.weights).stem}"
    txt = save_dir / f"{stem}.txt"
    np.savetxt(txt, np.array(rows), fmt="%10.4g")
    png = plot_study_txt(save_dir)
    print(f"wrote {txt} and {png}")
    return rows


def main(argv=None):
    args = parse_args(argv)
    from icafusion_tpu_torch.cli._common import load_model_for_inference
    from icafusion_tpu_torch.config import load_data_config
    from icafusion_tpu_torch.data.loader import PairedLoader
    from icafusion_tpu_torch.eval.evaluator import Evaluator
    from icafusion_tpu_torch.utils.general import resolve_device

    device = resolve_device(args.device, "cli.val")
    data_cfg = load_data_config(args.data)
    _, model = load_model_for_inference(args.cfg, args.weights,
                                        nc=data_cfg.nc, merge=args.merge)
    root = Path(data_cfg.path)
    test = args.task == "test"
    rgb = str(root / (data_cfg.test_rgb if test else data_cfg.val_rgb))
    ir = str(root / (data_cfg.test_ir if test else data_cfg.val_ir))
    if args.task == "speed":
        # throughput settings (test.py:421-423)
        args.conf_thres, args.iou_thres = 0.25, 0.45
        args.save_json = args.confusion = args.save_txt = False
        args.coco_gt = args.kaist_ann = None
    # single_cls scores one class (test.py:157-158: nc = 1)
    nc = 1 if args.single_cls else data_cfg.nc
    ev = Evaluator(model, nc=nc, conf_thres=args.conf_thres,
                   iou_thres=args.iou_thres, single_cls=args.single_cls,
                   augment=args.augment, confluence=args.confluence,
                   confluence_p=args.confluence_p, device=device)
    if args.int8:
        quantize_from_dir(args, ev, data_cfg.nc, rgb, ir)
    if args.task == "study":
        return run_study(args, ev, data_cfg.nc, rgb, ir)
    loader = PairedLoader(_dataset(data_cfg.nc, rgb, ir, args.img_size,
                                   args.single_cls),
                          batch_size=args.batch_size, shuffle=False)
    save_dir = Path(args.save_dir)
    mr_dir = (str(save_dir / "labels") if (args.save_txt or args.kaist_ann)
              else None)
    save_json = args.save_json or args.coco_gt is not None
    batches = loader.rect_val_batches() if args.rect else loader.val_batches()
    out = ev.run(batches, args.img_size, confusion=args.confusion,
                 mr_txt_dir=mr_dir, names=list(data_cfg.names),
                 coco_json=(str(save_dir / "detections.json") if save_json
                            else None))

    if args.task == "speed":
        print(f"speed: {out['t_total_ms']:.2f} ms/img end-to-end "
              f"(forward, decode, NMS and the copy to the host, batch "
              f"{args.batch_size}, first two batches excluded)")
    print(f"{'Class':>12} {'Images':>8} {'P':>8} {'R':>8} {'mAP50':>8} "
          f"{'mAP75':>8} {'mAP':>8}")
    print(f"{'all':>12} {out['seen']:>8} {out['mp']:8.4f} {out['mr']:8.4f} "
          f"{out['map50']:8.4f} {out['map75']:8.4f} {out['map']:8.4f}")
    for c, d in out.get("per_class", {}).items():
        name = data_cfg.names[c] if c < len(data_cfg.names) else str(c)
        print(f"{name:>12} {out['seen']:>8} {d['p']:8.4f} {d['r']:8.4f} "
              f"{d['ap50']:8.4f} {'':8} {d['ap']:8.4f}")

    if args.coco_gt:
        from icafusion_tpu_torch.eval.cocoeval import evaluate_files
        print("\nEvaluating COCO AP/AR suite...")
        stats, _ = evaluate_files(args.coco_gt,
                                  str(save_dir / "detections.json"))
        out["coco_map"], out["coco_map50"] = float(stats[0]), float(stats[1])

    if args.kaist_ann:
        from icafusion_tpu_torch.eval.kaist import evaluate_kaist
        mr = evaluate_kaist(args.kaist_ann,
                            str(save_dir / "labels" / "result.txt"))
        print("KAIST MR suite:", json.dumps(
            {k: round(v * 100, 2) for k, v in mr.as_dict().items()}))

    save_dir.mkdir(parents=True, exist_ok=True)
    summary = {k: v for k, v in out.items() if k not in ("cm", "per_class")}
    summary["nt"] = np.asarray(out["nt"]).tolist()
    (save_dir / "metrics.json").write_text(json.dumps(summary, indent=2))
    return out


if __name__ == "__main__":
    main()
