"""Model export CLI of the port, with the flags of the JAX package's
cli/export.py (reference models/export.py:24-127):

    python -m icafusion_tpu_torch.cli.export --weights best.ckpt \\
        --cfg zoo:tfb:s --img-size 640 --batch 1 \\
        --include pt2 weights onnx [--nms] [--int8] [--validate]

- ``pt2``, the counterpart of the JAX ``stablehlo`` target: a
  ``torch.export`` program (``<stem>.pt2``) of the eval forward on
  ``--device``, (rgb, ir) NCHW float in [0, 1] -> (decoded predictions,
  class logits), with ``--nms`` the four ``Detections`` tensors of
  non_max_suppression(top_k=1024). The hand-written kernels are the
  ``icafusion::*`` operators of kernels/ops.py in its graph; load it after
  importing icafusion_tpu_torch.kernels.ops;
- ``weights``: ``<stem>.weights.msgpack``, the JAX CLI's tree ({params,
  batch_stats} in float16, meta {cfg, img_size});
- ``onnx``: ``<stem>.onnx`` (export/onnx_export.py: two-stream, decode
  included, ``--nms`` bakes NonMaxSuppression in); with ``--int8`` also
  ``<stem>.int8.onnx`` in W8A8 QDQ form, calibrated on ``--calib-source1/2``
  or, with a warning, on two seeded random batches. ``--validate`` runs the
  graph with the numpy evaluator and holds it to the port's forward on
  ``--device`` (exit status 1 when it diverges).

``stablehlo`` and ``savedmodel`` (jax2tf) are refused: the first is ``pt2``
here, the second is not ported. It runs on the CUDA card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import copy
import sys
from pathlib import Path

import numpy as np
import torch
from torch import nn

REFUSED = {
    "stablehlo": "--include stablehlo is the JAX package's program format; "
                 "the port's counterpart is --include pt2 (a torch.export "
                 "program)",
    "savedmodel": "--include savedmodel (TF SavedModel through jax2tf) is "
                  "not ported",
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser("icafusion-torch-export")
    ap.add_argument("--weights", required=True,
                    help=".ckpt of either package, or a reference .pt")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--include", nargs="+", default=["pt2", "weights"],
                    choices=["pt2", "weights", "onnx", "stablehlo",
                             "savedmodel"])
    ap.add_argument("--nms", action="store_true",
                    help="bake NMS into the exported program")
    ap.add_argument("--conf-thres", type=float, default=0.25)
    ap.add_argument("--iou-thres", type=float, default=0.45)
    ap.add_argument("--int8", action="store_true",
                    help="ALSO emit <out>.int8.onnx in standard W8A8 QDQ form "
                         "(per-tensor activation scales, per-out-channel int8 "
                         "weights quantized after BN folding)")
    ap.add_argument("--calib-source1", default=None,
                    help="RGB folder for int8 calibration batches")
    ap.add_argument("--calib-source2", default=None,
                    help="IR folder for int8 calibration batches")
    ap.add_argument("--validate", action="store_true",
                    help="after ONNX export, execute the emitted graph with the "
                         "bundled numpy evaluator on a random input and hold "
                         "it to the port's forward on --device")
    ap.add_argument("--out", default=None, help="output stem (default: weights path)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    args = ap.parse_args(argv)
    for target, why in REFUSED.items():
        if target in args.include:
            ap.error(why)
    return args


class ExportForward(nn.Module):
    """The program ``pt2`` exports: the eval forward with decode, (pred,
    class logits), or with ``nms`` = (conf_thres, iou_thres) the
    Detections tensors (boxes, scores, classes, valid) of
    non_max_suppression at top_k 1024, as the JAX CLI's forward."""

    def __init__(self, model: nn.Module, nms=None):
        super().__init__()
        self.model = model
        self.nms = nms

    def forward(self, rgb, ir):
        pred, logits = self.model(rgb, ir, logits=True)
        if self.nms is None:
            return pred, logits
        from icafusion_tpu_torch.ops.nms import non_max_suppression
        conf, iou = self.nms
        return tuple(non_max_suppression(pred, conf_thres=conf,
                                         iou_thres=iou, top_k=1024))


def export_program(model: nn.Module, batch: int, imgsz: int, nms=None,
                   dtype=torch.float32):
    """torch.export of ExportForward(model) on the model's device, for
    (batch, 3, imgsz, imgsz) inputs of ``dtype``, under no_grad."""
    p = next(model.parameters())
    # two tensors: one passed twice would trace the two inputs as one
    rgb, ir = (torch.zeros((batch, 3, imgsz, imgsz), device=p.device,
                           dtype=dtype) for _ in range(2))
    with torch.no_grad():
        return torch.export.export(ExportForward(model.eval(), nms),
                                   (rgb, ir))


def program_ops(program) -> dict:
    """{operator name: node count} of the icafusion::* nodes in a
    torch.export program's graph."""
    counts: dict = {}
    for n in program.graph.nodes:
        name = str(n.target)
        if n.op == "call_function" and name.startswith("icafusion."):
            key = name.split(".")[1]
            counts[key] = counts.get(key, 0) + 1
    return counts


def _random_pair(B: int, S: int):
    rng = np.random.default_rng(0)
    return (rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32),
            rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32))


def _nchw(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy()).to(device)


def _run_onnx(blob: bytes, rgb: np.ndarray, ir: np.ndarray) -> np.ndarray:
    from icafusion_tpu_torch.export import onnx_numpy, onnx_proto
    (out,) = onnx_numpy.run(onnx_proto.load(blob), {
        "rgb": rgb.transpose(0, 3, 1, 2), "ir": ir.transpose(0, 3, 1, 2)
    }).values()
    return out


def pair_detections(got: np.ndarray, want: np.ndarray):
    """Two sets of equally many (n, 7) [batch, x1, y1, x2, y2, conf, cls]
    rows, each of got paired with one of want: within each (batch, class)
    the closest boxes first, greedily; then the rest in score order. Sorting
    both by score alone (the JAX CLI's order) pairs tied scores, which a
    saturated model gives at high thresholds, arbitrarily."""
    pairs = []
    left = set(range(len(want)))
    for i in np.argsort(-got[:, 5], kind="stable"):
        same = [j for j in left if (want[j, [0, 6]] == got[i, [0, 6]]).all()]
        if same:
            j = min(same, key=lambda j: np.abs(want[j, 1:5]
                                               - got[i, 1:5]).max())
            pairs.append((i, j))
            left.discard(j)
    rest_g = [i for i in np.argsort(-got[:, 5], kind="stable")
              if i not in {p[0] for p in pairs}]
    rest_w = sorted(left, key=lambda j: -want[j, 5])
    pairs += list(zip(rest_g, rest_w))
    g, w = zip(*pairs) if pairs else ((), ())
    return got[list(g)], want[list(w)]


def validate_onnx(model, blob: bytes, args, device) -> bool:
    """The ONNX graph on a seeded random pair against the port's forward on
    ``device``, with the JAX CLI's gates: box < 0.1 * S / 64 px and score
    < 1e-2 without NMS; with it the same detection count, box < 0.1 px,
    score < 1e-3 and equal batch and class ids. Prints the deltas; returns
    whether it holds."""
    from icafusion_tpu_torch.ops.nms import (detections_to_numpy,
                                             non_max_suppression)
    B, S = args.batch, args.img_size
    rgb, ir = _random_pair(B, S)
    out = _run_onnx(blob, rgb, ir)
    where = f"the port's forward on {torch.device(device).type}"
    with torch.inference_mode():
        ref = model(_nchw(rgb, device), _nchw(ir, device))
        if args.nms:
            dets = detections_to_numpy(non_max_suppression(
                ref, conf_thres=args.conf_thres, iou_thres=args.iou_thres,
                multi_label=True, max_det=300, top_k=4096))
    if not args.nms:
        ref = ref.float().cpu().numpy()
        box = np.abs(out[..., :4] - ref[..., :4]).max()
        score = np.abs(out[..., 4:] - ref[..., 4:]).max()
        ok = bool(box < 0.1 * S / 64 and score < 1e-2)
        print(f"  validate: max |Δbox| {box:.4f} px, max |Δscore| "
              f"{score:.2e} vs {where} ({'OK' if ok else 'DIVERGED'})")
        return ok
    want = np.concatenate(
        [np.c_[np.full(len(d), bi), d] for bi, d in enumerate(dets)]) \
        if any(len(d) for d in dets) else np.zeros((0, 7))
    if len(out) != len(want):
        print(f"  validate (NMS baked): DIVERGED — {len(out)} onnx vs "
              f"{len(want)} detections of {where}")
        return False
    got, want = pair_detections(out, want)
    box = np.abs(got[:, 1:5] - want[:, 1:5]).max(initial=0)
    score = np.abs(got[:, 5] - want[:, 5]).max(initial=0)
    ids = np.abs(got[:, [0, 6]] - want[:, [0, 6]]).max(initial=0)
    ok = bool(box < 0.1 and score < 1e-3 and ids == 0)
    print(f"  validate (NMS baked): {len(got)} detections, max |Δbox| "
          f"{box:.4f} px, |Δscore| {score:.2e}, batch/cls mismatches "
          f"{int(ids != 0)} vs {where} ({'OK' if ok else 'DIVERGED'})")
    return ok


def calibration_batches(args):
    """(rgb, ir) float batches in [0, 1], (B, S, S, 3): the first 2 * B
    pairs of --calib-source1/2 letterboxed (data/decode.py, scaleup as the
    JAX CLI's letterbox), or two seeded random batches with a warning."""
    B, S = args.batch, args.img_size
    if args.calib_source1 and args.calib_source2:
        from icafusion_tpu_torch.data.datasets import discover_images
        from icafusion_tpu_torch.data.decode import decode_letterbox_batch
        f1 = discover_images(args.calib_source1)[:2 * B]
        f2 = discover_images(args.calib_source2)[:2 * B]
        batches = []
        for start in range(0, len(f1) - B + 1, B):
            rgb, ir = decode_letterbox_batch(f1[start:start + B],
                                             f2[start:start + B], S,
                                             scaleup=True)[:2]
            batches.append((rgb.astype(np.float32) / 255.0,
                            ir.astype(np.float32) / 255.0))
        print(f"int8: calibrated on {len(batches)} real batches")
        return batches
    rng = np.random.default_rng(0)
    batches = [(rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32),
                rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32))
               for _ in range(2)]
    print("int8: WARNING — no --calib-source1/2 given; activation scales "
          "calibrated on RANDOM inputs (structure-valid artifact; "
          "recalibrate on real pairs for deployment)")
    return batches


def quantized_copy(model, mc, args):
    """A copy of the float32 ``model`` quantized as the JAX CLI quantizes
    it: calibrated on calibration_batches, the Detect feeders left float."""
    from icafusion_tpu_torch.utils.quantize import (calibrate,
                                                    detect_feeder_skip,
                                                    quantize_model)
    q = copy.deepcopy(model)
    return quantize_model(q, calibrate(q, calibration_batches(args)),
                          skip=detect_feeder_skip(mc))


def weights_tree(model, cfg: str, img_size: int) -> dict:
    """The JAX CLI's weights tree: {params, batch_stats} in float16 and
    meta {cfg, img_size}."""
    from icafusion_tpu_torch.utils.convert import to_jax_variables
    v = to_jax_variables(model)
    half = lambda t: {k: half(x) if isinstance(x, dict)
                      else np.asarray(x, np.float16) for k, x in t.items()}
    return {"params": half(v["params"]),
            "batch_stats": half(v.get("batch_stats", {})),
            "meta": {"cfg": cfg, "img_size": img_size}}


def export_model(args, mc, model, stem: Path) -> bool:
    """Write every --include target of the float32 ``model`` (on its
    device) under ``stem``; returns False where a --validate diverged."""
    from icafusion_tpu_torch.export.onnx_export import export_onnx
    B, S = args.batch, args.img_size
    device = next(model.parameters()).device
    ok = True

    if "pt2" in args.include:
        nms = (args.conf_thres, args.iou_thres) if args.nms else None
        program = export_program(model, B, S, nms)
        path = stem.with_suffix(".pt2")
        torch.export.save(program, str(path))
        print(f"pt2 ({'with' if args.nms else 'no'} NMS, {device.type}): "
              f"{path} ({path.stat().st_size / 1e6:.1f} MB); kernels in its "
              f"graph {program_ops(program)}")

    if "onnx" in args.include:
        nms_opts = (args.conf_thres, args.iou_thres, 300) if args.nms else None
        blob = export_onnx(model, batch=B, imgsz=S, nms=nms_opts)
        opath = stem.with_suffix(".onnx")
        opath.write_bytes(blob)
        print(f"ONNX (opset 13, two-stream, decode"
              f"{'+NMS' if args.nms else ''} included): {opath} "
              f"({opath.stat().st_size / 1e6:.1f} MB)")
        if args.validate:
            ok = validate_onnx(model, blob, args, device) and ok
        if args.int8:
            blob8 = export_onnx(quantized_copy(model, mc, args), batch=B,
                                imgsz=S, nms=nms_opts)
            o8 = Path(str(stem) + ".int8.onnx")
            o8.write_bytes(blob8)
            print(f"ONNX int8 QDQ (W8A8, per-out-channel weights): {o8} "
                  f"({o8.stat().st_size / 1e6:.1f} MB)")
            if args.validate and not args.nms:
                rgb, ir = _random_pair(B, S)
                fp, q8 = (_run_onnx(b, rgb, ir) for b in (blob, blob8))
                box = np.abs(q8[..., :4] - fp[..., :4]).max()
                score = np.abs(q8[..., 4:] - fp[..., 4:]).max()
                print(f"  int8 validate: quantization deltas vs fp32 ONNX — "
                      f"max |Δbox| {box:.2f} px, max |Δscore| {score:.4f} "
                      f"(expected small but nonzero)")

    if "weights" in args.include:
        from icafusion_tpu_torch.utils.checkpoint import msgpack_serialize
        wpath = stem.with_suffix(".weights.msgpack")
        wpath.write_bytes(msgpack_serialize(weights_tree(model, args.cfg, S)))
        print(f"weights: {wpath} ({wpath.stat().st_size / 1e6:.1f} MB)")
    return ok


def main(argv=None) -> int:
    args = parse_args(argv)
    from icafusion_tpu_torch.cli._common import load_model_for_inference
    from icafusion_tpu_torch.utils.general import resolve_device
    device = resolve_device(args.device, "cli.export")
    mc, model = load_model_for_inference(args.cfg, args.weights)
    model = model.eval().to(device)
    stem = Path(args.out or args.weights).with_suffix("")
    return 0 if export_model(args, mc, model, stem) else 1


if __name__ == "__main__":
    sys.exit(main())
