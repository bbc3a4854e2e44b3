"""Phase 7 of chip_smoke.py: validation of trained s640 on its extval
pairs (cli.val, the Evaluator in bf16, --rect, --augment)."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np
import torch

from icafusion_tpu_torch.smoke.common import (MAP50_GATE, REPO, S640,
                                              S640_CFG, counted, done, phase)

VAL_BATCH = 16
TTA_CANDIDATES = 25200 + 18207 + 12348   # 640, 531 -> 544, 428 -> 448


def coco_ground_truth(rgb_dir: Path, out: Path) -> Path:
    """A COCO ground-truth json of the YOLO labels beside rgb_dir's images
    (labels/<split>/<stem>.txt): image id = file stem, as the Evaluator's
    COCO dump names it, category = class, boxes in native pixels."""
    import cv2
    gt = {"images": [], "annotations": [],
          "categories": [{"id": c} for c in range(3)]}
    for img in sorted(rgb_dir.glob("*.jpg")):
        h, w = cv2.imread(str(img)).shape[:2]
        gt["images"].append({"id": img.stem})
        lab = rgb_dir.parents[1] / "labels" / rgb_dir.name / f"{img.stem}.txt"
        for c, cx, cy, bw, bh in np.loadtxt(lab, ndmin=2):
            box = [float((cx - bw / 2) * w), float((cy - bh / 2) * h),
                   float(bw * w), float(bh * h)]
            gt["annotations"].append({
                "id": len(gt["annotations"]) + 1, "image_id": img.stem,
                "category_id": int(c), "bbox": box,
                "area": box[2] * box[3], "iscrowd": 0})
    out.write_text(json.dumps(gt))
    return out


def val_slice(work: Path):
    """Phase 7: the validation path on trained yolov5s-Transfusion weights
    and the 141 extval pairs at 640, each run with the launches of the three
    wrappers counted from zero; mAP@50 held to TRAINED_PARITY_640.json.
    Returns 7a's fp32 mAP@50."""
    from icafusion_tpu_torch.cli import val as cli_val
    from icafusion_tpu_torch.cli._common import load_model_for_inference
    from icafusion_tpu_torch.data.datasets import PairedDetectionDataset
    from icafusion_tpu_torch.data.loader import PairedLoader
    from icafusion_tpu_torch.eval.evaluator import Evaluator
    from icafusion_tpu_torch.kernels.cross_attention import dual_cross_attention
    from icafusion_tpu_torch.kernels.nms import greedy_nms
    from icafusion_tpu_torch.kernels.packed_conv import conv3x3_bn_silu
    from icafusion_tpu_torch.models.tta import tta_inference

    rec = json.loads((REPO / "TRAINED_PARITY_640.json").read_text())
    jax_rec = {k: rec["ours"][k]["ref_scored"]["map50"]
               for k in ("fp32", "bf16", "fp32+rect")}
    ref_rec = {"fp32": rec["torch"]["map50"],
               "fp32+rect": rec["torch_rect"]["map50"]}
    ext = S640 / "extval"
    data = work / "extval.yaml"
    data.write_text(f"path: {ext}\nval_rgb: visible/val\n"
                    "val_ir: infrared/val\nnc: 3\n"
                    "names: ['red', 'green', 'blue']\n")
    coco_gt = coco_ground_truth(ext / "visible" / "val", work / "gt.json")
    base = ["--weights", str(S640 / "stripped.ckpt"), "--cfg", S640_CFG,
            "--data", str(data), "--img-size", "640",
            "--batch-size", str(VAL_BATCH)]

    def report(tag, r, launches, records):
        deltas = ", ".join(f"{k} record {v:.5f} (delta "
                           f"{100 * (r['map50'] - v):+.3f} pts)"
                           for k, v in records.items()) or "no record"
        print(f"   {tag}: mAP@50 {r['map50']:.5f} mAP {r['map']:.5f} P "
              f"{r['mp']:.5f} R {r['mr']:.5f} over {r['seen']} pairs; "
              f"{deltas}; {r['t_total_ms']:.2f} ms per image; launches "
              f"{launches}")
        assert r["seen"] == rec["n_images"], r["seen"]
        assert all(launches.values()), launches
        for v in records.values():
            assert abs(r["map50"] - v) <= MAP50_GATE, (tag, r["map50"], v)

    t0 = phase("7a cli.val s640 fp32: --save-txt --save-json --confusion "
               "--coco-gt")
    out_dir = work / "7a"
    r, launches = counted(lambda: cli_val.main(base + [
        "--save-dir", str(out_dir), "--save-txt", "--save-json",
        "--confusion", "--coco-gt", str(coco_gt)]))
    report("fp32", r, launches, {"JAX fp32": jax_rec["fp32"],
                                 "reference stack": ref_rec["fp32"]})
    fp32_map50 = r["map50"]
    lines = (out_dir / "labels" / "result.txt").read_text().splitlines()
    per_image = sum(len(p.read_text().splitlines())
                    for p in (out_dir / "labels").glob("i*.txt"))
    dets = json.loads((out_dir / "detections.json").read_text())
    print(f"   COCO AP {r['coco_map']:.5f} AP50 {r['coco_map50']:.5f}; "
          f"result.txt {len(lines)} lines, per-image txts {per_image}, "
          f"detections.json {len(dets)}; confusion matrix "
          f"{r['cm'].tolist()}")
    assert len(lines) == per_image == len(dets) > 0
    assert 0 < r["coco_map"] <= r["coco_map50"] <= 1
    done(t0)

    t0 = phase("7b Evaluator s640 bf16")
    _, model = load_model_for_inference(S640_CFG, str(S640 / "stripped.ckpt"),
                                        nc=3)
    ds = PairedDetectionDataset(str(ext / "visible" / "val"),
                                str(ext / "infrared" / "val"), 640, nc=3)
    ev = Evaluator(model, nc=3, dtype="bfloat16")
    r, launches = counted(lambda: ev.run(
        PairedLoader(ds, VAL_BATCH).val_batches(), 640))
    report("bf16", r, launches, {"JAX bf16": jax_rec["bf16"]})
    del ev
    done(t0)

    t0 = phase("7c cli.val s640 fp32 --rect")
    canvases = {ds.rect_val_canvas(i) for i in range(len(ds))}
    print(f"   rect canvases {sorted(canvases)}")
    assert canvases == {(544, 672)}, canvases
    r, launches = counted(lambda: cli_val.main(base + [
        "--save-dir", str(work / "7c"), "--rect"]))
    report("fp32 rect", r, launches,
           {"JAX fp32+rect": jax_rec["fp32+rect"],
            "reference stack rect": ref_rec["fp32+rect"]})
    done(t0)

    t0 = phase("7d cli.val s640 fp32 --augment (not gated)")
    r, launches = counted(lambda: cli_val.main(base + [
        "--save-dir", str(work / "7d"), "--augment"]))
    report("fp32 TTA", r, launches, {})
    batch = next(iter(PairedLoader(ds, 2).val_batches()))
    card = copy.deepcopy(model).cuda()
    with torch.inference_mode():
        pred = {}
        for dev, m in (("cuda", card), ("cpu", model)):
            x, y = (torch.from_numpy(batch[k]).to(dev).permute(0, 3, 1, 2)
                    .float() / 255.0 for k in ("rgb", "ir"))
            pred[dev] = tta_inference(m, x, y).cpu()
    d = (pred["cuda"] - pred["cpu"]).abs()
    box_err, conf_err = d[..., :4].max().item(), d[..., 4:].max().item()
    print(f"   TTA predictions of 2 pairs, card against CPU: "
          f"{tuple(pred['cuda'].shape)}, max |box| {box_err:.3g} px "
          f"(tolerance 1e-2), max |conf| {conf_err:.3g} (1e-4)")
    assert pred["cuda"].shape == (2, TTA_CANDIDATES, 8)
    assert box_err <= 1e-2 and conf_err <= 1e-4, (box_err, conf_err)
    done(t0)
    return fp32_map50
