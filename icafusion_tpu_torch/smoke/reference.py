"""Phase 13 of chip_smoke.py: reference weights. The original PyTorch
ICAFusion's .pt checkpoints read through the port's entry points
(utils/torch_convert.py), the long tail of the YAML registry served on the
card, and fit from a single-stream .pt with its TensorBoard scalars."""

from __future__ import annotations

import contextlib
import io
import math
import time
from pathlib import Path

import numpy as np
import torch

from icafusion_tpu_torch.smoke.common import (BATCH, REPO, S640, S640_CFG,
                                              counted, done, extval_files,
                                              matched, phase)
from icafusion_tpu_torch.smoke.configs import expected_launches, seeded_model
from icafusion_tpu_torch.smoke.val import VAL_BATCH

L_SPEC, L_PX = "zoo:tfb:l", 640     # 13b: the flagship at full width
SINK_PX = 64
# fp32 card against CPU on the kitchen sink: the tolerance of the CPU
# tests that hold it against JAX (tests/test_torch_port_legacy_layers.py)
SINK_TOL = 1e-3
SINK_MATCH = 0.9      # bf16: the share of detections matched both ways


def kitchen_sink_yaml(nc: int = 2) -> dict:
    """Every long-tail module of the YAML registry in one two-stream graph
    (the JAX package's tests/test_onnx_export.py:222-256), as the dict a
    model YAML loads to: GhostConv, CrossConv, MixConv2d, Contract/Expand,
    CBAM, Channel_ and Spatial_Attention, GhostBottleneck, C3TR,
    BatchNorm2d, SE_Block and MaxPool2d on each stream (layers 0-13 RGB,
    14-27 IR), Add fusion at P3/P4/P5, Detect."""
    from icafusion_tpu_torch.models.zoo import COCO_ANCHORS
    tower = lambda f: [
        [f, 1, "GhostConv", [16, 3, 2]],          # 32^2 c16
        [-1, 1, "CrossConv", [32, 3, 2]],         # 16^2 c32
        [-1, 1, "MixConv2d", [32, [1, 3], 1]],    # 16^2 c32 (residual)
        [-1, 1, "Contract", [2]],                 # 8^2 c128
        [-1, 1, "Expand", [2]],                   # 16^2 c32
        [-1, 1, "CBAM", [32]],                    # 16^2 c32
        [-1, 1, "Channel_Attention", [32, 8]],    # 16^2 c32
        [-1, 1, "Spatial_Attention", [7]],        # 16^2 c32
        [-1, 1, "GhostBottleneck", [48, 3, 2]],   # 8^2 c48
        [-1, 1, "C3TR", [48]],                    # 8^2 c48
        [-1, 1, "BatchNorm2d", [48]],             # 8^2 c48   P3/8
        [-1, 1, "Conv", [64, 3, 2]],              # 4^2 c64
        [-1, 1, "SE_Block", [64]],                # 4^2 c64   P4/16
        [-1, 1, "MaxPool2d", [2, 2]],             # 2^2 c64   P5/32
    ]
    rows = tower(-1) + tower(-4) + [
        [[10, 24], 1, "Add", [1]],                # 28
        [[12, 26], 1, "Add", [1]],                # 29
        [[13, 27], 1, "Add", [1]],                # 30
        [[28, 29, 30], 1, "Detect", ["nc", "anchors"]],
    ]
    return dict(nc=nc, depth_multiple=1.0, width_multiple=1.0,
                anchors=[list(a) for a in COCO_ANCHORS], backbone=rows[:28],
                head=rows[28:], name="kitchen_sink")


def kitchen_sink_config(nc: int = 2):
    from icafusion_tpu_torch.config import load_model_config
    return load_model_config(kitchen_sink_yaml(nc), nc=nc)


def save_reference(sd, path: Path, fp16: bool = False, decoy: bool = False):
    """torch.save of a reference-named state dict (numpy arrays) as the
    reference's trainer lays a checkpoint out, {"ema": ..., "model": ...}
    (state dicts here: its pickled modules unpickle only where its package
    imports). decoy: "model" holds zeros, which a reader that does not take
    the EMA first would serve."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    if fp16:
        t = {k: v.half() for k, v in t.items()}
    torch.save({"epoch": -1, "best_fitness": None, "ema": t,
                "model": ({k: torch.zeros_like(v) for k, v in t.items()}
                          if decoy else t),
                "updates": 0, "optimizer": None}, path)
    return path


def _held(launches, batches, convs):
    want = {"dual_cross_attention": 3 * batches, "greedy_nms": batches,
            "conv3x3_bn_silu": convs * batches}
    assert launches == want, (launches, want)
    return launches


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def s640_pt_slice(work: Path, fp32_map50: float, total: dict):
    """13a: trained s640 written as a reference .pt by reverse_convert, read
    by cli.val and cli.detect."""
    from icafusion_tpu_torch.cli import detect as cli_detect
    from icafusion_tpu_torch.cli import val as cli_val
    from icafusion_tpu_torch.cli._common import load_model_for_inference
    from icafusion_tpu_torch.utils.torch_convert import reverse_convert

    t = time.perf_counter()
    ckpt = S640 / "stripped.ckpt"
    _, model = load_model_for_inference(S640_CFG, str(ckpt), nc=3)
    sd = reverse_convert(model)
    pt = save_reference(sd, work / "s640.pt")
    _, back = load_model_for_inference(S640_CFG, str(pt), nc=3)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back.state_dict()[k], v), k
    print(f"   {pt.name}: {len(sd)} reference keys, {pt.stat().st_size} B, "
          f"written and read back bit-equal to {ckpt.name} "
          f"({time.perf_counter() - t:.1f} s)")
    ext = S640 / "extval"
    batches = -(-len(extval_files()[0]) // VAL_BATCH)
    data = work / "extval.yaml"
    data.write_text(f"path: {ext}\nval_rgb: visible/val\n"
                    "val_ir: infrared/val\nnc: 3\n"
                    "names: ['red', 'green', 'blue']\n")
    r, launches = counted(lambda: cli_val.main([
        "--weights", str(pt), "--cfg", S640_CFG, "--data", str(data),
        "--img-size", "640", "--batch-size", str(VAL_BATCH),
        "--save-dir", str(work / "13a_val")]))
    print(f"   cli.val --weights {pt.name} fp32: mAP@50 {r['map50']:.5f} mAP "
          f"{r['map']:.5f} over {r['seen']} pairs; phase 7a from the .ckpt "
          f"{fp32_map50:.5f}; launches {launches}")
    assert f"{r['map50']:.5f}" == f"{fp32_map50:.5f}", (r["map50"],
                                                        fp32_map50)
    _add(total, _held(launches, batches, 5))
    base = ["--cfg", S640_CFG, "--source1", str(ext / "visible" / "val"),
            "--source2", str(ext / "infrared" / "val"), "--img-size", "640",
            "--batch-size", str(VAL_BATCH), "--conf-thres", "0.001",
            "--iou-thres", "0.5", "--save-txt", "--save-conf", "--nosave"]
    outs = {}
    for w in (ckpt, pt):
        outs[w.suffix] = work / f"13a_detect{w.suffix}"
        with contextlib.redirect_stdout(io.StringIO()):   # a line an image
            _, launches = counted(lambda: cli_detect.main(
                base + ["--weights", str(w), "--save-dir",
                        str(outs[w.suffix])]))
        if w == pt:
            _add(total, _held(launches, batches, 5))
    txts = sorted(p.name for p in outs[".ckpt"].glob("*.txt"))
    assert txts == sorted(p.name for p in outs[".pt"].glob("*.txt"))
    rows = 0
    for name in txts:
        a = (outs[".ckpt"] / name).read_text()
        assert a == (outs[".pt"] / name).read_text(), name
        rows += len(a.splitlines())
    print(f"   cli.detect --weights {pt.name}: {len(txts)} txts, {rows} rows, "
          f"equal row for row to the .ckpt run; launches {launches}")


def l640_pt_slice(work: Path, total: dict):
    """13b: a seeded yolov5l-Transfusion written as an fp16 reference .pt,
    read by load_model_for_inference, served at 640, batch 4, bf16."""
    from icafusion_tpu_torch.cli._common import (load_model_for_inference,
                                                 resolve_model_config)
    from icafusion_tpu_torch.serve.engine import ServingEngine
    from icafusion_tpu_torch.utils.torch_convert import reverse_convert

    model = seeded_model(resolve_model_config(L_SPEC, nc=3))
    pt = save_reference(reverse_convert(model), work / "l640.pt", fp16=True,
                        decoy=True)
    t = time.perf_counter()
    _, from_pt = load_model_for_inference(L_SPEC, str(pt), nc=3)
    load_s = time.perf_counter() - t
    with torch.no_grad():                  # the same fp16 rounding, in memory
        sd = model.state_dict()
        for k, v in sd.items():
            if v.is_floating_point():
                v.copy_(v.half().float())
    rng = np.random.default_rng(13)
    pairs = [tuple(rng.integers(0, 256, (BATCH, L_PX, L_PX, 3), np.uint8)
                   for _ in range(2)) for _ in range(2)]
    out = {}
    for tag, m in (("memory", model), (".pt", from_pt)):
        eng = ServingEngine(m, L_PX, BATCH, conf_thres=0.001,
                            dtype="bfloat16")
        eng.predict_arrays(*pairs[0])                       # warm-up
        dets, launches = counted(lambda: [eng.predict_arrays(*p)
                                          for p in pairs])
        out[tag] = dets
        if tag == ".pt":       # l: 3 attention, 1 NMS, 6 fused convs
            assert launches == expected_launches(m, len(pairs)), launches
            _add(total, launches)
        del eng
    n = 0
    for a, b in zip(out["memory"], out[".pt"]):
        for x, y in zip(a, b):
            assert np.array_equal(x, y), (x.shape, y.shape)
            n += len(x)
    print(f"   {pt.name}: {pt.stat().st_size} B fp16 (EMA first, zeros under "
          f"'model'), read in {load_s:.1f} s; {len(pairs)} bf16 requests of "
          f"{BATCH}: {n} detections bit-equal to the fp16-rounded weights in "
          f"memory; launches {launches}")


def kitchen_sink_slice(total: dict):
    """13c: the kitchen-sink graph served on the card in fp32 and bf16
    against the same engines on the CPU; a grouped 64 -> 64 3x3 Conv on the
    card launches no fused conv."""
    from icafusion_tpu_torch.models.assembler import build_model
    from icafusion_tpu_torch.nn.layers import Conv
    from icafusion_tpu_torch.serve.engine import ServingEngine

    model = build_model(kitchen_sink_config(),
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(14)
    rgb, ir = (rng.integers(0, 256, (BATCH, SINK_PX, SINK_PX, 3), np.uint8)
               for _ in range(2))
    for dtype in ("float32", "bfloat16"):
        eng = {d: ServingEngine(model, SINK_PX, BATCH, conf_thres=0.25,
                                dtype=dtype, device=d)
               for d in ("cuda", "cpu")}
        pred = {}
        with torch.inference_mode():
            for d, e in eng.items():
                x, y = (torch.from_numpy(a).to(e.device).permute(0, 3, 1, 2)
                        .float().div(255).to(e.dtype) for a in (rgb, ir))
                pred[d] = e.model(x, y).float().cpu()
        dets, launches = counted(lambda: eng["cuda"].predict_arrays(rgb, ir))
        ref = eng["cpu"].predict_arrays(rgb, ir)
        assert launches == {"dual_cross_attention": 0, "greedy_nms": 1,
                            "conv3x3_bn_silu": 0}, launches
        _add(total, launches)
        err = float((pred["cuda"] - pred["cpu"]).abs().max())
        shares = [min(matched(a, r), matched(r, a))
                  for a, r in zip(dets, ref)]
        print(f"   {dtype}: decoded predictions card vs CPU max |diff| "
              f"{err:.3g}; detections per image card "
              f"{[len(x) for x in dets]} CPU {[len(x) for x in ref]}, matched "
              f"both ways {shares}; launches {launches}")
        if dtype == "float32":
            torch.testing.assert_close(pred["cuda"], pred["cpu"],
                                       rtol=SINK_TOL, atol=SINK_TOL)
        else:
            assert sum(map(len, dets)) > 0
            assert min(shares) >= SINK_MATCH, shares
    conv = Conv(64, 64, 3, 1, g=64).eval()
    x = torch.randn(2, 64, 20, 20, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = conv(x)
        got, launches = counted(lambda: conv.cuda()(x.cuda()).cpu())
    assert launches["conv3x3_bn_silu"] == 0, launches
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    print(f"   grouped Conv(64, 64, 3, 1, g=64) on the card: launches "
          f"{launches}, equal to the CPU within 1e-4")


def single_stream_fit_slice(work: Path, data_yaml: Path, project: Path):
    """13d: one epoch of fit on yolov5n-Transfusion at 320 from a
    single-stream .pt (model.0-9 of trained n320)."""
    import csv
    from icafusion_tpu_torch.cli._common import load_model_for_inference
    from icafusion_tpu_torch.config import load_data_config, load_hyp_config
    from icafusion_tpu_torch.models.zoo import icafusion_config
    from icafusion_tpu_torch.train.fit import FitConfig, fit
    from icafusion_tpu_torch.utils.torch_convert import reverse_convert

    ckpt = REPO / "artifacts" / "trained_n320" / "stripped.ckpt"
    _, n320 = load_model_for_inference("zoo:tfb:n", str(ckpt), nc=3)
    single = {k: v for k, v in reverse_convert(n320).items()
              if int(k.split(".")[1]) < 10}
    pt = save_reference(single, work / "n320_single.pt", fp16=True)
    cfg = FitConfig(model_cfg=icafusion_config("n", nc=3),
                    data_cfg=load_data_config(data_yaml),
                    hyp=load_hyp_config("hyp.scratch.yaml"), epochs=1,
                    batch_size=16, imgsz=320, project=str(project),
                    name="13d", bf16=True, workers=8, pretrained=str(pt))
    said = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(said):
        result, launches = counted(lambda: fit(cfg))
    fit_s = time.perf_counter() - t
    lines = said.getvalue().splitlines()
    conv = [l for l in lines if l.startswith("pretrained: converted")]
    assert len(conv) == 1, lines
    run = Path(result["run_dir"])
    with open(run / "results.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and all(
        math.isfinite(float(rows[0][k]))
        for k in ("lbox", "lobj", "lcls", "mAP50", "mAP")), rows
    events = list((run / "tb").glob("events.out.tfevents.*"))
    tb = (f"up, {events[0].name}" if events
          else "not up (torch.utils.tensorboard does not import)")
    print(f"   {pt.name}: {len(single)} keys (model.0-9); {conv[0]}")
    print(f"   fit {fit_s:.1f} s, results {dict(rows[0])}; TensorBoard "
          f"writer {tb}; evaluation launches {launches}")


def reference_slice(card: str, fp32_map50: float, data_yaml: Path,
                    project: Path, work: Path) -> dict:
    """Phase 13; returns the launches of (a)-(c)'s counted serving runs."""
    total: dict = {}
    t0 = phase("13a trained s640 as a reference .pt: cli.val and cli.detect, "
               "fp32, batch 16")
    print(f"   {card}")
    s640_pt_slice(work, fp32_map50, total)
    done(t0)
    t0 = phase(f"13b {L_SPEC} at {L_PX} from an fp16 reference .pt: "
               f"ServingEngine b{BATCH} bf16")
    print(f"   {card}")
    l640_pt_slice(work, total)
    torch.cuda.empty_cache()
    done(t0)
    t0 = phase(f"13c kitchen sink (17 legacy modules) at {SINK_PX} px: "
               "ServingEngine card vs CPU, fp32 and bf16")
    print(f"   {card}")
    kitchen_sink_slice(total)
    done(t0)
    t0 = phase("13d fit yolov5n-Transfusion 320, 1 epoch, from a "
               "single-stream .pt")
    print(f"   {card}")
    single_stream_fit_slice(work, data_yaml, project)
    done(t0)
    return total
