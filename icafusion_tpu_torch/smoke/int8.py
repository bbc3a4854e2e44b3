"""Phase 11 of chip_smoke.py: int8 W8A8 serving (the int8 conv against its
plain version at every shape class, the quantized flagship engine, cli.val
--int8, the HTTP server --int8)."""

from __future__ import annotations

import contextlib
import io
import json
import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from icafusion_tpu_torch.smoke.common import (BATCH, MAP50_GATE, RECT, REPO,
                                              S640, S640_CFG, STEADY_REQUESTS,
                                              bound, counted, done,
                                              extval_files, phase,
                                              profile_requests, queued_ms,
                                              read_rgb)
from icafusion_tpu_torch.smoke.val import VAL_BATCH

# Phase 11: int8 W8A8 serving (utils/quantize.py, kernels/conv_int8.py).
# The kernel's int32 accumulators equal the plain version's exactly: both
# quantize with the same fp32 division and round half to even, and both
# sum integers exactly. The epilogue repeats the plain version's fp32
# operations in order (no FMA contraction), so fp32 outputs differ only by
# the exponential inside SiLU (an ulp or two): 1e-5 relative to the
# largest output. bf16: one rounding of those fp32 values, which that ulp
# can move by one bf16 ulp (2^-8): 3e-2.
INT8_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# (Cin, Cout, k, s, H, W) of the input map: the quantized shape classes of
# yolov5l-Transfusion at 640 but the stems (STEM_SHAPES), the 512 x 640
# canvas's P3 and two yolov5x widths (Cin up to 2560, Cout 1280)
INT8_SHAPES = ((64, 128, 3, 2, 320, 320),     # P2 down-sample
               (128, 64, 1, 1, 160, 160),     # the first C3's cv1
               (64, 64, 1, 1, 160, 160),      # its bottlenecks' 1x1
               (64, 64, 3, 1, 160, 160),      # and 3x3
               (256, 128, 1, 1, 80, 80), (128, 128, 3, 1, 80, 80),
               (512, 256, 1, 1, 40, 40), (256, 256, 3, 1, 40, 40),
               (1024, 512, 1, 1, 20, 20), (512, 512, 3, 1, 20, 20),
               (2048, 1024, 1, 1, 20, 20),    # SPPF's cv2
               (256, 128, 1, 1, 64, 80),      # P3 of the 512 x 640 canvas
               (128, 128, 3, 1, 64, 80),
               (640, 1280, 3, 2, 40, 40),     # yolov5x's P5 down-sample
               (2560, 1280, 1, 1, 20, 20))    # and its SPPF's cv2
INT8_BATCHES = (1, BATCH, 32)
# The "stem" path's classes: yolov5l's stem (K = 108), the merged stem of
# --merge (Cin 6, K = 216; smoke/merge.py) and a stem on a ragged map
# (output tiles cut at both edges)
STEM_SHAPES = ((3, 64, 6, 2, 640, 640), (6, 128, 6, 2, 640, 640),
               (3, 64, 6, 2, 250, 330))
# Phase 11 times each call by CUDA events around calls queued behind a
# sleep (queued_ms), not by the profiler: a CUPTI window that records part
# of its calls gave single int8 convs times below their bound in one run,
# and a forward's sum multiplies such a class by up to 24.
INT8_CONVS_L = 162     # yolov5l-Transfusion's Convs (165) less 3 feeders
INT8_RECORDS = {"n320": "TRAINED_PARITY.json",
                "s640": "TRAINED_PARITY_640.json",
                "l640": "TRAINED_PARITY_L640.json"}


def int8_record(which: str) -> float:
    """The JAX package's int8 mAP@50 record (Detect-feeder skip)."""
    rec = json.loads((REPO / INT8_RECORDS[which]).read_text())
    return rec["ours"]["int8"]["ref_scored"]["map50"]


# The first int8 conv design (one mma.sync kernel for every shape, which
# quantized x in its operand load) and its cuDNN yardstick, summed over the
# 162 int8 convs of a yolov5l-Transfusion 640 forward at batch 4 in bf16
# (11b on an NVIDIA H100 80GB HBM3 at 700.00 W, queued ms), and its 11c
# cli.val --int8 fp32 mAP@50: the numbers the current kernel is printed
# beside.
INT8_FORWARD_FIRST_MS = 15.0017
INT8_FORWARD_CUDNN_FIRST_MS = 5.2440
# the same sum with the tma path and the stems on the first design
# (11b on the same card, before the stem path)
INT8_FORWARD_TMA_MS = 7.6547
INT8_MAP50_FIRST = {"s640": 0.96649, "n320": 0.97869}


def plan_text(pl) -> str:
    """The path a conv takes, and its tile and shared memory: for the tma
    path with its groups and splits, for the stem and grouped paths with
    their grid."""
    if pl.path == "tma":
        return (f"tma {pl.tile[0]}x{pl.tile[1]} G{pl.groups} S{pl.splits} "
                f"{pl.smem // 1024}K")
    if pl.path in ("stem", "grouped"):
        return (f"{pl.path} {pl.tile[0]}x{pl.tile[1]} grid {pl.grid} "
                f"{pl.smem // 1024}K")
    return "direct"


def conv_out_hw(H, W, k, s):
    p = 2 if k == 6 else k // 2
    return (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1


def int8_case(B, shape, dtype, gen, layout=torch.channels_last):
    """(x, w8, s_in, s_w, bn, stride, padding) on the card: x with uneven
    channel ranges, s_in its own per-channel absmax / 127 (so x8 spans
    -127..127), random int8 weights, s_w scaling the sums to O(1), a
    BatchNorm away from identity."""
    Cin, Cout, k, s, H, W = shape
    dev = torch.device("cuda")
    x = torch.randn(B, Cin, H, W, device=dev, generator=gen)
    x = x * (0.25 + torch.rand(Cin, 1, 1, device=dev, generator=gen))
    x = x.to(dtype).contiguous(memory_format=layout)
    s_in = (x.float().abs().amax(dim=(0, 2, 3)) / 127).clamp_min(1e-8)
    w8 = torch.randint(-127, 128, (Cout, k, k, Cin), device=dev,
                       generator=gen, dtype=torch.int8)
    K = k * k * Cin
    s_w = (0.5 + torch.rand(Cout, device=dev, generator=gen)) / (
        2000 * math.sqrt(K))
    rand = lambda: torch.randn(Cout, device=dev, generator=gen)
    bn = (1 + 0.2 * rand(), 0.1 * rand(), 0.1 * rand(),
          0.5 + torch.rand(Cout, device=dev, generator=gen), 1e-3)
    return x, w8, s_in, s_w, bn, s, 2 if k == 6 else k // 2


def int8_check(args, act: bool = True) -> float:
    """The kernel against its plain version on the same inputs: the int32
    accumulators equal, the outputs within INT8_TOL of the largest, in x's
    dtype and channels_last. Returns the largest |difference|."""
    from icafusion_tpu_torch.kernels.conv_int8 import (
        conv_int8_bn_act, conv_int8_bn_act_reference)
    x = args[0]
    acc = conv_int8_bn_act(*args, act=act, epilogue=False)
    racc = conv_int8_bn_act_reference(*args, act=act, epilogue=False)
    out = conv_int8_bn_act(*args, act=act)
    ref = conv_int8_bn_act_reference(*args, act=act)
    torch.cuda.synchronize()
    if not torch.equal(acc, racc):
        bad = int((acc != racc).sum())
        raise AssertionError(f"int8 conv {tuple(x.shape)} -> "
                             f"{tuple(acc.shape)}: {bad} of {acc.numel()} "
                             "accumulators differ from the plain version")
    assert out.dtype == x.dtype and out.is_contiguous(
        memory_format=torch.channels_last), (out.dtype, out.stride())
    tol = INT8_TOL[x.dtype] * ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol, (tuple(x.shape), tuple(out.shape), err, tol)
    return err


def int8_bound(B, shape, dtype):
    Cin, Cout, k, s, H, W = shape
    Ho, Wo = conv_out_hw(H, W, k, s)
    sz = torch.finfo(dtype).bits // 8
    macs = B * Ho * Wo * Cout * k * k * Cin
    nbytes = (B * Cin * H * W * sz + Cout * k * k * Cin
              + B * Cout * Ho * Wo * sz + 6 * Cout * 4 + Cin * 4)
    return bound(2 * macs, nbytes, torch.int8)


def int8_yardsticks(args):
    """Yardsticks only (the port never calls them): (a) the float work the
    int8 path replaces, one cuDNN bf16 conv on the dequantized BN-folded
    weights with bias, then SiLU; (b) for a 1x1 conv, torch._int_mm on the
    already quantized (B*H*W, Cin) x (Cin, Cout) int8 operands."""
    from icafusion_tpu_torch.kernels.conv_int8 import (fold_epilogue,
                                                       quantize_input)
    F = torch.nn.functional
    x, w8, s_in, s_w, bn, s, p = args
    mult, add = fold_epilogue(s_w, bn)
    w = (w8.permute(0, 3, 1, 2).float() * mult[:, None, None, None]).to(
        torch.bfloat16)
    xb, b = x.to(torch.bfloat16), add.to(torch.bfloat16)
    cudnn = lambda: F.silu(F.conv2d(xb, w, b, s, p))
    int_mm = None
    Cout, k, _, Cin = w8.shape
    if k == 1 and Cin % 8 == 0 and Cout % 8 == 0:
        a = quantize_input(x, s_in).to(torch.int8).permute(0, 2, 3, 1)
        a = a.reshape(-1, Cin)
        bt = w8.reshape(Cout, Cin).t()
        int_mm = lambda: torch._int_mm(a, bt)
    return cudnn, int_mm


def int8_kernel_slice(gen) -> None:
    """11a: the int8 conv against its plain version at INT8_SHAPES (the
    tma path's classes), at B = 1, 4 and 32, in fp32 and bf16
    (channels_last, and NCHW at B = 4), each bf16 case timed beside its
    bound, the plain version and the yardsticks."""
    from icafusion_tpu_torch.kernels.conv_int8 import (
        conv_int8_bn_act, conv_int8_bn_act_reference, plan_for)
    for shape in INT8_SHAPES:
        for B in INT8_BATCHES:
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                args = int8_case(B, shape, dtype, gen)
                errs[str(dtype)[6:]] = int8_check(args)
                if B == BATCH:
                    errs[str(dtype)[6:] + " NCHW"] = int8_check(int8_case(
                        B, shape, dtype, gen, torch.contiguous_format))
            errs["identity"] = int8_check(args, act=False)
            ms = queued_ms(lambda: conv_int8_bn_act(*args))
            plain = queued_ms(lambda: conv_int8_bn_act_reference(*args),
                              iters=2, warmup=1)
            cudnn, int_mm = int8_yardsticks(args)
            lib = queued_ms(cudnn)
            mm = f" _int_mm {queued_ms(int_mm):.4f}" if int_mm else ""
            bnd, by = int8_bound(B, shape, torch.bfloat16)
            path = plan_text(plan_for(*args[:2], *args[5:]))
            print(f"   B={B:2d} {str(shape):30s} {path}: accumulators equal;"
                  f" max |err| "
                  f"{', '.join(f'{k} {v:.3g}' for k, v in errs.items())}"
                  f"; bf16 queued ms: kernel {ms:.4f} bound {bnd:.5f} ({by}) "
                  f"plain {plain:.3f} cuDNN bf16 {lib:.4f}{mm}")
            del args
        torch.cuda.empty_cache()


def int8_stem_slice(gen) -> dict:
    """11a, the stem path: STEM_SHAPES at B = 1, 4 and 32, fp32 and bf16,
    channels_last and NCHW, each on the "stem" path: int32 accumulators
    equal to the plain version's and outputs within INT8_TOL (with SiLU,
    and with identity on channels_last), then timed (queued_ms) beside its
    bound, the plain version and the cuDNN bf16 yardstick. Returns the
    kernels line's stem entry: yolov5l's stem at B = 4, bf16,
    channels_last (the engine's layout)."""
    from icafusion_tpu_torch.kernels.conv_int8 import (
        conv_int8_bn_act, conv_int8_bn_act_reference, plan_for)
    entry = None
    for shape in STEM_SHAPES:
        for B in INT8_BATCHES:
            for dtype in (torch.float32, torch.bfloat16):
                for layout, tag in ((torch.channels_last, "NHWC"),
                                    (torch.contiguous_format, "NCHW")):
                    args = int8_case(B, shape, dtype, gen, layout)
                    pl = plan_for(*args[:2], *args[5:])
                    assert pl.path == "stem", (shape, B, dtype, tag, pl)
                    err = int8_check(args)
                    if tag == "NHWC":
                        err = max(err, int8_check(args, act=False))
                    ms = queued_ms(lambda: conv_int8_bn_act(*args), iters=10)
                    plain = queued_ms(
                        lambda: conv_int8_bn_act_reference(*args), iters=2,
                        warmup=1)
                    lib = queued_ms(int8_yardsticks(args)[0], iters=10)
                    bnd, by = int8_bound(B, shape, dtype)
                    print(f"   B={B:2d} {str(shape):28s} {str(dtype)[6:]:8s} "
                          f"{tag} {plan_text(pl)}: accumulators equal; max "
                          f"|err| {err:.3g}; queued ms: kernel {ms:.4f} "
                          f"bound {bnd:.5f} ({by}) plain {plain:.3f} cuDNN "
                          f"bf16 {lib:.4f}")
                    if (shape, B, dtype, tag) == (STEM_SHAPES[0], BATCH,
                                                  torch.bfloat16, "NHWC"):
                        entry = {"ms": ms, "plain_ms": plain,
                                 "bound_ms": bnd, "library_ms": lib,
                                 "max_abs_err": err, "bound_by": {by}}
                    del args
            torch.cuda.empty_cache()
    return entry


def int8_per_forward(engine, pair) -> dict:
    """Every int8 conv of one forward of ``engine`` on ``pair``, on the
    input it was given: the kernel against its plain version (the kernels
    line's error), and device ms summed over the forward by shape class
    (kernel, plain, cuDNN bf16 yardstick) beside the summed bound. Runs in
    inference mode, as the captured inputs were made."""
    from icafusion_tpu_torch.nn.layers import Conv
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, a: seen.append((mod, a[0])))
        for m in engine.model.modules()
        if isinstance(m, Conv) and m.w8 is not None]
    with torch.inference_mode():
        x, y = (torch.from_numpy(a).cuda().permute(0, 3, 1, 2).float()
                / 255 for a in pair)
        engine.model(x.to(engine.dtype), y.to(engine.dtype))
        for h in hooks:
            h.remove()
        return _int8_per_forward(seen)


def _int8_per_forward(seen) -> dict:
    from icafusion_tpu_torch.kernels.conv_int8 import (
        conv_int8_bn_act, conv_int8_bn_act_reference, plan_for)
    classes, err, layouts = {}, 0.0, set()
    for mod, x in seen:
        bn = mod.bn
        args = (x, mod.w8, mod.s_in, mod.s_w,
                (bn.weight, bn.bias, bn.running_mean, bn.running_var,
                 bn.eps), mod.conv.stride, mod.conv.padding)
        act = isinstance(mod.act, torch.nn.SiLU)
        err = max(err, int8_check(args, act))
        layout = "NHWC" if x.is_contiguous(
            memory_format=torch.channels_last) else "other"
        layouts.add(layout)
        Cout, k, _, Cin = mod.w8.shape
        path = plan_for(x, mod.w8, mod.conv.stride, mod.conv.padding).path
        # the stems take the stem path, every other int8 conv the tma path
        # from a channels_last map: none the first design's direct path
        assert path == ("stem" if Cin % 16 else "tma") and (
            path == "stem" or layout == "NHWC"), (
            Cin, Cout, k, tuple(x.shape), x.stride(), path)
        key = (Cin, Cout, k, mod.conv.stride[0], *x.shape[2:])
        classes.setdefault(key, [args, act, 0, layout])[2] += 1
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    by = {"bytes": 0.0, "operations": 0.0}     # the summed bound, by cause
    for key, (args, act, n, layout) in classes.items():
        B = args[0].shape[0]
        ms = queued_ms(lambda: conv_int8_bn_act(*args, act=act))
        plain = queued_ms(lambda: conv_int8_bn_act_reference(*args, act=act),
                          iters=2, warmup=1)
        lib = queued_ms(int8_yardsticks(args)[0])
        bnd, b = int8_bound(B, key, args[0].dtype)
        by[b] += n * bnd
        for k_, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                      ("bound_ms", bnd)):
            tot[k_] += n * v
        print(f"   x{n:2d} {str(key):32s} {layout} "
              f"{plan_text(plan_for(*args[:2], *args[5:]))}: kernel {ms:.4f} "
              f"bound {bnd:.5f} ({b}) plain {plain:.3f} cuDNN bf16 "
              f"{lib:.4f} ms")
    print(f"   {len(seen)} int8 convs of one forward ({len(classes)} shape "
          f"classes, inputs {sorted(layouts)}): accumulators equal the plain "
          f"version's, max |err| {err:.3g}; summed over the forward, queued "
          f"ms: kernel {tot['ms']:.4f}, bound {tot['bound_ms']:.5f}, plain "
          f"{tot['plain_ms']:.3f}, cuDNN bf16 conv + SiLU "
          f"{tot['library_ms']:.4f}")
    print(f"   the summed bound: {by['bytes']:.5f} ms bytes-bound, "
          f"{by['operations']:.5f} ms operations-bound")
    ratio = tot["ms"] / INT8_FORWARD_FIRST_MS
    print(f"   summed int8 conv time of the forward: {tot['ms']:.4f} ms "
          f"against the first design's {INT8_FORWARD_FIRST_MS} ms "
          f"({ratio:.3f}x), the stems on it and the rest on the tma path "
          f"{INT8_FORWARD_TMA_MS} ms, and cuDNN bf16 conv + SiLU "
          f"{tot['library_ms']:.4f} ms here (in the first design's run: "
          f"{INT8_FORWARD_CUDNN_FIRST_MS} ms)")
    return {**tot, "max_abs_err": err, "bound_by": {max(by, key=by.get)},
            "convs": len(seen)}


def int8_serving_slice(card: str):
    """11b: the flagship engine (yolov5l-Transfusion 640, batch 4, bf16,
    phase 4b's seeded weights) quantized at the default scheme on two
    seeded batches, three requests counted (int8 launches held to the
    modules), every int8 conv of a forward against its plain version, and
    device busy and idle share beside the bf16 engine's. Returns (the
    kernels line's entry, the counted launches)."""
    from icafusion_tpu_torch.kernels.bn_act import bn_act_
    from icafusion_tpu_torch.models.assembler import build_model
    from icafusion_tpu_torch.models.zoo import icafusion_config
    from icafusion_tpu_torch.nn.layers import Conv
    from icafusion_tpu_torch.serve.engine import ServingEngine
    from icafusion_tpu_torch.utils.quantize import (detect_feeder_skip,
                                                    int8_conv_names)
    model = build_model(icafusion_config("l", nc=3, fusion="tfb"),
                        generator=torch.Generator().manual_seed(0))
    skip = detect_feeder_skip(model.cfg)
    n_convs = sum(isinstance(m, Conv) for m in model.modules())
    want_int8 = len(int8_conv_names(model, skip))
    assert skip == ("m30/cv3", "m33/cv3", "m36/cv3"), skip
    assert (n_convs, want_int8) == (165, INT8_CONVS_L), (n_convs, want_int8)
    rng = np.random.default_rng(11)
    batch = lambda n: tuple(rng.integers(0, 256, (n, 640, 640, 3), np.uint8)
                            for _ in range(2))
    engines = {"bf16": ServingEngine(model, 640, BATCH, conf_thres=0.001),
               "int8": ServingEngine(model, 640, BATCH, conf_thres=0.001)}
    t = time.perf_counter()
    assert engines["int8"].quantize([batch(BATCH), batch(BATCH)]) is False
    calib_s = time.perf_counter() - t
    n_int8 = sum(isinstance(m, Conv) and m.w8 is not None
                 for m in engines["int8"].model.modules())
    assert n_int8 == want_int8, n_int8
    pairs = [batch(n) for n in (BATCH, 3, BATCH)]
    engine = engines["int8"]
    engine.predict_arrays(*pairs[0])                  # warm-up
    torch.cuda.synchronize()
    n0 = bn_act_.launches
    results, launches = counted(
        lambda: [engine.predict_arrays(*p) for p in pairs], int8=True)
    # the float Convs, Detect's feeders, take the BatchNorm epilogue
    launches["bn_act_"] = bn_act_.launches - n0
    want = {"dual_cross_attention": 3 * len(pairs), "greedy_nms": len(pairs),
            "conv3x3_bn_silu": 0, "conv_int8_bn_act": n_int8 * len(pairs),
            "conv_int8_bn_act (stem)": 2 * len(pairs),
            "conv_int8_bn_act (grouped)": 0,
            "bn_act_": len(skip) * len(pairs)}
    assert launches == want, (launches, want)
    for (rgb, _), out in zip(pairs, results):
        assert len(out) == len(rgb)
        for x in out:
            assert x.ndim == 2 and x.shape[1] == 6 and len(x) <= 300
            assert np.isfinite(x).all()
    print(f"   calibrated (2 batches of {BATCH}) and quantized in "
          f"{calib_s:.1f} s: {n_int8} int8 convs of {n_convs} (Detect "
          f"feeders {', '.join(skip)} in bf16); launches in {len(pairs)} "
          f"requests {launches}; detections per image "
          f"{[[len(x) for x in out] for out in results]}")
    measured = {}
    for tag, eng in engines.items():
        eng.predict_arrays(*pairs[0])
        steady = []
        for _ in range(STEADY_REQUESTS):
            t = time.perf_counter()
            eng.predict_arrays(*pairs[0])
            steady.append(1e3 * (time.perf_counter() - t))
        wall = float(np.median(steady))
        print(f"   {tag} engine: {STEADY_REQUESTS} requests of {BATCH}, "
              f"median {wall:.2f} ms -> {1e3 * BATCH / wall:.1f} pairs/s")
        measured[tag] = profile_requests(eng, pairs[0], wall)
    if all(measured.values()):
        print(f"   device busy a request: int8 {measured['int8'][0]:.2f} ms "
              f"(idle share {measured['int8'][1]:.3f}), bf16 "
              f"{measured['bf16'][0]:.2f} ms (idle share "
              f"{measured['bf16'][1]:.3f}); {card} (not gated)")
    del engines["bf16"]
    torch.cuda.empty_cache()
    entry = int8_per_forward(engine, pairs[0])
    assert entry["convs"] == n_int8, entry["convs"]
    entry["device_busy"] = measured      # (busy ms, idle share) by engine
    return entry, launches


def int8_val_slice(work: Path, fp32_map50: float) -> None:
    """11c: trained s640 on extval through cli.val --int8 (fp32), held
    within MAP50_GATE of the JAX int8 record and of phase 7a's fp32 run;
    the same calibration served in bf16 by the Evaluator (printed); trained
    n320 cli.val --int8 held to its JAX int8 record. Each checkpoint is a
    symlink in ``work``, so the .calib files land there."""
    import copy as copy_

    from icafusion_tpu_torch.cli import val as cli_val
    from icafusion_tpu_torch.cli._common import load_model_for_inference
    from icafusion_tpu_torch.data.datasets import PairedDetectionDataset
    from icafusion_tpu_torch.data.loader import PairedLoader
    from icafusion_tpu_torch.eval.evaluator import Evaluator
    from icafusion_tpu_torch.utils.quantize import (calibration_key,
                                                    detect_feeder_skip,
                                                    int8_conv_names,
                                                    load_calibration,
                                                    quantize_model)

    def data_yaml(root: Path, name: str) -> Path:
        path = work / name
        path.write_text(f"path: {root}\nval_rgb: visible/val\n"
                        "val_ir: infrared/val\nnc: 3\n"
                        "names: ['red', 'green', 'blue']\n")
        return path

    for which, ckpt, cfg, root, size, batch in (
            ("s640", S640 / "stripped.ckpt", S640_CFG, S640 / "extval", 640,
             VAL_BATCH),
            ("n320", REPO / "artifacts" / "trained_n320" / "stripped.ckpt",
             "yolov5n_Transfusion.yaml",
             REPO / "artifacts" / "trained_n320" / "data", 320, VAL_BATCH)):
        t0 = phase(f"11c cli.val --int8 trained {which} fp32")
        link = work / f"{which}.ckpt"
        link.symlink_to(ckpt)
        data = data_yaml(root, f"{which}.yaml")
        argv = ["--weights", str(link), "--cfg", cfg, "--data", str(data),
                "--img-size", str(size), "--batch-size", str(batch),
                "--int8", "--save-dir", str(work / f"11c_{which}")]
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            r, launches = counted(lambda: cli_val.main(argv), int8=True)
        assert "calibration persisted" in said.getvalue(), said.getvalue()
        assert Path(str(link) + ".calib").is_file()
        _, model = load_model_for_inference(cfg, str(ckpt), nc=3)
        skip = detect_feeder_skip(model.cfg)
        n_int8 = len(int8_conv_names(model, skip))
        batches = -(-r["seen"] // batch)
        rec = int8_record(which)
        print(f"   int8 fp32: mAP@50 {r['map50']:.5f} mAP {r['map']:.5f} "
              f"over {r['seen']} pairs; JAX int8 record {rec:.5f} (delta "
              f"{100 * (r['map50'] - rec):+.3f} pts); the first int8 conv "
              f"design's {INT8_MAP50_FIRST[which]:.5f}"
              + (f", phase 7a fp32 {fp32_map50:.5f} (delta "
                 f"{100 * (r['map50'] - fp32_map50):+.3f} pts)"
                 if which == "s640" else "")
              + f"; {r['t_total_ms']:.2f} ms per image; launches {launches}")
        assert launches["conv_int8_bn_act"] == n_int8 * batches, (
            launches, n_int8, batches)
        assert abs(r["map50"] - rec) <= MAP50_GATE, (which, r["map50"])
        if which == "s640":
            assert abs(r["map50"] - fp32_map50) <= MAP50_GATE, r["map50"]
            key = calibration_key(str(link), extra={
                "imgsz": size, "calib_set": str(root / "visible" / "val"),
                "batch": batch})
            calib = load_calibration(str(link) + ".calib", key)
            assert calib is not None
            q = quantize_model(copy_.deepcopy(model), calib, skip=skip)
            ds = PairedDetectionDataset(str(root / "visible" / "val"),
                                        str(root / "infrared" / "val"), size,
                                        nc=3)
            rb = Evaluator(q, nc=3, dtype="bfloat16").run(
                PairedLoader(ds, batch).val_batches(), size)
            print(f"   int8 bf16 (the same calibration, not gated): mAP@50 "
                  f"{rb['map50']:.5f} mAP {rb['map']:.5f}; "
                  f"{rb['t_total_ms']:.2f} ms per image")
        done(t0)


def int8_http_slice(work: Path) -> None:
    """11d: the HTTP server with --int8 over s640 on 512 x 640, calibrated
    on 16 extval pairs: the first start writes <weights>.calib in ``work``,
    the second loads it; POSTs of 8 pairs give as many detections each as
    predict_arrays of the same letterboxed pair on the same engine."""
    import base64
    import http.client
    import threading

    from icafusion_tpu_torch.data.augment import letterbox
    from icafusion_tpu_torch.serve import http_server

    link = work / "s640_http.ckpt"
    link.symlink_to(S640 / "stripped.ckpt")
    ext = S640 / "extval"
    args = http_server.parse_args([
        "--weights", str(link), "--cfg", S640_CFG, "--img-size", "512x640",
        "--batch-size", "1", "--int8", "--calib-rgb",
        str(ext / "visible" / "val"), "--calib-ir",
        str(ext / "infrared" / "val")])
    said = []
    for _ in range(2):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            engine, batcher = http_server.build(args)
        said.append(out.getvalue())
        if len(said) == 1:
            batcher.close()
    n_calib = min(16, len(extval_files()[0]))
    assert (f"{n_calib} real pairs" in said[0]
            and "calibrated fresh" in said[0]), said
    assert "persisted calibration loaded" in said[1], said[1]
    assert Path(str(link) + ".calib").is_file()
    files1, files2 = (f[:8] for f in extval_files())
    srv = http_server.make_server(engine, batcher, ["red", "green", "blue"],
                                  host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    counts = []
    try:
        for a, b in zip(files1, files2):
            body = json.dumps({k: base64.b64encode(Path(f).read_bytes())
                               .decode() for k, f in (("rgb", a), ("ir", b))})
            conn = http.client.HTTPConnection("127.0.0.1",
                                              srv.server_address[1],
                                              timeout=300)
            conn.request("POST", "/v1/detect", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            conn.close()
            assert resp.status == 200, (resp.status, data[:200])
            counts.append(len(json.loads(data)))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        batcher.close()
    direct = []
    for a, b in zip(files1, files2):
        ia, ib = read_rgb(a), read_rgb(b)
        lb = [letterbox(im, RECT, auto=False, scaleup=True)[0][None]
              for im in (ia, ib)]
        direct.append(len(engine.predict_arrays(
            *lb, orig_hw=[ia.shape[:2]])[0]))
    print(f"   first start: calibrated on {n_calib} real pairs, "
          f"{link.name}.calib "
          f"written; second start: loaded; detections a POST {counts}, "
          f"predict_arrays {direct}")
    assert counts == direct, (counts, direct)


def int8_slice(card: str, fp32_map50: float):
    """Phase 11; returns (the int8 conv's kernels-line entry, its stem
    path's, the launches of 11b's counted requests)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = phase("11a int8 conv vs plain (B = 1, 4, 32; fp32, bf16)")
    int8_kernel_slice(gen)
    stem = int8_stem_slice(gen)
    done(t0)
    t0 = phase("11b int8 serving: yolov5l-Transfusion 640, b4, bf16")
    entry, launches = int8_serving_slice(card)
    done(t0)
    with tempfile.TemporaryDirectory() as tmp:
        int8_val_slice(Path(tmp), fp32_map50)
        t0 = phase("11d HTTP server --int8: s640 on 512 x 640")
        int8_http_slice(Path(tmp))
        done(t0)
    return entry, stem, launches
