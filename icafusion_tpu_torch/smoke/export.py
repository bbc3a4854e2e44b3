"""Phase 14 of chip_smoke.py: export (cli/export.py: ONNX fp32, baked NMS
and int8 QDQ held by the numpy evaluator to the card, the torch.export
program holding the icafusion::* kernels), Grad-CAM through the float
kernels' autograd paths, the int8 conv's grouped path, and an ensemble.
Files go to a temporary directory."""

from __future__ import annotations

import copy
import time
from pathlib import Path

import numpy as np
import torch

from icafusion_tpu_torch.smoke.common import (BATCH, CONVS_PER_FORWARD,
                                              NCHW_KEY, REPO, S640, S640_CFG,
                                              bound, counted, done,
                                              extval_files, matched, phase,
                                              queued_ms)

DEV = "cuda"             # the card ("cpu" rehearses the phase at a tiny size)
FLAG_SPEC, FLAG_PX = "zoo:tfb:l", 640
# JAX tests/test_onnx_export.py test_int8_qdq_roundtrip's bound on the
# tiny random model (held there by tests/test_torch_port_onnx_export.py);
# printed here beside trained s640's deltas, not gated (see qdq_slice)
QDQ_BOUND = 0.05
QDQ_PAIRS = 4            # 14c: extval pairs 20-23, outside the calibration
QDQ_MATCH = 0.9          # 14c: detections matched both ways (13c's bf16 gate)
PT2_TOL = 1e-5           # the loaded program against the eager forward, fp32
CAM_TOL = 1e-3           # card against CPU saliency (fp32, TF32 off)
CAM_BACKBONE = 4         # n320: the C3 before layer 6's fused convs
GROUPED_BATCHES = (1, BATCH, 32)
# the grouped path's timed classes (Cin, Cout, k, s, H, W, groups) at the
# serving path's first C3 map (the kitchen sink's own maps are 32 x 32 at
# most): the kernels line's depthwise 3x3 64 -> 64 (GROUPED_SHAPE), and
# the four classes of tests/test_torch_port_int8_grouped.py: depthwise
# 32 -> 32 3x3, 32 -> 48 3x3 s2 in 2 groups, GhostConv's 16 -> 16 5x5
# depthwise, 24 -> 48 1x1 in 4 groups
GROUPED_SHAPE = (64, 64, 3, 1, 160, 160)
GROUPED_CLASSES = ((*GROUPED_SHAPE, 64), (32, 32, 3, 1, 160, 160, 32),
                   (32, 48, 3, 2, 160, 160, 2), (16, 16, 5, 1, 160, 160, 16),
                   (24, 48, 1, 1, 160, 160, 4))
QDQ_PX = 640             # 14c: trained s640 at its own size


def _add(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def flagship():
    """Phase 4b's seeded yolov5l-Transfusion (FLAG_SPEC), float32, eval, on
    the card."""
    from icafusion_tpu_torch.cli._common import resolve_model_config
    from icafusion_tpu_torch.models.assembler import build_model
    model = build_model(resolve_model_config(FLAG_SPEC),
                        generator=torch.Generator().manual_seed(0))
    return model.eval().to(DEV)


def _args(extra):
    from icafusion_tpu_torch.cli.export import parse_args
    return parse_args(["--weights", "seeded", "--cfg", FLAG_SPEC,
                       "--img-size", str(FLAG_PX), "--device", DEV,
                       *extra])


def nms_conf(model) -> float:
    """The lowest of a few confidence thresholds at which the validate
    pair has at most 4096 class candidates and ops/nms.py keeps between 1
    and 299 boxes: the ONNX tail caps each class at 300 and takes every
    candidate, where ops/nms.py caps the image and pools the top 4096, so
    the two keep the same set only where no cap binds (the JAX test's
    condition)."""
    from icafusion_tpu_torch.cli.export import _nchw, _random_pair
    from icafusion_tpu_torch.ops.nms import non_max_suppression
    rgb, ir = _random_pair(1, FLAG_PX)
    with torch.inference_mode():
        pred = model(_nchw(rgb, DEV), _nchw(ir, DEV))
        conf_all = pred[..., 5:] * pred[..., 4:5]
        for conf in (0.25, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9):
            n = int(non_max_suppression(pred, conf_thres=conf,
                                        multi_label=True, top_k=4096)
                    .valid.sum())
            if 0 < n < 300 and int((conf_all > conf).sum()) <= 4096:
                return conf
    raise AssertionError("no threshold keeps between 1 and 299 boxes")


def onnx_slices(model, work: Path, total: dict) -> None:
    """(a) the flagship's fp32 ONNX and (b) its --nms graph, each through
    cli.export's export_model with --validate: the numpy evaluator's run
    held to the port's forward on the card; 3 attention and 6 fused conv
    launches (and 1 NMS) in the validate forward, whose NCHW pair puts
    all 6 convs on the NCHW routes."""
    from icafusion_tpu_torch.cli.export import export_model
    mc = model.cfg
    for tag, extra in (("a", []), ("b", ["--nms", "--conf-thres",
                                         str(nms_conf(model))])):
        t = time.perf_counter()
        args = _args(["--include", "onnx", "--validate", *extra])
        ok, launches = counted(lambda: export_model(args, mc, model,
                                                    work / f"l640{tag}"),
                               nchw=True)
        size = (work / f"l640{tag}.onnx").stat().st_size
        want = {"dual_cross_attention": 3, "conv3x3_bn_silu":
                CONVS_PER_FORWARD, "greedy_nms": int(tag == "b"),
                NCHW_KEY: CONVS_PER_FORWARD}
        print(f"   14{tag}: {size} B ONNX{' (conf ' + extra[2] + ')' if extra else ''}, "
              f"export + numpy evaluator + card forward "
              f"{time.perf_counter() - t:.1f} s; launches {launches}")
        assert ok, f"14{tag}: the ONNX graph diverged from the card"
        assert launches == want, (launches, want)
        _add(total, launches)
        (work / f"l640{tag}.onnx").unlink()


def qdq_slice(work: Path, total: dict) -> None:
    """(c) trained s640 calibrated on 16 extval pairs (two batches of 8
    through cli.export's --calib-source1/2 letterbox), exported as fp32
    and int8 QDQ ONNX at batch 1 and run on QDQ_PAIRS extval pairs outside
    the calibration set: the QDQ graph's detections (conf 0.25) matched
    both ways, at QDQ_MATCH or more, against the card's int8 forward's and
    against the fp32 graph's; the largest score differences printed beside
    the 0.05 bound of JAX's test_int8_qdq_roundtrip, which holds on its
    tiny random model (tests/test_torch_port_onnx_export.py) but not on
    trained weights here: the QDQ graph quantizes each activation with one
    scale, the largest of its channels' (the JAX exporter's rendering,
    byte for byte), where the card keeps one a channel. The int8
    forward's launches counted."""
    from icafusion_tpu_torch.cli._common import load_model_for_inference
    from icafusion_tpu_torch.cli.export import _run_onnx, parse_args
    from icafusion_tpu_torch.cli.export import quantized_copy
    from icafusion_tpu_torch.data.decode import decode_letterbox_batch
    from icafusion_tpu_torch.export import onnx_proto
    from icafusion_tpu_torch.export.onnx_export import export_onnx
    from icafusion_tpu_torch.ops.nms import (detections_to_numpy,
                                             non_max_suppression)
    rgb_dir = S640 / "extval" / "visible" / "val"
    ir_dir = S640 / "extval" / "infrared" / "val"
    mc, model = load_model_for_inference(S640_CFG,
                                         str(S640 / "stripped.ckpt"))
    model = model.eval().to(DEV)
    args = parse_args(["--weights", str(S640 / "stripped.ckpt"), "--cfg",
                       S640_CFG, "--batch", "8", "--img-size", str(QDQ_PX),
                       "--include", "onnx",
                       "--int8", "--calib-source1", str(rgb_dir),
                       "--calib-source2", str(ir_dir), "--device", DEV])
    t = time.perf_counter()
    qmodel = quantized_copy(model, mc, args)
    fp_blob = export_onnx(model, batch=1, imgsz=QDQ_PX)
    q_blob = export_onnx(qmodel, batch=1, imgsz=QDQ_PX)
    rgbs, irs = extval_files()
    rgb, ir = decode_letterbox_batch(rgbs[20:20 + QDQ_PAIRS],
                                     irs[20:20 + QDQ_PAIRS], QDQ_PX,
                                     scaleup=True)[:2]
    rgb, ir = (a.astype(np.float32) / 255.0 for a in (rgb, ir))
    fp, q8 = (np.concatenate([_run_onnx(b, rgb[i:i + 1], ir[i:i + 1])
                              for i in range(QDQ_PAIRS)])
              for b in (fp_blob, q_blob))
    with torch.inference_mode():
        x, y = (torch.from_numpy(a.transpose(0, 3, 1, 2).copy()).to(DEV)
                for a in (rgb, ir))
        card, launches = counted(lambda: qmodel(x, y).cpu().numpy(),
                                 int8=True)
    n_int8 = sum(getattr(m, "w8", None) is not None and hasattr(m, "conv")
                 for m in qmodel.modules())
    dets = {k: detections_to_numpy(non_max_suppression(
        torch.from_numpy(o), 0.25, 0.45)) for k, o in (
            ("qdq", q8), ("card", card), ("fp32", fp))}
    share = {k: min(min(matched(a, b), matched(b, a))
                    for a, b in zip(dets["qdq"], dets[k]))
             for k in ("card", "fp32")}
    d_card, d_fp = (np.abs(q8[..., 4:] - o[..., 4:]) for o in (card, fp))
    ops = [n.op_type for n in onnx_proto.load(q_blob).nodes]
    print(f"   14c: s640 fp32 ONNX {len(fp_blob)} B, int8 QDQ {len(q_blob)} B "
          f"({ops.count('QuantizeLinear')} QDQ convs), "
          f"{time.perf_counter() - t:.1f} s; {QDQ_PAIRS} pairs: QDQ scores "
          f"vs the card's int8 forward max |diff| {d_card.max():.4f} (99th "
          f"percentile {np.quantile(d_card, 0.99):.4f}), vs the fp32 graph "
          f"{d_fp.max():.4f} ({np.quantile(d_fp, 0.99):.4f}); the tiny "
          f"model's bound {QDQ_BOUND} (not gated here); detections at conf "
          f"0.25 a pair: QDQ {[len(d) for d in dets['qdq']]}, card int8 "
          f"{[len(d) for d in dets['card']]}, fp32 "
          f"{[len(d) for d in dets['fp32']]}; least share matched both "
          f"ways: vs card int8 {share['card']:.4f}, vs fp32 "
          f"{share['fp32']:.4f}; int8 forward launches {launches}")
    assert launches["conv_int8_bn_act"] == n_int8, (launches, n_int8)
    _add(total, launches)
    assert ops.count("QuantizeLinear") == n_int8
    assert sum(map(len, dets["qdq"])) > 0
    assert min(share.values()) >= QDQ_MATCH, share


def pt2_slice(model, work: Path, total: dict) -> None:
    """(d) cli.export --include pt2 of the flagship on the card, fp32: 3
    icafusion::dual_cross_attention and 6 icafusion::conv3x3_bn_silu nodes
    in the program's graph; torch.export.load and a run within 1e-5 of the
    eager forward (bit-equality printed) with the kernels launched, the 6
    convs on the NCHW routes (the program's inputs are ordinary NCHW
    tensors), and its device ms a forward (queued_ms); then the same in
    bf16 (a program exported from the bf16 cast), its NMS detections
    matched against the eager bf16 forward's, printed."""
    import torch.export as texport
    from icafusion_tpu_torch.cli.export import (export_model, export_program,
                                                program_ops)
    from icafusion_tpu_torch.ops.nms import (detections_to_numpy,
                                             non_max_suppression)
    want_ops = {"dual_cross_attention": 3,
                "conv3x3_bn_silu": CONVS_PER_FORWARD}
    t = time.perf_counter()
    export_model(_args(["--include", "pt2"]), model.cfg, model,
                 work / "l640")
    export_s = time.perf_counter() - t
    program = texport.load(str(work / "l640.pt2"))
    assert program_ops(program) == want_ops, program_ops(program)
    g = torch.Generator(device=DEV).manual_seed(4)
    x, y = (torch.rand(1, 3, FLAG_PX, FLAG_PX, device=DEV, generator=g)
            for _ in range(2))
    run = program.module()
    with torch.inference_mode():
        got, launches = counted(lambda: run(x, y), nchw=True)
        want = model(x, y, logits=True)
        fwd_ms = queued_ms(lambda: run(x, y), iters=10)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"   14d: fp32 .pt2 {(work / 'l640.pt2').stat().st_size} B, export "
          f"+ save {export_s:.1f} s; nodes {program_ops(program)}; loaded run "
          f"vs eager max |diff| {err:.3g} (bit-equal: {equal}); launches "
          f"{launches}; device {fwd_ms:.3f} ms a forward (queued_ms)")
    assert err <= PT2_TOL * max(1.0, float(want[0].abs().max())), err
    assert launches == {**want_ops, "greedy_nms": 0,
                        NCHW_KEY: CONVS_PER_FORWARD}, launches
    _add(total, launches)
    (work / "l640.pt2").unlink()
    del program, run
    half = copy.deepcopy(model).cast(torch.bfloat16)
    t = time.perf_counter()
    prog16 = export_program(half, 1, FLAG_PX, dtype=torch.bfloat16)
    texport.save(prog16, str(work / "l640_bf16.pt2"))
    prog16 = texport.load(str(work / "l640_bf16.pt2"))
    assert program_ops(prog16) == want_ops, program_ops(prog16)
    run16 = prog16.module()
    with torch.inference_mode():
        xb, yb = x.bfloat16(), y.bfloat16()
        got16, launches16 = counted(lambda: run16(xb, yb), nchw=True)
        fwd16_ms = queued_ms(lambda: run16(xb, yb), iters=10)
        dets = [detections_to_numpy(non_max_suppression(p[0], 0.25, 0.45))
                for p in (got16, half(xb, yb, logits=True))]
    share = matched(dets[0][0], dets[1][0])
    print(f"   14d: bf16 .pt2 {time.perf_counter() - t:.1f} s; detections "
          f"{len(dets[0][0])} (program) vs {len(dets[1][0])} (eager), "
          f"matched {share:.4f} (printed, not gated); launches "
          f"{launches16}; device {fwd16_ms:.3f} ms a forward (queued_ms)")
    assert launches16 == {**want_ops, "greedy_nms": 0,
                          NCHW_KEY: CONVS_PER_FORWARD}, launches16
    _add(total, launches16)
    (work / "l640_bf16.pt2").unlink()


def gradcam_slice(total: dict) -> None:
    """(e) Grad-CAM on trained n320 at Detect's three inputs and at layer
    4 (the gradient crosses layer 6's fused convs and the fusion
    attention): the card's saliency against the port's on the CPU, from
    the decoded pair as it comes (channels_last: permuted NHWC bytes) and
    from an ordinary NCHW copy of it, whose fused convs take the NCHW
    routes."""
    from icafusion_tpu_torch.cli._common import load_model_for_inference
    from icafusion_tpu_torch.models.gradcam import (default_cam_layers,
                                                    gradcam_saliency)
    from icafusion_tpu_torch.data.decode import decode_letterbox_batch
    from icafusion_tpu_torch.data.datasets import discover_images
    ckpt = REPO / "artifacts" / "trained_n320"
    _, cpu = load_model_for_inference("zoo:tfb:n", str(ckpt / "stripped.ckpt"),
                                      nc=3)
    cpu.eval()
    card = copy.deepcopy(cpu).to(DEV)
    data = ckpt / "data"
    rgb, ir = decode_letterbox_batch(
        discover_images(str(data / "visible" / "val"))[:2],
        discover_images(str(data / "infrared" / "val"))[:2], 320)[:2]
    x, y = (torch.from_numpy(a).permute(0, 3, 1, 2).float() / 255
            for a in (rgb, ir))
    layers = default_cam_layers(cpu.cfg) + (CAM_BACKBONE,)
    for layer in layers:
        want = gradcam_saliency(cpu, x, y, layer, upsample_to=(320, 320))
        for tag, (xd, yd) in (("channels_last", (x.to(DEV), y.to(DEV))),
                              ("NCHW", (x.to(DEV).contiguous(),
                                        y.to(DEV).contiguous()))):
            got, launches = counted(lambda: gradcam_saliency(
                card, xd, yd, layer, upsample_to=(320, 320)).cpu(),
                nchw=True)
            err = float((got - want).abs().max())
            print(f"   14e: layer {layer}, {tag} pair: saliency card vs CPU "
                  f"max |diff| {err:.3g}, peak {float(got.max()):.3f}; "
                  f"launches {launches}")
            assert err <= CAM_TOL, (layer, tag, err)
            assert launches["dual_cross_attention"] == 6, launches
            assert launches["conv3x3_bn_silu"] > 0, launches
            if tag == "NCHW":
                assert launches[NCHW_KEY] > 0, launches
            _add(total, launches)
    assert all(p.grad is None for p in card.parameters())


def _grouped_convs(model):
    from icafusion_tpu_torch.nn.layers import Conv
    return {n: m for n, m in model.named_modules()
            if isinstance(m, Conv) and m.w8 is not None and m.conv.groups > 1}


def grouped_case(B: int, cls, gen):
    """(x, w8, s_in, s_w, bn, stride, padding, groups) of class ``cls``
    (GROUPED_CLASSES), bf16 channels_last: s_in x's absmax / 127 (one
    scalar, as quantize_model gives a grouped conv), random int8 weights,
    s_w scaling the sums to O(1), a BatchNorm away from identity."""
    Cin, Cout, k, s, H, W, g = cls
    rand = lambda *shape: torch.rand(*shape, device=DEV, generator=gen)
    x = torch.randn(B, Cin, H, W, device=DEV, generator=gen)
    x = (x * (0.25 + rand(Cin, 1, 1))).bfloat16().contiguous(
        memory_format=torch.channels_last)
    s_in = (x.float().abs().amax() / 127).reshape(())
    w8 = torch.randint(-127, 128, (Cout, k, k, Cin // g), device=DEV,
                       generator=gen, dtype=torch.int8)
    s_w = (0.5 + rand(Cout)) / (2000 * k * (Cin // g) ** 0.5)
    bn = (0.8 + 0.4 * rand(Cout), 0.2 * rand(Cout) - 0.1,
          0.2 * rand(Cout) - 0.1, 0.5 + rand(Cout), 1e-3)
    return x, w8, s_in, s_w, bn, s, k // 2, g


def grouped_slice(total: dict) -> dict:
    """(f) the kitchen-sink graph quantized (its GhostConv and
    GhostBottleneck depthwise convs grouped) with phase 13c's grouped
    64 -> 64 3x3 Conv beside it: at B = 1, 4 and 32 every grouped int8
    conv's int32 accumulators on its own input in a card forward equal the
    plain version's, on the "grouped" path; then each GROUPED_CLASSES
    class at B = 1, 4 and 32 (bf16, channels_last): accumulators exact,
    outputs within 3e-2 of the largest, timed (queued_ms) beside its
    bound, the plain version and cuDNN's bf16 grouped conv + SiLU. Returns
    the kernels line's entry (GROUPED_SHAPE at B = 4)."""
    import torch.nn.functional as F
    from icafusion_tpu_torch.kernels.conv_int8 import (
        conv_int8_bn_act, conv_int8_bn_act_reference, fold_epilogue, plan_for)
    from icafusion_tpu_torch.models.assembler import build_model
    from icafusion_tpu_torch.nn.layers import Conv
    from icafusion_tpu_torch.smoke.int8 import plan_text
    from icafusion_tpu_torch.smoke.reference import (SINK_PX,
                                                     kitchen_sink_config)
    from icafusion_tpu_torch.utils.quantize import calibrate, quantize_model
    model = build_model(kitchen_sink_config(),
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(15)
    pair = lambda n: [rng.uniform(0, 1, (n, SINK_PX, SINK_PX, 3)).astype(
        np.float32) for _ in range(2)]
    quantize_model(model, calibrate(model, [pair(BATCH), pair(BATCH)]))
    dw = Conv(64, 64, 3, 1, g=64).eval()
    quantize_model(dw, {"absmax": np.full(64, 3.0, np.float32)})
    model, dw = model.to(DEV), dw.to(DEV)
    grouped = _grouped_convs(model)
    assert len(grouped) >= 8, sorted(grouped)
    seen = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, a, n=n: seen.__setitem__(n, a[0]))
        for n, m in grouped.items()]
    for B in GROUPED_BATCHES:
        seen.clear()
        x, y = (torch.from_numpy(a).to(DEV).permute(0, 3, 1, 2)
                for a in pair(B))
        with torch.inference_mode():
            _, launches = counted(lambda: model(x, y), int8=True)
            seen["dw64"] = torch.randn(B, 64, 40, 40, device=DEV)
            dw(seen["dw64"])
            for n, inp in seen.items():
                m = dw if n == "dw64" else grouped[n]
                a = (inp, m.w8, m.s_in, m.s_w, None, m.conv.stride,
                     m.conv.padding)
                acc = conv_int8_bn_act(*a, epilogue=False,
                                       groups=m.conv.groups)
                ref = conv_int8_bn_act_reference(*a, epilogue=False,
                                                 groups=m.conv.groups)
                assert torch.equal(acc, ref), (n, B)
                assert plan_for(inp, m.w8, *a[5:], m.conv.groups).path \
                    == "grouped"
        grouped_n = launches["conv_int8_bn_act (grouped)"]
        print(f"   14f: B={B}: {len(seen)} grouped int8 convs, int32 "
              f"accumulators equal the plain version's; forward launches "
              f"{launches}, {grouped_n} of them grouped")
        assert grouped_n > 0, launches
        if B == BATCH:
            _add(total, launches)
    for h in hooks:
        h.remove()

    gen = torch.Generator(device=DEV).manual_seed(16)
    entry = None
    for cls in GROUPED_CLASSES:
        for B in GROUPED_BATCHES:
            x, w8, s_in, s_w, bn, s, p, g = grouped_case(B, cls, gen)
            a = (x, w8, s_in, s_w, bn, s, p)
            with torch.inference_mode():
                acc = conv_int8_bn_act(*a, epilogue=False, groups=g)
                out = conv_int8_bn_act(*a, groups=g)
                assert torch.equal(acc, conv_int8_bn_act_reference(
                    *a, epilogue=False, groups=g)), (cls, B)
                ref = conv_int8_bn_act_reference(*a, groups=g)
                err = float((out.float() - ref.float()).abs().max())
                assert err <= 3e-2 * float(ref.float().abs().max()), err
                mult, add = fold_epilogue(s_w, bn)
                w = (w8.permute(0, 3, 1, 2).float()
                     * mult[:, None, None, None]).bfloat16()
                lib = queued_ms(lambda: F.silu(F.conv2d(
                    x, w, add.bfloat16(), s, p, groups=g)), iters=10)
                ms = queued_ms(lambda: conv_int8_bn_act(*a, groups=g),
                               iters=10)
                plain = queued_ms(lambda: conv_int8_bn_act_reference(
                    *a, groups=g), iters=2, warmup=1)
            Cin, Cout, k, _, H, W, _ = cls
            Ho, Wo = out.shape[2:]
            bnd, by = bound(2 * B * Ho * Wo * Cout * k * k * Cin // g,
                            2 * B * (H * W * Cin + Ho * Wo * Cout)
                            + Cout * k * k * Cin // g + 4 * (6 * Cout + 1),
                            torch.int8)
            pl = plan_for(x, w8, s, p, g)
            print(f"   14f: B={B:2d} {str(cls):32s} bf16 {plan_text(pl)}: "
                  f"accumulators equal, max |err| {err:.3g}; queued ms: "
                  f"kernel {ms:.4f} bound {bnd:.5f} ({by}) plain "
                  f"{plain:.4f} cuDNN bf16 grouped {lib:.4f}")
            if cls[:6] == GROUPED_SHAPE and B == BATCH:
                entry = {"ms": ms, "plain_ms": plain, "bound_ms": bnd,
                         "library_ms": lib, "max_abs_err": err,
                         "bound_by": {by}}
            del x, a, acc, out, ref
        if DEV == "cuda":
            torch.cuda.empty_cache()
    return entry


def ensemble_slice(total: dict) -> None:
    """(g) two seeded yolov5n-Transfusion members at 320 on the card:
    ensemble_predict's candidates are each member's own, in order."""
    from icafusion_tpu_torch.models.assembler import build_model
    from icafusion_tpu_torch.models.ensemble import ensemble_predict
    from icafusion_tpu_torch.models.zoo import icafusion_config
    members = [build_model(icafusion_config("n", nc=3),
                           generator=torch.Generator().manual_seed(s))
               .eval().to(DEV) for s in (0, 1)]
    g = torch.Generator(device=DEV).manual_seed(17)
    x, y = (torch.rand(2, 3, 320, 320, device=DEV, generator=g)
            for _ in range(2))
    with torch.inference_mode():
        (pred, logits), launches = counted(
            lambda: ensemble_predict(members, x, y), nchw=True)
        own = [m(x, y, logits=True) for m in members]
    n = own[0][0].shape[1]
    for i, (p, l) in enumerate(own):
        assert torch.equal(pred[:, i * n:(i + 1) * n], p)
        assert torch.equal(logits[:, i * n:(i + 1) * n], l)
    _add(total, launches)
    print(f"   14g: 2 members, candidates {tuple(pred.shape)} equal each "
          f"member's own; launches {launches}")
    assert launches[NCHW_KEY] > 0, launches


def export_slice(card: str, work: Path):
    """Phase 14; returns (the grouped path's kernels line entry, the
    launches of its counted main-path runs)."""
    total: dict = {}
    t_all = time.perf_counter()
    t0 = phase("14a/b flagship ONNX (yolov5l-Transfusion 640, fp32, b1): "
               "--validate, then --nms --validate")
    print(f"   {card}")
    model = flagship()
    onnx_slices(model, work, total)
    done(t0)
    t0 = phase("14c int8 QDQ ONNX of trained s640 (16 extval pairs)")
    qdq_slice(work, total)
    if DEV == "cuda":
        torch.cuda.empty_cache()
    done(t0)
    t0 = phase("14d .pt2 of the flagship on the card (fp32, then bf16)")
    pt2_slice(model, work, total)
    del model
    if DEV == "cuda":
        torch.cuda.empty_cache()
    done(t0)
    t0 = phase("14e Grad-CAM on trained n320 (card vs CPU)")
    gradcam_slice(total)
    done(t0)
    t0 = phase("14f grouped int8 convs (kitchen sink, B = 1, 4, 32)")
    entry = grouped_slice(total)
    done(t0)
    t0 = phase("14g ensemble of two seeded yolov5n members")
    ensemble_slice(total)
    done(t0)
    print(f"   phase 14: {time.perf_counter() - t_all:.1f} s")
    return entry, total
