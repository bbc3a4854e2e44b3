"""Phase 15 of chip_smoke.py: stream merging (utils/stream_merge.py) served,
validated and trained on the card, hyperparameter evolution through
cli.train --evolve, and the profiling helpers (utils/profiling.py).

(a) serves the flagship (phase 4b's seeded weights) merged at 3 pairs and
unmerged, in fp32 (TF32 off), bf16, int8 and int8 with fp32 float parts,
with each mode's device ms a request and its launches; (b) trained n320
through cli.val --merge 7, fp32 and int8; (c) three merged bf16 SGD steps
of yolov5l at 640 against unmerged ones; (d) cli.train --evolve 2 on phase
6c's data; (e) model_info, profile_layers and a trace."""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from icafusion_tpu_torch.smoke.common import (BATCH, MAP50_GATE, REPO,
                                              counted, device_ms, done,
                                              matched, phase, timing_source)

MERGE_L = 3          # yolov5l: the JAX package's auto rule (stem, 64 -> 128
                     # down-sample, C3(128) with 64-channel bottlenecks)
MERGE_N = 7          # yolov5n: its auto rule
FP32_TOL = 1e-3      # merged against unmerged decoded predictions, fp32
MATCH = 0.9          # detections at conf 0.25 matched both ways: the share
                     # over all detections, as phase 8c gates it (the
                     # seeded model fills max_det = 300 at conf 0.25, and
                     # bf16 rounding reorders the ties at the cap, so single
                     # images dip under the pooled share)
MERGED_FP32_MAP = 1e-4    # cli.val --merge against unmerged, fp32
TRAIN_LOSS_RTOL = 2e-2    # a bf16 step (tests/test_torch_port_trainer_bf16)
TRAIN_STEPS, TRAIN_BATCH = 3, 8
N320 = REPO / "artifacts" / "trained_n320"
N320_INT8_RECORD = 0.98016     # TRAINED_PARITY.json: the JAX int8 record


def _flagship():
    from icafusion_tpu_torch.models.assembler import build_model
    from icafusion_tpu_torch.models.zoo import icafusion_config
    return build_model(icafusion_config("l", nc=3),
                       generator=torch.Generator().manual_seed(0))


def _device_ms(engine, rgb, ir) -> float:
    """Device ms of a request's forward and NMS on uploaded pairs, its
    kernels summed (torch.profiler; queued_ms where CUPTI records
    nothing)."""
    from icafusion_tpu_torch.parallel.mesh import shard_batch
    xs, ys = (shard_batch(t, engine.mesh) for t in (rgb, ir))
    return device_ms(lambda: engine._serve(xs, ys), iters=10)


def _merged_int8_convs_exact(engine, pair) -> str:
    """Every int8 conv of one forward of a merged engine, on the input it
    was given: the kernel's int32 accumulators and output against its
    plain version (smoke/int8.int8_check raises on a difference); the
    merged stem (Cin 6) takes the stem path, every other conv the tma
    path from a channels_last map. Returns a summary line."""
    from icafusion_tpu_torch.kernels.conv_int8 import plan_for
    from icafusion_tpu_torch.nn.layers import Conv
    from icafusion_tpu_torch.smoke.int8 import int8_check
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, a: seen.append((mod, a[0])))
        for m in engine.model.modules()
        if isinstance(m, Conv) and m.w8 is not None]
    err, paths = 0.0, {}
    with torch.inference_mode():
        x, y = (torch.from_numpy(a).cuda().permute(0, 3, 1, 2).float() / 255
                for a in pair)
        engine.model(x.to(engine.dtype), y.to(engine.dtype))
        for h in hooks:
            h.remove()
        for mod, inp in seen:
            bn = mod.bn
            args = (inp, mod.w8, mod.s_in, mod.s_w,
                    (bn.weight, bn.bias, bn.running_mean, bn.running_var,
                     bn.eps), mod.conv.stride, mod.conv.padding)
            err = max(err, int8_check(args, isinstance(mod.act,
                                                       torch.nn.SiLU)))
            path = plan_for(inp, mod.w8, mod.conv.stride,
                            mod.conv.padding).path
            nhwc = inp.is_contiguous(memory_format=torch.channels_last)
            cin = mod.w8.shape[3]
            assert (path == "stem" if cin == 6 else
                    (path == "tma" and nhwc)), (tuple(mod.w8.shape), path)
            paths[path] = paths.get(path, 0) + 1
    return (f"{len(seen)} int8 convs of a merged forward equal their plain "
            f"versions (max |err| {err:.3g}; paths {paths})")


# (tag, engine dtype, int8): int8 serves bf16 around its convs, as phase
# 11b; "int8 fp32" keeps the float parts in fp32
MODES = (("float32", "float32", False), ("bfloat16", "bfloat16", False),
         ("int8", "bfloat16", True), ("int8 fp32", "float32", True))


def _shares(got_reqs, want_reqs):
    """(share of got matched in want, share of want matched in got, the
    worst image's lesser share, detections in got), over all images."""
    got = [x for req in got_reqs for x in req]
    want = [x for req in want_reqs for x in req]
    fwd, back = (sum(matched(x, y) * len(x) for x, y in zip(a, b))
                 / max(sum(map(len, a)), 1)
                 for a, b in ((got, want), (want, got)))
    worst = min(min(matched(x, y), matched(y, x)) for x, y in zip(got, want))
    return fwd, back, worst, sum(map(len, got))


def serving_slice(card: str) -> dict:
    """15a: the flagship at 640, batch 4, unmerged and merge_streams=3 in
    each of MODES: fp32 (TF32 off) decoded predictions within FP32_TOL;
    detections at conf 0.25 matched both ways (>= MATCH) in fp32, bf16
    and int8 fp32; in int8 (bf16) every int8 conv of a merged forward
    exact against its plain version, and the match printed beside the
    unmerged int8 engine's against the unmerged bf16 engine (not gated:
    the seeded model saturates max_det, and any rounding change moves
    int8's ties there). Each mode's device ms a request merged and
    unmerged, and the launches of three counted requests. Returns the
    merged requests' launches."""
    from icafusion_tpu_torch.nn.layers import Conv
    from icafusion_tpu_torch.serve.engine import ServingEngine
    model = _flagship()
    rng = np.random.default_rng(15)
    batch = lambda: tuple(rng.integers(0, 256, (BATCH, 640, 640, 3),
                                       np.uint8) for _ in range(2))
    pairs = [batch() for _ in range(3)]
    calib = [batch(), batch()]
    dev = [torch.from_numpy(a).cuda() for a in pairs[0]]
    total: dict = {}
    rows, outs = {}, {}
    for tag, dtype, int8 in MODES:
        t0 = phase(f"15a serving merged ({MERGE_L} pairs) vs unmerged: "
                   f"yolov5l-Transfusion 640, b{BATCH}, {tag}")
        engines = {}
        for k in (0, MERGE_L):
            eng = ServingEngine(model, 640, BATCH, conf_thres=0.25,
                                dtype=dtype, merge_streams=k)
            if int8:
                assert eng.quantize(calib) is False
            assert eng.model.merge_pairs == k
            engines[k] = eng
            eng.predict_arrays(*pairs[0])                      # warm-up
            torch.cuda.synchronize()
            outs[(tag, k)], launches = counted(
                lambda: [eng.predict_arrays(*p) for p in pairs], int8=True)
            n_int8 = sum(isinstance(m, Conv) and m.w8 is not None
                         for m in eng.model.modules())
            assert launches["dual_cross_attention"] == 3 * len(pairs)
            assert launches["greedy_nms"] == len(pairs), launches
            assert launches["conv_int8_bn_act"] == n_int8 * len(pairs)
            # merging turns the six 64-channel 3x3 convs into three
            # 128-channel ones, which the fused kernel does not take
            fused = 0 if (k or int8) else 6
            assert launches["conv3x3_bn_silu"] == fused * len(pairs), (
                launches)
            if k:
                for name, v in launches.items():
                    total[name] = total.get(name, 0) + v
            rows[(tag, k)] = _device_ms(eng, *dev)
            print(f"   merge {k}: launches in {len(pairs)} requests "
                  f"{launches} ({n_int8} int8 convs a forward); device ms a "
                  f"request {rows[(tag, k)]:.4f} ({timing_source()}); {card}")
        if tag == "float32":
            x = [(torch.from_numpy(a).cuda().permute(0, 3, 1, 2).float()
                  / 255.0) for a in pairs[0]]
            with torch.inference_mode():
                want = engines[0].model(*x)
                got = engines[MERGE_L].model(*x)
            err = (got - want).abs().max().item()
            torch.testing.assert_close(got, want, rtol=FP32_TOL,
                                       atol=FP32_TOL)
            print(f"   fp32 decoded predictions merged vs unmerged: max "
                  f"|diff| {err:.3g} (rtol/atol {FP32_TOL:g}, TF32 off)")
        fwd, back, worst, n_got = _shares(outs[(tag, MERGE_L)],
                                          outs[(tag, 0)])
        print(f"   detections at conf 0.25: merged {n_got}; matched "
              f"{fwd:.4f}, back {back:.4f}; the worst image {worst:.4f}")
        if tag == "int8":
            print(f"   {_merged_int8_convs_exact(engines[MERGE_L], pairs[0])}")
            base = _shares(outs[("int8", 0)], outs[("bfloat16", 0)])
            print(f"   (not gated) the unmerged int8 engine against the "
                  f"unmerged bf16 one: matched {base[0]:.4f}, back "
                  f"{base[1]:.4f}")
        else:
            assert n_got > 0 and min(fwd, back) >= MATCH, (tag, fwd, back)
        a, b = rows[(tag, MERGE_L)], rows[(tag, 0)]
        print(f"   {tag}: merged {a:.4f} ms vs unmerged {b:.4f} ms a "
              f"request ({100 * (a / b - 1):+.1f} %)")
        del engines
        torch.cuda.empty_cache()
        done(t0)
    print("   device ms a request (merged / unmerged): " + json.dumps(
        {tag: [round(rows[(tag, MERGE_L)], 4), round(rows[(tag, 0)], 4)]
         for tag, _, _ in MODES}))
    return total


def val_slice(work: Path) -> dict:
    """15b: trained n320 (77 val pairs at 320) through cli.val --merge 7:
    fp32 within MERGED_FP32_MAP of the unmerged run, and --int8 --merge 7
    within MAP50_GATE of the JAX int8 record. The checkpoint is a symlink
    in ``work``, so the .calib file lands there. Returns the launches of
    the merged runs."""
    from icafusion_tpu_torch.cli import val as cli_val
    from icafusion_tpu_torch.smoke.val import VAL_BATCH
    t0 = phase(f"15b cli.val --merge {MERGE_N}: trained n320, fp32 and int8")
    link = work / "n320.ckpt"
    link.symlink_to(N320 / "stripped.ckpt")
    data = work / "n320.yaml"
    data.write_text(f"path: {N320 / 'data'}\nval_rgb: visible/val\n"
                    "val_ir: infrared/val\nnc: 3\n"
                    "names: ['red', 'green', 'blue']\n")
    total: dict = {}
    res = {}
    for tag, extra in (("unmerged", []), ("merged", ["--merge",
                                                     str(MERGE_N)]),
                       ("merged int8", ["--merge", str(MERGE_N), "--int8"])):
        argv = ["--weights", str(link), "--cfg", "yolov5n_Transfusion.yaml",
                "--data", str(data), "--img-size", "320", "--batch-size",
                str(VAL_BATCH), "--save-dir", str(work / tag.replace(" ", "_")),
                *extra]
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            r, launches = counted(lambda: cli_val.main(argv), int8=True)
        res[tag] = r
        if tag != "unmerged":
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
        print(f"   {tag}: mAP@50 {r['map50']:.5f} mAP {r['map']:.5f} over "
              f"{r['seen']} pairs, {r['t_total_ms']:.2f} ms per image; "
              f"launches {launches}")
    d = res["merged"]["map50"] - res["unmerged"]["map50"]
    q = res["merged int8"]["map50"] - N320_INT8_RECORD
    print(f"   fp32 merged - unmerged {d:+.2e} (gate {MERGED_FP32_MAP:g}); "
          f"int8 merged - JAX int8 record {N320_INT8_RECORD} "
          f"{100 * q:+.3f} pts (gate {100 * MAP50_GATE:.1f})")
    assert abs(d) <= MERGED_FP32_MAP, d
    assert abs(q) <= MAP50_GATE, q
    assert Path(str(link) + ".calib").is_file()
    done(t0)
    return total


def _train_batches(data_yaml: Path, n: int):
    """n batches of TRAIN_BATCH at 640 from the PairedLoader over phase
    6b's synthetic pairs, on the card."""
    from icafusion_tpu_torch.config import load_data_config, load_hyp_config
    from icafusion_tpu_torch.data.datasets import PairedDetectionDataset
    from icafusion_tpu_torch.data.loader import PairedLoader
    dc = load_data_config(data_yaml)
    root = Path(dc.path)
    ds = PairedDetectionDataset(str(root / dc.train_rgb),
                                str(root / dc.train_ir), 640, nc=dc.nc,
                                hyp=load_hyp_config("hyp.scratch.yaml"),
                                augment=True)
    host = list(PairedLoader(ds, TRAIN_BATCH, max_targets=128, seed=0,
                             num_workers=8).epoch(0))[:n]
    img = lambda a: (torch.from_numpy(a).cuda().permute(0, 3, 1, 2).float()
                     .div_(255.0))
    return [(img(b["rgb"]), img(b["ir"]), torch.from_numpy(b["targets"])
             .cuda(), torch.from_numpy(b["mask"]).cuda()) for b in host]


def train_slice(data_yaml: Path, work: Path, card: str) -> None:
    """15c: TRAIN_STEPS bf16 SGD steps of yolov5l-Transfusion at 640, batch
    8, merged at 3 pairs with the gradient mask, against the same steps
    unmerged from the same weights (runs unmerged, merged, unmerged,
    merged: the first run of a process pays cuDNN's and the allocator's
    warm-up): each loss within TRAIN_LOSS_RTOL, the zero blocks of the
    parameters, momentum and EMA exactly 0; a merged trainer's checkpoint,
    written unmerged, loads into an unmerged model. Step times by the host
    clock, synchronised."""
    from icafusion_tpu_torch.config import load_hyp_config
    from icafusion_tpu_torch.models.assembler import build_model, init_weights
    from icafusion_tpu_torch.models.zoo import icafusion_config
    from icafusion_tpu_torch.train.trainer import Trainer
    from icafusion_tpu_torch.utils.checkpoint import (load_inference_variables,
                                                      save_checkpoint)
    from icafusion_tpu_torch.utils.convert import load_jax_variables
    from icafusion_tpu_torch.utils.stream_merge import (grad_mask,
                                                        merge_train_state,
                                                        unmerge_train_state)
    t0 = phase(f"15c training merged ({MERGE_L} pairs) vs unmerged: "
               f"yolov5l-Transfusion 640, b{TRAIN_BATCH}, bf16, SGD")
    batches = _train_batches(data_yaml, TRAIN_STEPS)
    assert len(batches) == TRAIN_STEPS, len(batches)
    cfg = icafusion_config("l", nc=3)
    base = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    hyp = load_hyp_config("hyp.scratch.yaml")
    runs = []                                  # (k, losses, step ms)
    for k in (0, MERGE_L, 0, MERGE_L):
        tr = Trainer(copy.deepcopy(base), hyp, epochs=10, steps_per_epoch=6,
                     batch_size=TRAIN_BATCH, imgsz=640, bf16=True)
        mask = None
        if k:
            tr = merge_train_state(cfg, tr, k)
            mask = grad_mask(cfg, tr.params, k)
        step = tr.make_train_step(grad_mask=mask)
        losses, ms = [], []
        for b in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(float(step(*b)["loss"]))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
        runs.append((k, losses, ms))
        print(f"   merge {k}: losses {[round(x, 5) for x in losses]}; step "
              f"ms {[round(x, 1) for x in ms]}; {card}")
        if k:
            for tree in (tr.params, tr.opt.momentum, tr.ema.tree):
                for name, m in mask.items():
                    t = tree[name].detach()
                    assert torch.equal(t * (1 - m), torch.zeros_like(t)), (
                        name)
            for a, b in zip(losses, runs[0][1]):
                assert (math.isfinite(a)
                        and abs(a - b) <= TRAIN_LOSS_RTOL * abs(b)), runs
        del tr
        torch.cuda.empty_cache()
    print(f"   zero blocks exactly 0 in {len(mask)} merged tensors of the "
          "parameters, momentum and EMA, both merged runs; losses within "
          f"{TRAIN_LOSS_RTOL:g} of the first unmerged run's")
    tr = merge_train_state(cfg, Trainer(copy.deepcopy(base), hyp, epochs=10,
                                        steps_per_epoch=6,
                                        batch_size=TRAIN_BATCH, imgsz=640,
                                        bf16=True), MERGE_L)
    path = work / "merged_train.ckpt"
    save_checkpoint(path, unmerge_train_state(cfg, tr, MERGE_L,
                                              device="cpu"), 0, 0.0)
    plain = load_jax_variables(build_model(cfg),
                               load_inference_variables(path))
    assert not plain.merge_pairs and hasattr(plain, "m0")
    print(f"   {path.name} ({path.stat().st_size / 2 ** 20:.1f} MiB) written "
          "unmerged from a merged trainer loads into an unmerged model")
    med = {k: float(np.median([x for kk, _, ms in runs if kk == k
                               for x in ms[1:]])) for k in (0, MERGE_L)}
    print(f"   step ms after each run's first (runs unmerged, merged, "
          f"unmerged, merged; host clock): merged {med[MERGE_L]:.1f}, "
          f"unmerged {med[0]:.1f} ({100 * (med[MERGE_L] / med[0] - 1):+.1f}"
          " %)")
    done(t0)


def evolve_slice(data_yaml: Path, work: Path) -> None:
    """15d: python -m icafusion_tpu_torch.cli.train --evolve 2 --epochs 1
    at yolov5n 320 on phase 6c's pairs: two rows in evolve.csv and
    hyp_evolved.yaml written, the plot skipped where matplotlib is
    absent."""
    import importlib.util

    import yaml

    from icafusion_tpu_torch.cli import train as cli_train
    t0 = phase("15d cli.train --evolve 2 --epochs 1: yolov5n 320, b16, bf16")
    project = work / "evolve"
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        best = cli_train.main([
            "--cfg", "yolov5n_Transfusion.yaml", "--data", str(data_yaml),
            "--hyp", "hyp.scratch.yaml", "--epochs", "1", "--batch-size",
            "16", "--img-size", "320", "--bf16", "--workers", "8",
            "--project", str(project), "--evolve", "2", "--noautoanchor"])
    rows = (project / "evolve.csv").read_text().splitlines()
    assert len(rows) == 3, rows
    saved = yaml.safe_load((project / "hyp_evolved.yaml").read_text())
    assert saved == best.as_dict(), saved
    if importlib.util.find_spec("matplotlib") is None:
        assert "the evolution plot is skipped" in said.getvalue()
    for line in said.getvalue().splitlines():
        if line.startswith(("evolve gen", "evolve done")):
            print(f"   {line}")
    print(f"   evolve.csv: {rows[0][:60]}... and {len(rows) - 1} rows")
    done(t0)


def profiling_slice(work: Path) -> None:
    """15e: model_info of yolov5l-Transfusion at 640 on the card equal to
    the CPU's; profile_layers' rows finite; start_trace/stop_trace write a
    trace that parses (which kernels it holds is not gated: CUPTI records
    nothing in some windows here)."""
    from icafusion_tpu_torch.utils import profiling
    t0 = phase("15e profiling: model_info, profile_layers, trace")
    model = _flagship()
    cpu = profiling.model_info(model, 640)
    card = profiling.model_info(model.cuda(), 640, verbose=False)
    assert card == cpu, (card, cpu)
    x = torch.rand(1, 3, 640, 640, device="cuda")
    rows = profiling.profile_layers(model, x, x, iters=3, verbose=False)
    assert len(rows) == len(model.resolved) - 1
    assert all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in rows), rows
    top = sorted(rows, key=lambda r: -r["ms"])[:5]
    print(f"   profile_layers: {len(rows)} rows, {sum(r['ms'] for r in rows):.2f}"
          f" ms in all (fp32, batch 1, CUDA events); slowest "
          + ", ".join(f"{r['i']} {r['module']} {r['ms']:.3f}" for r in top))
    profiling.start_trace(str(work / "trace"))
    with torch.inference_mode():
        model(x, x)
    path = Path(profiling.stop_trace())
    events = json.loads(path.read_text())["traceEvents"]
    n_dev = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"   trace {path.name}: {len(events)} events, {n_dev} device "
          "kernels (not gated)")
    del model
    torch.cuda.empty_cache()
    done(t0)


def merge_slice(card: str, data_yaml: Path, work: Path) -> dict:
    """Phase 15 in order; returns the kernels' launches on its merged
    paths (15a's merged requests and 15b's merged runs)."""
    t_all = time.perf_counter()
    total = serving_slice(card)
    for k, v in val_slice(work).items():
        total[k] = total.get(k, 0) + v
    train_slice(data_yaml, work, card)
    evolve_slice(data_yaml, work)
    profiling_slice(work)
    print(f"   phase 15: {time.perf_counter() - t_all:.1f} s")
    return total
