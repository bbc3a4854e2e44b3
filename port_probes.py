"""Measurements of the PyTorch/CUDA port on the card that chip_smoke.py's
gated run does not make. Each subcommand needs a CUDA device.

    python3 port_probes.py attention [--root DIR]

        Device time of the bfloat16 attention kernel (dual_cross_attention),
        by CUDA kernel (the projections and the flash core), at the
        flagship's three shapes (N, D) = (400, 256), (256, 512), (100, 1024)
        with B = 4 and h = 8, each call first held against the plain
        version. The package comes from DIR (default: this checkout), which
        builds its own kernels there, so that one call can compare two
        checkouts: parent, change, change, parent.

    python3 port_probes.py fp64

        How far fp32 decoded predictions lie from float64: the seeded
        ResNet50-Transfusion of phase 10a (smoke/configs.seeded_model, each
        bottleneck's last BatchNorm scale at 1.0, build_model's, and at
        phase 10a's 0.3) on one seeded image pair at 640, batch 1, run in fp32 on the card and on the CPU through
        ServingEngine's model as phase 10a runs it, and in float64 on the
        CPU; on the card also with cuDNN off (PyTorch's own convolutions).
        Prints, for each against float64 and for card - CPU, the largest
        |difference| and the allclose ratio at rtol = atol = 1e-3 (phase
        10a's gate; above 1 fails it), so a card-vs-CPU difference can be
        told apart from the conditioning of the model itself. Then, layer
        by layer, each layer's own error: the layer run in fp32 on the card
        and on the CPU from the float64 run's input rounded to fp32, its
        largest |difference| from the float64 run's output over that
        output's largest value, for every layer.

    python3 port_probes.py int8-splits

        The int8 conv's tma path under every (groups, splits) choice that
        fits shared memory, at the shape classes of smoke/int8.INT8_SHAPES
        whose output tiles leave the card idle, at B = 1 and 4 in bf16:
        each choice's int32 accumulators against the plain version, then
        its time (queued_ms), beside the choice of kernels/conv_int8.py:
        plan and how much slower that is than the fastest choice.

    python3 port_probes.py int8-phases

        Where a tma block's time goes: a copy of csrc/conv_int8.cu with
        globaltimer stamps (block start, window quantized, first output
        tile's products done, products and epilogue done, split-K finish
        pass entered) built beside build/, run at smoke/int8.INT8_SHAPES
        at B = 4 in bf16; prints the means over the blocks.

    python3 port_probes.py int8-forward

        chip_smoke.py's phase 11b alone (yolov5l-Transfusion 640, batch 4,
        bf16, quantized; each int8 conv of a forward timed on its own
        input), with the -Xptxas -v lines of the int8 kernels where this
        process built the library. Run it in several processes to see how
        far whole readings of the summed int8 time and of device busy
        spread on one build.

    python3 port_probes.py dist-faults

        Whether chip_smoke.py's phase 12b can fail: its one process on the
        global batch and its gates (smoke/parallel.dist_reference), then its
        two gloo ranks on cuda:0 three times, as they are and with a fault
        planted in both ranks at run time: the gradients averaged over the
        ranks where they must be summed, and BatchNorm's all-reduces
        skipped (each rank normalises by its own rows' statistics). Prints
        each run's losses, first-step gradients and state against the one
        process's, beside the gates, and whether the ranks' states are
        bit-equal.

    python3 port_probes.py reference

        chip_smoke.py's phase 13 alone (reference .pt weights, the legacy
        modules, fit from a single-stream .pt), after the kernels' build
        and phase 7a's cli.val of trained s640 from its .ckpt, whose
        mAP@50 13a must repeat; the synthetic pairs of phase 6 are made
        anew. Returns phase 13's launches.

Each prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
FLAGSHIP = ((400, 256), (256, 512), (100, 1024))
FP64_CFG, FP64_SIZE, FP64_SCALES = ("yolov5_ResNet50_Transfusion.yaml", 640,
                                    (1.0, 0.3))


def attention(root: Path) -> dict:
    sys.path.insert(0, str(root))
    from icafusion_tpu_torch.smoke import common as cs
    from icafusion_tpu_torch.kernels.cross_attention import (
        dual_cross_attention, dual_cross_attention_reference)
    assert Path(dual_cross_attention.__code__.co_filename).is_relative_to(
        root), dual_cross_attention.__code__.co_filename
    gen = torch.Generator().manual_seed(0)
    out = {}
    for N, D in FLAGSHIP:
        args = cs.attention_case(4, N, D, torch.bfloat16, gen)
        got = dual_cross_attention(*args, num_heads=8)
        want = dual_cross_attention_reference(*args, num_heads=8)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), rtol=3e-2,
                                       atol=3e-2)
        by = cs.device_times(lambda: dual_cross_attention(*args, num_heads=8),
                             iters=200, warmup=10)
        out[f"{N}x{D}"] = {k: round(v, 5) for k, v in sorted(by.items())
                           if v > 0}
        print(f"   (N, D) = ({N}, {D}), B 4, bf16: {out[f'{N}x{D}']} ms "
              f"({cs.timing_source()})", flush=True)
    return out


def _at_least_fp32():
    """Make Tensor.float() leave float64 tensors as they are, so that the
    model's float32 steps (LayerNorm inputs, the logits, Detect's sigmoid)
    stay in float64 for a float64 run."""
    to_fp32 = torch.Tensor.float

    def at_least(t, *a, **k):
        return t if t.dtype == torch.float64 else to_fp32(t, *a, **k)

    torch.Tensor.float = at_least


def allclose_ratio(a: torch.Tensor, b: torch.Tensor, tol: float = 1e-3):
    """max |a - b| / (tol + tol |b|): at most 1 where allclose(a, b, tol,
    tol) holds."""
    a, b = a.double(), b.double()
    return ((a - b).abs() / (tol + tol * b.abs())).max().item()


def _cast(x, dtype, dev):
    """x, or the tensors in a list or tuple x, as dtype on dev."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, dtype)
    return type(x)(_cast(v, dtype, dev) for v in x)


def _rel_err(got, want) -> float:
    """max |got - want| / max |want| over the tensors of got and want."""
    if isinstance(want, torch.Tensor):
        got, want = got.double().cpu(), want.double()
        return ((got - want).abs().max() / want.abs().max()).item()
    return max(_rel_err(g, w) for g, w in zip(got, want))


def fp64(cfg_name: str, imgsz: int, scales) -> dict:
    sys.path.insert(0, str(HERE))
    from icafusion_tpu_torch.smoke import configs as cs
    from icafusion_tpu_torch.config import load_model_config
    from icafusion_tpu_torch.serve.engine import ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(10)
    pair = [rng.integers(0, 256, (1, imgsz, imgsz, 3), np.uint8)
            for _ in range(2)]
    _at_least_fp32()
    out = {}
    for scale in scales:
        model = cs.seeded_model(load_model_config(cfg_name), scale)
        engines = {dev: ServingEngine(model, imgsz, 1, conf_thres=0.001,
                                      dtype="float32", device=dev)
                   for dev in ("cuda", "cpu")}
        m64 = copy.deepcopy(engines["cpu"].model).double()
        del model
        preds = {}
        with torch.inference_mode():
            for dev, eng in engines.items():
                x, y = (torch.from_numpy(a).to(dev).permute(0, 3, 1, 2)
                        .float() / 255 for a in pair)
                preds[dev] = eng.model(x, y).cpu()
                if dev == "cuda":
                    torch.backends.cudnn.enabled = False
                    preds["cuda, cuDNN off"] = eng.model(x, y).cpu()
                    torch.backends.cudnn.enabled = True
            ins, outs, hooks = {}, {}, []
            for n, m in m64.named_children():
                hooks.append(m.register_forward_pre_hook(
                    lambda mod, a, n=n: ins.__setitem__(n, a[0])))
                hooks.append(m.register_forward_hook(
                    lambda mod, a, o, n=n: outs.__setitem__(n, o)))
            x, y = (torch.from_numpy(a).permute(0, 3, 1, 2).double() / 255
                    for a in pair)
            preds["cpu64"] = m64(x, y)
            for h in hooks:
                h.remove()
            assert preds["cpu64"].dtype == torch.float64
            own = {}
            for n in outs:
                own[n] = {dev: _rel_err(getattr(eng.model, n)(
                    _cast(ins[n], torch.float32, dev)), outs[n])
                    for dev, eng in engines.items()}
                own[n]["module"] = type(getattr(m64, n)).__name__
        del m64, engines, ins, outs
        torch.cuda.empty_cache()
        row = {}
        for tag, a, b in (("card - float64", "cuda", "cpu64"),
                          ("card (cuDNN off) - float64", "cuda, cuDNN off",
                           "cpu64"),
                          ("cpu - float64", "cpu", "cpu64"),
                          ("card - cpu", "cuda", "cpu")):
            d = (preds[a].double() - preds[b].double()).abs()
            row[tag] = {"max_abs": d.max().item(),
                        "allclose_ratio_1e-3": allclose_ratio(preds[a],
                                                              preds[b])}
        row["float64 max |pred|"] = preds["cpu64"].abs().max().item()
        out[f"residual_scale {scale}"] = row
        print(f"   {cfg_name} at {imgsz}, residual scale {scale}: "
              f"{json.dumps(row)}", flush=True)
        print("   each layer's own fp32 error, max |diff| / max |float64| "
              "(card, CPU):")
        for n in own:
            print(f"     {n} {own[n]['module']}: {own[n]['cuda']:.3g}, "
                  f"{own[n]['cpu']:.3g}")
    return out


def _int8_classes(batches=(4, 1)):
    from icafusion_tpu_torch.smoke import int8 as cs
    for B in batches:
        for shape in cs.INT8_SHAPES:
            if shape[0] % 16 == 0:          # the stem takes the direct path
                yield B, shape


def _with_split(pl, Cin, Cout, k, s, groups, units):
    """``pl`` (a tma plan of that conv) with ``groups`` blocks across Cout
    and ``units`` 32-channel units a split, or None where that does not
    fit shared memory."""
    from icafusion_tpu_torch.kernels import conv_int8 as ci
    n_tiles = -(-Cout // ci.N_TILE)
    npg = -(-n_tiles // groups)
    groups, splits = -(-n_tiles // npg), -(-(-(-Cin // ci.UNIT)) // units)
    chunks = -(-(units * ci.UNIT) // ci.Q_CH)
    grid = pl.tiles * groups * splits
    ring = ci._ring((pl.tile, k, k, s), chunks, npg, grid)
    if ring is None:
        return None
    return dataclasses.replace(
        pl, groups=groups, n_per_group=npg, splits=splits, slice_units=units,
        chunks=chunks, b_stages=ring[0], layout=ring[1], grid=grid)


def int8_splits() -> dict:
    from icafusion_tpu_torch.smoke import int8 as cs
    from icafusion_tpu_torch.kernels import conv_int8 as ci
    gen = torch.Generator(device="cuda").manual_seed(0)
    out, losses = {}, []
    for B, shape in _int8_classes():
        args = cs.int8_case(B, shape, torch.bfloat16, gen)
        Cin, Cout, k, s, H, W = shape
        pl = ci.plan_for(args[0], args[1], args[5], args[6])
        if pl.tiles >= 2 * ci.SMS:
            continue
        ref = ci.conv_int8_bn_act_reference(*args, epilogue=False)
        U, n_tiles = -(-Cin // ci.UNIT), -(-Cout // ci.N_TILE)
        times = {}
        for g in sorted({-(-n_tiles // -(-n_tiles // g))
                         for g in range(1, n_tiles + 1)}):
            for units in sorted({-(-U // sp) for sp in
                                 (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)}):
                v = _with_split(pl, Cin, Cout, k, s, g, units)
                if v is None or v.grid > 1024 or (v.groups, v.splits) in times:
                    continue
                got = ci._launch(*args, True, False, v)
                assert torch.equal(got, ref), (B, shape, v)
                times[(v.groups, v.splits)] = cs.queued_ms(
                    lambda: ci._launch(*args, True, True, v),
                    iters=10, warmup=2)
        best = min(times, key=times.get)
        mine = times[(pl.groups, pl.splits)]
        losses.append(mine / times[best] - 1)
        order = sorted(times, key=times.get)
        print(f"   B={B} {str(shape):28s} tiles {pl.tiles}: plan G{pl.groups}"
              f" S{pl.splits} {mine:.4f} ms; fastest "
              + ", ".join(f"G{g}S{sp} ({pl.tiles * g * sp}) "
                          f"{times[(g, sp)]:.4f}" for g, sp in order[:5]),
              flush=True)
        out[f"B={B} {shape}"] = {"plan": [pl.groups, pl.splits],
                                 "plan_ms": mine, "best": list(best),
                                 "best_ms": times[best]}
        del args, ref
    out["plan_over_fastest_mean"] = float(np.mean(losses))
    out["plan_over_fastest_max"] = float(np.max(losses))
    return out


def int8_phases() -> dict:
    import ctypes
    from icafusion_tpu_torch.smoke import int8 as cs
    from icafusion_tpu_torch.kernels import _build
    from icafusion_tpu_torch.kernels import conv_int8 as ci
    src = (HERE / "icafusion_tpu_torch" / "csrc" / "conv_int8.cu").read_text()
    stamps = (
        ("namespace tma {", "namespace tma {\n__device__ unsigned long long "
         "g_t[1 << 18];\n__device__ __forceinline__ unsigned long long now() "
         "{ unsigned long long t; asm volatile(\"mov.u64 %0, %%globaltimer;\""
         " : \"=l\"(t)); return t; }"),
        ("  if (warp == kConsumers / 32) {   // the producer",
         "  if (tid == 0) g_t[blockIdx.x * 5] = now();\n"
         "  if (warp == kConsumers / 32) {   // the producer"),
        ("  named_barrier(1, kConsumers);\n\n  // 2. Products",
         "  named_barrier(1, kConsumers);\n"
         "  if (tid == 0) g_t[blockIdx.x * 5 + 1] = now();\n\n  // 2. Products"),
        ("    const int n0 = nt * kN;",
         "    if (tid == 0 && nt == nt0) g_t[blockIdx.x * 5 + 2] = now();\n"
         "    const int n0 = nt * kN;"),
        ("  if (p.splits == 1) return;",
         "  if (tid == 0) g_t[blockIdx.x * 5 + 3] = now();\n"
         "  if (p.splits == 1) return;"),
        ("  if (!*flag) return;",
         "  if (!*flag) return;\n"
         "  if (tid == 0) g_t[blockIdx.x * 5 + 4] = now();"))
    for a, b in stamps:
        assert a in src, a
        src = src.replace(a, b, 1)
    src += ('\nextern "C" int icaf_stamps(void* host, int n) {\n'
            '  return cudaMemcpyFromSymbol(host, tma::g_t, n * 8);\n}\n'
            'extern "C" int icaf_stamps_zero() {\n'
            '  static unsigned long long z[1 << 18];\n'
            '  return cudaMemcpyToSymbol(tma::g_t, z, sizeof(z));\n}\n')
    work = _build.BUILD_DIR / "int8_phases"
    work.mkdir(parents=True, exist_ok=True)
    (work / "conv_int8.cu").write_text(src)
    (work / "hopper.cuh").write_text(
        (_build.CSRC / "hopper.cuh").read_text())
    subprocess.run([_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o",
                    str(work / "lib.so"), str(work / "conv_int8.cu")],
                   check=True)
    lib = ctypes.CDLL(str(work / "lib.so"))
    lib.icaf_conv_int8_tma.argtypes = _build.SIGNATURES["icaf_conv_int8_tma"]
    lib.icaf_stamps.argtypes = (ctypes.c_void_p, ctypes.c_int)
    real = _build.library

    def stamped():
        return lib
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    _build.library = stamped       # the wrapper launches the stamped copy
    try:
        for B, shape in _int8_classes((4,)):
            args = cs.int8_case(B, shape, torch.bfloat16, gen)
            pl = ci.plan_for(args[0], args[1], args[5], args[6])
            for _ in range(3):
                ci.conv_int8_bn_act(*args)
            torch.cuda.synchronize()
            lib.icaf_stamps_zero()
            ci.conv_int8_bn_act(*args)
            torch.cuda.synchronize()
            t = np.zeros(pl.grid * 5, np.uint64)
            lib.icaf_stamps(t.ctypes.data, pl.grid * 5)
            t = t.reshape(-1, 5).astype(np.int64) / 1e3
            row = {"blocks": pl.grid,
                   "span_us": float(t[:, 3].max() - t[:, 0].min()),
                   "quantize_us": float((t[:, 1] - t[:, 0]).mean()),
                   "first_tile_us": float((t[:, 2] - t[:, 1]).mean()),
                   "rest_us": float((t[:, 3] - t[:, 2]).mean())}
            fin = t[:, 4] > 0
            if fin.any():
                row["finish_us"] = float((t[fin, 4] - t[fin, 3]).mean())
            print(f"   B={B} {str(shape):28s}: {json.dumps(row)}",
                  flush=True)
            out[f"B={B} {shape}"] = row
    finally:
        _build.library = real
    return out


def int8_forward(card: str) -> dict:
    import re
    from icafusion_tpu_torch.smoke import int8 as cs
    from icafusion_tpu_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False    # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    log = _build.build().log             # empty where already built
    for name, stats in re.findall(
            r"Compiling entry function '(\w*conv_int8\w*)'.*?\n(.*?"
            r"registers)", log, re.S):
        print(f"   {name[-60:]}: " + "; ".join(
            line.split(":")[-1].strip() for line in stats.splitlines()
            if "spill" in line or "registers" in line))
    entry, _ = cs.int8_serving_slice(card)
    busy = entry["device_busy"]
    return {"sum_ms": entry["ms"], "cudnn_ms": entry["library_ms"],
            "bound_ms": entry["bound_ms"],
            "busy_ms": {k: v and v[0] for k, v in busy.items()},
            "idle_share": {k: v and v[1] for k, v in busy.items()}}


DIST_FAULTS = (None, "gradients averaged", "BatchNorm local")


def _fault_rank(ref_path: str, fault) -> dict:
    """One rank of chip_smoke.py's 12b fp32 steps with ``fault`` planted."""
    from icafusion_tpu_torch.smoke import parallel as cs
    if fault == "gradients averaged":
        from icafusion_tpu_torch.parallel.mesh import world
        from icafusion_tpu_torch.train.trainer import Trainer
        real = Trainer._all_reduce

        def averaged(self, grads, *metrics):
            real(self, grads, *metrics)
            for g in grads.values():
                g.div_(world())

        Trainer._all_reduce = averaged
    elif fault == "BatchNorm local":
        from icafusion_tpu_torch.nn import layers
        layers.all_reduce_sum = lambda x: x
    return cs.dist_rank_fp32(ref_path)[0]


def dist_faults() -> dict:
    import tempfile
    from icafusion_tpu_torch.smoke import parallel as cs
    from icafusion_tpu_torch.parallel import mesh
    torch.backends.cuda.matmul.allow_tf32 = False    # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        ref = str(Path(tmp) / "ref.pt")
        losses, drift, tol, _ = cs.dist_reference(Path(ref))
        res["one process"] = {"losses": [r["loss"] for r in losses],
                              "drift": drift, "gate": tol}
        print(f"   one process: losses {[r['loss'] for r in losses]}")
        for fault in DIST_FAULTS:
            out = mesh.spawn(_fault_rank, 2, (ref, fault), backend="gloo",
                             timeout=400)
            name = fault or "as shipped"
            failed = [k for k in tol if out[k] > tol[k]]
            res[name] = {**{k: out[k] for k in tol},
                         "losses": [r["loss"] for r in out["losses"]],
                         "equal": out["equal"], "fails": failed}
            print(f"   {name}: losses {res[name]['losses']}")
            for k, what in cs.DIST_MEASURES:
                print(f"     {what}: {out[k]:.3g} (gate {tol[k]:.3g}"
                      f"{', fails' if k in failed else ''})")
            print(f"     state bit-equal across ranks: {out['equal']}")
    return res


def reference(card: str) -> dict:
    import tempfile

    from icafusion_tpu_torch.cli import val as cli_val
    from icafusion_tpu_torch.data.synthetic import make_dataset
    from icafusion_tpu_torch.kernels import _build
    from icafusion_tpu_torch.smoke.common import S640, S640_CFG
    from icafusion_tpu_torch.smoke.reference import reference_slice
    from icafusion_tpu_torch.smoke.val import VAL_BATCH
    torch.backends.cuda.matmul.allow_tf32 = False    # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        ext = S640 / "extval"
        (work / "extval.yaml").write_text(
            f"path: {ext}\nval_rgb: visible/val\nval_ir: infrared/val\n"
            "nc: 3\nnames: ['red', 'green', 'blue']\n")
        r = cli_val.main(["--weights", str(S640 / "stripped.ckpt"), "--cfg",
                          S640_CFG, "--data", str(work / "extval.yaml"),
                          "--img-size", "640", "--batch-size",
                          str(VAL_BATCH), "--save-dir", str(work / "7a")])
        print(f"   7a: cli.val s640 fp32 mAP@50 {r['map50']:.5f}")
        data = make_dataset(work / "data", 48, np.random.default_rng(0),
                            hw=(512, 640))
        (work / "13").mkdir()
        return reference_slice(card, r["map50"], data, work / "runs",
                               work / "13")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("attention")
    a.add_argument("--root", type=Path, default=HERE)
    sub.add_parser("fp64")
    sub.add_parser("int8-splits")
    sub.add_parser("int8-phases")
    sub.add_parser("int8-forward")
    sub.add_parser("dist-faults")
    sub.add_parser("reference")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_probes: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"   {card}")
    if args.cmd == "attention":
        res = {"root": str(args.root.resolve()),
               "attention": attention(args.root.resolve())}
    elif args.cmd == "int8-splits":
        res = {"int8_splits": int8_splits()}
    elif args.cmd == "int8-phases":
        res = {"int8_phases": int8_phases()}
    elif args.cmd == "int8-forward":
        res = {"int8_forward": int8_forward(card)}
    elif args.cmd == "dist-faults":
        res = {"dist_faults": dist_faults()}
    elif args.cmd == "reference":
        res = {"reference": reference(card)}
    else:
        res = {"fp64": fp64(FP64_CFG, FP64_SIZE, FP64_SCALES)}
    res["card"] = card
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
