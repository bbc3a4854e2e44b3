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
        ResNet50-Transfusion of phase 10a (chip_smoke.seeded_model, each
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

Each prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import copy
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
    import chip_smoke as cs
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
    import chip_smoke as cs
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("attention")
    a.add_argument("--root", type=Path, default=HERE)
    sub.add_parser("fp64")
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
    else:
        res = {"fp64": fp64(FP64_CFG, FP64_SIZE, FP64_SCALES)}
    res["card"] = card
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
