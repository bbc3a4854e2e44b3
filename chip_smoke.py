#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (icafusion_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds; any failure raises, so the
exit code is non-zero and the final line is never printed:

0. the card (nvidia-smi name and power limit), torch and CUDA versions, and
   which of msgpack, yaml, cv2, PIL and torchvision import;
1. the build of the CUDA kernels (one nvcc per source, in parallel) with the
   -Xptxas -v report;
2. the dual cross-attention kernel against its plain PyTorch version on the
   card, at the serving path's three shapes and three ragged lengths,
   float32 and bfloat16, timed beside the plain version and a library
   yardstick, each by device time (torch.profiler) and by CUDA events;
3. the greedy NMS kernels (suppression bitmask, then the walk) against the
   plain loop on the card, B = 4, at K = 1, 1024 (the serving pool), 4096,
   8193 and 20000, at B = 8, K = 8192 (the Evaluator's shape), and with
   padding of 0, -0.5 and -2 in place of -1; ties present: keep and ok must
   be equal. Each case prints its time and kept count;
3b. the fused conv3x3 + BatchNorm + SiLU kernel (64 channels) against its
   plain version, at the serving path's shape (4, 64, 160, 160) and six
   ragged ones, float32 and bfloat16, channels_last (the serving path's
   layout) and NCHW, timed like phase 2;
4. the slice: (a) a tiny model served on the card against the same engine
   on the CPU; (b) ServingEngine on yolov5l-Transfusion at 640, batch 4,
   bfloat16, random weights from torch.Generator().manual_seed(0), three
   requests (full, ragged 3, full) with every kernel launch counted (six
   fused convs per forward);
   (c) steady throughput and device time by kernel (torch.profiler);
   (d) detection agreement of the bf16 and fp32 engines, printed only;
5. the trained yolov5n-Transfusion checkpoint (artifacts/trained_n320, read
   by the port's own reader) through the port's Evaluator on its 77 val
   pairs at 320, float32 and bfloat16: mAP@50 within 0.3 points of the
   reference stack's record in TRAINED_PARITY.json;
6. training: (a) three Trainer steps of a tiny model (64 px, batch 2,
   fp32, dropout off) on the card against the same steps on the CPU, and
   the max-pool gradients of SPPF and of the fusion block's pooling on tied
   integer data against the first-winner plain version; (b) the slice:
   yolov5l-Transfusion at 640, batch 8, bf16, SGD, on batches of the
   port's PairedLoader over 48 synthetic FLIR-geometry pairs (512 x 640):
   2 warm-up and 10 timed steps, step time, images/s, device busy, idle
   share and peak memory; (c) fit: yolov5n-Transfusion at 320 on the same
   pairs, 2 epochs of batch 16 in bf16 with the EMA evaluated after each,
   the three kernels launched there, the stripped checkpoint served.

Before the last line it prints one JSON object with each kernel's launches
on the main path, error, device times (kernel, plain version and library
yardstick, from torch.profiler) and bound; the last line is
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device and
outside a checkout of the repository.
"""

from __future__ import annotations

import copy
import importlib.util
import itertools
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}   # dense
ATTN_SHAPES = ((400, 256), (256, 512), (100, 1024))   # (N, D) at P3/P4/P5
ATTN_RAGGED = ((1, 48), (63, 256), (65, 1024))   # not timed into the report
HEADS, BATCH = 8, 4
CONV_SHAPES = ((4, 64, 160, 160),    # the serving path: first C3 of a tower
               (1, 64, 20, 20), (2, 64, 10, 13), (1, 64, 7, 5),
               (1, 64, 1, 1),       # the halo is all padding
               (3, 64, 161, 33),    # ragged tiles in both directions
               (1, 64, 8, 16))      # one tile, fewer tiles than SMs
CONVS_PER_FORWARD = 6                # yolov5l: 3 bottlenecks x 2 towers
MAP50_GATE = 0.003                   # ACCURACY.md: within 0.3 mAP@50 points


def phase(name: str):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0: float):
    print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of fn() over iters back-to-back calls between two CUDA
    events, after a warm-up. For a call whose kernels run in tens of
    microseconds this times the host's launch work as well (device_ms
    does not)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_times(fn, iters: int = 20, warmup: int = 3) -> dict:
    """Mean device time of fn() in ms over iters calls, by kernel name: the
    summed self device time of every kernel (and memset or copy) the calls
    launched, from torch.profiler (CUPTI), divided by iters. Host work
    between launches does not count. A window in which the profiler
    recorded no device event is profiled again, up to twice."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = {e.key: e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA}
        if sum(us.values()):
            return {k: v / iters / 1e3 for k, v in us.items()}
        print("   (the profiler recorded no device time: again)")
    raise RuntimeError("device_times: the profiler recorded no device time")


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, all its kernels summed."""
    return sum(device_times(fn, iters, warmup).values())


def both_ms(fn, iters: int = 20, warmup: int = 3):
    """(device time, CUDA-event time) of fn() in ms, as above."""
    return device_ms(fn, iters, warmup), cuda_ms(fn, iters, warmup)


def attention_case(N: int, D: int, dtype, gen: torch.Generator):
    dev = torch.device("cuda")
    vis = torch.randn(BATCH, N, D, generator=gen).to(dev, dtype)
    ir = torch.randn(BATCH, N, D, generator=gen).to(dev, dtype)
    ws = [(torch.randn(D, D, generator=gen) / math.sqrt(D)).to(dev, dtype)
          for _ in range(6)]
    bs = [(0.1 * torch.randn(D, generator=gen)).to(dev) for _ in range(6)]
    return vis, ir, ws, bs


def attention_library(vis, ir, ws, bs):
    """Yardstick only (the port never calls it): torch.matmul projections
    and scaled_dot_product_attention, both directions."""
    B, N, D = vis.shape
    proj = [torch.matmul(x, w.t()) + b.to(x.dtype)
            for x, w, b in zip((vis, vis, vis, ir, ir, ir), ws, bs)]
    q_vis, k_vis, v_vis, q_ir, k_ir, v_ir = (
        p.view(B, N, HEADS, D // HEADS).transpose(1, 2) for p in proj)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return sdpa(q_ir, k_vis, v_vis), sdpa(q_vis, k_ir, v_ir)


def bound(flops: float, nbytes: float, dtype):
    """(least ms, what bounds it): operations at the dense peak of dtype, or
    bytes (each input read once, each output written once) at HBM rate."""
    t_ops = 1e3 * flops / PEAK_FLOPS[dtype]
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bound(N: int, D: int, dtype):
    s = torch.finfo(dtype).bits // 8
    flops = 12 * BATCH * N * D * D + 8 * BATCH * N * N * D
    nbytes = 4 * BATCH * N * D * s + 6 * D * D * s + 6 * D * 4
    return bound(flops, nbytes, dtype)


def conv_case(shape, dtype, layout, gen: torch.Generator):
    """x in the memory layout, w, and a BatchNorm folded to (scale, bias),
    on the card."""
    x = torch.randn(*shape, generator=gen).cuda().to(dtype)
    x = x.contiguous(memory_format=layout)
    w = (torch.randn(64, 64, 3, 3, generator=gen) / 24).cuda().to(dtype)
    scale = (1 + 0.3 * torch.randn(64, generator=gen)).cuda()
    bias = (0.1 * torch.randn(64, generator=gen)).cuda()
    return x, w, scale, bias


def conv_library(x, w_folded, b_folded):
    """Yardstick only (the port never calls it): one cuDNN convolution on
    BN-folded weights with bias, then SiLU."""
    F = torch.nn.functional
    return F.silu(F.conv2d(x, w_folded, b_folded, padding=1))


def conv_bound(shape, dtype):
    B, C, H, W = shape
    s = torch.finfo(dtype).bits // 8
    return bound(2 * B * H * W * C * C * 9,
                 2 * B * C * H * W * s + C * C * 9 * s + 2 * C * 4, dtype)


def matched(a: np.ndarray, r: np.ndarray) -> float:
    """Share of the rows of a with a row of r of the same class at IoU > 0.5."""
    if not len(a):
        return 1.0
    if not len(r):
        return 0.0
    lt = np.maximum(a[:, None, :2], r[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], r[None, :, 2:4])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    iou = inter / (area(a)[:, None] + area(r)[None, :] - inter + 1e-9)
    same = a[:, None, 5] == r[None, :, 5]
    return float(((iou > 0.5) & same).any(1).mean())


def nms_case(B: int, K: int, gen: torch.Generator, pad: float = -1.0):
    """Clustered boxes (so suppression happens), scores descending with
    runs of equal values (ties), a tail of `pad`, and one image that is all
    `pad` (no live candidate when pad <= -1)."""
    n = (K + 7) // 8
    ctr = torch.rand(B, n, 1, 2, generator=gen) * 600
    xy = (ctr + torch.randn(B, n, 8, 2, generator=gen) * 6).view(B, -1, 2)
    xy = xy[:, :K]
    wh = 20 + torch.rand(B, K, 2, generator=gen) * 60
    boxes = torch.cat([xy, xy + wh], -1)
    boxes = boxes + (torch.randint(0, 3, (B, K, 1), generator=gen) * 4096.0)
    s = torch.rand(B, K, generator=gen)
    s = torch.round(s * 64) / 64                      # many exact ties
    s = torch.sort(s, dim=1, descending=True, stable=True).values
    s[:, int(K * 0.8):] = pad
    s[B - 1] = pad
    return boxes.cuda().contiguous(), s.cuda().contiguous()


STEADY_REQUESTS = 20


def profile_calls(fn, n: int = 3):
    """(device time by kernel in us over n calls of fn, by torch.profiler
    / CUPTI; the profiled wall time in us)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return {e.key: e.self_device_time_total for e in kern}, wall_us


def profile_requests(engine, pair, wall_ms: float, n: int = 3):
    """Device time by kernel over n requests (torch.profiler / CUPTI), and
    the device's idle share of wall_ms, a request's unprofiled wall time
    (the profiler's own host overhead stretches the profiled wall)."""
    dev_us, wall_us = profile_calls(lambda: engine.predict_arrays(*pair), n)
    busy = sum(dev_us.values())
    if not busy:
        print("   profiler: no device events recorded")
        return
    groups = {"dual_cross_attention": ("projections_wgmma_kernel",
                                       "flash_attention_kernel",
                                       "projections_f32_kernel",
                                       "attention_f32_kernel"),
              "greedy_nms": ("nms_mask_kernel", "nms_scan_kernel"),
              "conv3x3_bn_silu": ("conv3x3_bf16_nhwc_kernel",
                                  "conv3x3_bf16_nchw_kernel",
                                  "conv3x3_f32_kernel", "pack_weights_kernel")}
    busy_ms = busy / n / 1e3
    print(f"   per request: device busy {busy_ms:.2f} ms; wall {wall_ms:.2f} ms"
          f" unprofiled -> idle share {1 - busy_ms / wall_ms:.3f} "
          f"(profiled wall {wall_us / n / 1e3:.2f} ms)")
    for g, keys in groups.items():
        us = sum(v for k, v in dev_us.items() if any(x in k for x in keys))
        print(f"   {g}: {us / n / 1e3:.3f} ms per request "
              f"({100 * us / busy:.1f}% of device time)")
    for k, v in sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]:
        print(f"   {100 * v / busy:5.1f}%  {v / n / 1e3:7.3f} ms  {k[:90]}")


def first_winner_pool_grad(x: torch.Tensor, g: torch.Tensor, k: int,
                           s: int, p: int) -> torch.Tensor:
    """Plain version of the max-pool gradient the JAX package takes
    (nn/layers.py:390-446): each window's gradient goes to the first
    row-major position holding its maximum; padding is -inf. float64 on
    the CPU."""
    F = torch.nn.functional
    x, g = x.double().cpu(), g.double().cpu()
    B, C, H, W = x.shape
    xp = F.pad(x, (p, p, p, p), value=-math.inf)
    win = F.unfold(xp.reshape(B * C, 1, H + 2 * p, W + 2 * p), k, stride=s)
    y = win.amax(1, keepdim=True)
    first = (win == y).double().argmax(1, keepdim=True)     # first maximum
    contrib = torch.zeros_like(win).scatter_(
        1, first, g.reshape(B * C, 1, -1))
    out = F.fold(contrib, (H + 2 * p, W + 2 * p), k, stride=s)
    return out[..., p:p + H, p:p + W].reshape(B, C, H, W)


def check_pool_grads(gen: torch.Generator):
    """SPPF's three chained 5x5 pools and the fusion block's floor-mode
    pool (P4 at 640: 40 -> 16, kernel 10, stride 2) on integer data with
    many ties: the card's autograd against first_winner_pool_grad. Integer
    upstream gradients keep every sum exact."""
    F = torch.nn.functional
    x = torch.randint(0, 4, (2, 8, 20, 20), generator=gen).float()
    ws = [torch.randint(-3, 4, (2, 8, 20, 20), generator=gen).float()
          for _ in range(4)]
    xc = x.cuda().requires_grad_()
    ys = [xc]
    for _ in range(3):
        ys.append(F.max_pool2d(ys[-1], 5, 1, 2))
    sum((y * w.cuda()).sum() for y, w in zip(ys, ws)).backward()
    ys = [x]
    for _ in range(3):
        ys.append(F.max_pool2d(ys[-1], 5, 1, 2))
    g = ws[3].double()
    for i in (2, 1, 0):
        g = ws[i].double() + first_winner_pool_grad(ys[i], g, 5, 1, 2)
    assert torch.equal(xc.grad.double().cpu(), g), "SPPF pool gradient"
    x = torch.randint(0, 4, (2, 8, 40, 40), generator=gen).float()
    w = torch.randint(-3, 4, (2, 8, 16, 16), generator=gen).float()
    xc = x.cuda().requires_grad_()
    (F.max_pool2d(xc, 10, 2) * w.cuda()).sum().backward()
    assert torch.equal(xc.grad.double().cpu(),
                       first_winner_pool_grad(x, w, 10, 2, 0)), \
        "fusion-block pool gradient"
    print("   max-pool gradients on ties equal the first-winner plain "
          "version: SPPF 3 x 5x5/s1 chained (2, 8, 20, 20), fusion pool "
          "10x10/s2 (2, 8, 40, 40)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "icafusion_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from icafusion_tpu_torch.data.datasets import PairedDetectionDataset
    from icafusion_tpu_torch.data.loader import PairedLoader
    from icafusion_tpu_torch.eval.evaluator import Evaluator
    from icafusion_tpu_torch.kernels import _build
    from icafusion_tpu_torch.kernels.cross_attention import (
        dual_cross_attention, dual_cross_attention_reference)
    from icafusion_tpu_torch.kernels.nms import greedy_nms, greedy_nms_reference
    from icafusion_tpu_torch.kernels.packed_conv import (
        conv3x3_bn_silu, conv3x3_bn_silu_reference)
    from icafusion_tpu_torch.models.assembler import build_model, init_weights
    from icafusion_tpu_torch.models.zoo import (icafusion_config,
                                                tiny_icafusion_config)
    from icafusion_tpu_torch.serve.engine import ServingEngine
    from icafusion_tpu_torch.utils.checkpoint import load_inference_variables
    from icafusion_tpu_torch.utils.convert import load_jax_variables

    t_all = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = phase("0 device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"   {card}")
    print(f"   torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} numpy {np.__version__}")
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("msgpack", "yaml", "cv2", "PIL", "torchvision")}
    print(f"   importable: {found}")
    done(t0)

    t0 = phase("1 build")
    b = _build.build()
    print(f"   {b.path.name}: nvcc {b.seconds:.1f} s")
    for line in b.log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers",
                                   "spill", "smem")):
            print(f"   {line.strip()}")
    _build.library()
    done(t0)

    report = {}
    gen = torch.Generator().manual_seed(0)

    t0 = phase("2 dual cross-attention vs plain (B=4, h=8)")
    # fp32: rtol 2e-4 / atol 2e-5, the tolerance of the JAX package's Pallas
    # test (tests/test_pallas_kernels.py:52). bf16: 3e-2 / 3e-2. The kernel
    # rounds q/k/v to bf16 where the plain version (the JAX einsum path,
    # nn/fusion.py:237-266) does (the product, then its sum with the bias)
    # and the probabilities before the P V product, but it sums in another
    # order and rounds the probabilities before their normalisation, not
    # after: a few bf16 ulps (2^-8) of O(1) values.
    tol = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (3e-2, 3e-2)}
    main_path = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                 "library_ms": 0.0, "max_abs_err": 0.0, "bound_by": set()}
    events = {"ms": 0.0, "library_ms": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for N, D in ATTN_SHAPES + ATTN_RAGGED:
            vis, ir, ws, bs = attention_case(N, D, dtype, gen)
            out = dual_cross_attention(vis, ir, ws, bs, HEADS)
            ref = dual_cross_attention_reference(vis, ir, ws, bs, HEADS)
            torch.cuda.synchronize()
            rtol, atol = tol[dtype]
            err = 0.0
            for o, r in zip(out, ref):
                torch.testing.assert_close(o.float(), r.float(), rtol=rtol,
                                           atol=atol)
                err = max(err, (o.float() - r.float()).abs().max().item())
            if (N, D) not in ATTN_SHAPES:
                print(f"   {str(dtype)[6:]:8s} N={N:3d} D={D:4d}: max_abs_err "
                      f"{err:.3g} (ragged, not timed)")
                continue
            ms, ms_ev = both_ms(
                lambda: dual_cross_attention(vis, ir, ws, bs, HEADS))
            plain, plain_ev = both_ms(lambda: dual_cross_attention_reference(
                vis, ir, ws, bs, HEADS))
            lib, lib_ev = both_ms(lambda: attention_library(vis, ir, ws, bs))
            bnd, by = attention_bound(N, D, dtype)
            print(f"   {str(dtype)[6:]:8s} N={N:3d} D={D:4d}: max_abs_err "
                  f"{err:.3g}  device ms: kernel {ms:.4f} plain {plain:.4f} "
                  f"library {lib:.4f}; events ms: kernel {ms_ev:.4f} plain "
                  f"{plain_ev:.4f} library {lib_ev:.4f}; bound {bnd:.5f} ms "
                  f"({by})")
            if dtype == torch.bfloat16:        # the engine's dtype
                for k, v in (("ms", ms), ("plain_ms", plain),
                             ("bound_ms", bnd), ("library_ms", lib)):
                    main_path[k] += v
                events["ms"] += ms_ev
                events["library_ms"] += lib_ev
                main_path["max_abs_err"] = max(main_path["max_abs_err"], err)
                main_path["bound_by"].add(by)
    report["dual_cross_attention"] = main_path
    print(f"   per forward (3 calls, bf16), device time: kernel "
          f"{main_path['ms']:.4f} ms, plain {main_path['plain_ms']:.4f} ms, "
          f"library {main_path['library_ms']:.4f} ms, bound "
          f"{main_path['bound_ms']:.5f} ms; events: kernel "
          f"{events['ms']:.4f} ms, library {events['library_ms']:.4f} ms")
    done(t0)

    t0 = phase("3 greedy NMS vs plain loop (max_det=300)")
    for B, K, pad in ((BATCH, 1, -1.0), (BATCH, 1024, -1.0),
                      (BATCH, 4096, -1.0), (8, 8192, -1.0),
                      (BATCH, 8193, -1.0), (BATCH, 20000, -1.0),
                      (BATCH, 1024, 0.0), (BATCH, 1024, -0.5),
                      (BATCH, 1024, -2.0), (BATCH, 8193, -0.5)):
        boxes, scores = nms_case(B, K, gen, pad)
        keep, ok = greedy_nms(boxes, scores, 0.45, 300)
        rkeep, rok = greedy_nms_reference(boxes, scores, 0.45, 300)
        torch.cuda.synchronize()
        if not (torch.equal(keep, rkeep) and torch.equal(ok, rok)):
            bad = (keep != rkeep) | (ok != rok)
            raise AssertionError(f"NMS B={B} K={K} pad={pad}: "
                                 f"{int(bad.sum())} of {bad.numel()} slots "
                                 f"differ")
        by_kernel = device_times(lambda: greedy_nms(boxes, scores, 0.45, 300))
        ms = sum(by_kernel.values())
        ms_ev = cuda_ms(lambda: greedy_nms(boxes, scores, 0.45, 300))
        split = {k: sum(v for n, v in by_kernel.items() if k in n)
                 for k in ("nms_mask_kernel", "nms_scan_kernel")}
        # per step and candidate of the argmax loop: 4 min/max, 2 sub,
        # 2 clamp, 2 mul, 2 add, 1 sub, 1 div, 1 compare = 15 operations
        bnd, by = bound(15 * B * K * 300, B * K * 20 + B * 300 * 5,
                        torch.float32)
        line = (f"   B={B} K={K:5d} pad={pad:4.1f}: keep/ok equal "
                f"({int(ok.sum())} kept)  device ms: kernels {ms:.4f} "
                f"(mask {split['nms_mask_kernel']:.4f}, walk "
                f"{split['nms_scan_kernel']:.4f})")
        if (B, K, pad) == (BATCH, 1024, -1.0):   # the serving path's top_k
            plain, plain_ev = both_ms(
                lambda: greedy_nms_reference(boxes, scores, 0.45, 300),
                iters=2, warmup=1)
            line += f" plain {plain:.3f} (events {plain_ev:.3f})"
            report["greedy_nms"] = {"ms": ms, "plain_ms": plain,
                                    "bound_ms": bnd, "library_ms": None,
                                    "max_abs_err": 0.0, "bound_by": {by}}
        print(f"{line}; events ms: kernels {ms_ev:.4f}; bound {bnd:.5f} ms "
              f"({by})")
    done(t0)

    t0 = phase("3b conv3x3 + BN + SiLU (64 ch) vs plain")
    # fp32: rtol/atol 1e-4, the tolerance of the JAX package's Pallas test
    # (tests/test_pallas_kernels.py:104); both sum 576 fp32 products exactly
    # formed, in different orders. bf16: both form the products of the same
    # bf16 values exactly and sum in fp32, then round once to bf16, so they
    # differ by at most about one bf16 ulp (2^-8 relative): 1e-2 / 1e-2.
    tol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
    layouts = {"NHWC": torch.channels_last, "NCHW": torch.contiguous_format}
    for dtype, shape, (lname, layout) in itertools.product(
            (torch.float32, torch.bfloat16), CONV_SHAPES, layouts.items()):
        x, w, sc, bi = conv_case(shape, dtype, layout, gen)
        out = conv3x3_bn_silu(x, w, sc, bi)
        ref = conv3x3_bn_silu_reference(x, w, sc, bi)
        torch.cuda.synchronize()
        assert out.stride() == x.stride(), (out.stride(), x.stride())
        rtol, atol = tol[dtype]
        torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                                   atol=atol)
        err = (out.float() - ref.float()).abs().max().item()
        w_f = (w.float() * sc[:, None, None, None]).to(dtype)
        b_f = bi.to(dtype)
        ms, ms_ev = both_ms(lambda: conv3x3_bn_silu(x, w, sc, bi))
        plain, plain_ev = both_ms(
            lambda: conv3x3_bn_silu_reference(x, w, sc, bi))
        lib, lib_ev = both_ms(lambda: conv_library(x, w_f, b_f))
        bnd, by = conv_bound(shape, dtype)
        print(f"   {str(dtype)[6:]:8s} {lname} {str(shape):18s}: "
              f"max_abs_err {err:.3g} (rtol {rtol:g}, atol {atol:g})  device "
              f"ms: kernel {ms:.4f} plain {plain:.4f} library {lib:.4f}; "
              f"events ms: kernel {ms_ev:.4f} plain {plain_ev:.4f} library "
              f"{lib_ev:.4f}; bound {bnd:.5f} ms ({by})")
        if (dtype == torch.bfloat16 and shape == CONV_SHAPES[0]
                and lname == "NHWC"):            # the serving path's
            report["conv3x3_bn_silu"] = {
                "ms": ms, "plain_ms": plain, "bound_ms": bnd,
                "library_ms": lib, "max_abs_err": err, "bound_by": {by}}
    done(t0)

    t0 = phase("4a tiny model: engine on the card vs on the CPU (fp32)")
    tiny = build_model(tiny_icafusion_config(),
                       generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (3, 64, 96, 3), np.uint8)
    ir = rng.integers(0, 256, (3, 64, 96, 3), np.uint8)
    on = {d: ServingEngine(tiny, (64, 96), 4, conf_thres=0.25,
                           dtype="float32", device=d) for d in ("cuda", "cpu")}
    preds = {}
    for d, eng in on.items():
        with torch.inference_mode():
            x = torch.from_numpy(rgb).to(d).permute(0, 3, 1, 2).float() / 255
            y = torch.from_numpy(ir).to(d).permute(0, 3, 1, 2).float() / 255
            preds[d] = eng.model(x, y).cpu()
    torch.testing.assert_close(preds["cuda"], preds["cpu"], rtol=1e-3,
                               atol=1e-3)
    dets = {d: eng.predict_arrays(rgb, ir) for d, eng in on.items()}
    print(f"   decoded predictions allclose (rtol/atol 1e-3); detections "
          f"per image card {[len(x) for x in dets['cuda']]} cpu "
          f"{[len(x) for x in dets['cpu']]}")
    done(t0)

    t0 = phase("4b slice: yolov5l-Transfusion 640, batch 4, bf16")
    model = build_model(icafusion_config("l", nc=3, fusion="tfb"),
                        generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    engine = ServingEngine(model, 640, BATCH, conf_thres=0.001,
                           dtype="bfloat16")
    rng = np.random.default_rng(1)
    pairs = [(rng.integers(0, 256, (n, 640, 640, 3), np.uint8),
              rng.integers(0, 256, (n, 640, 640, 3), np.uint8))
             for n in (BATCH, 3, BATCH)]
    engine.predict_arrays(*pairs[0])                  # warm-up
    torch.cuda.synchronize()
    dual_cross_attention.launches = 0
    greedy_nms.launches = 0
    conv3x3_bn_silu.launches = 0
    results, req_ms = [], []
    for rgb, ir in pairs:
        t = time.perf_counter()
        results.append(engine.predict_arrays(rgb, ir))
        req_ms.append(1e3 * (time.perf_counter() - t))
    launches = {"dual_cross_attention": dual_cross_attention.launches,
                "greedy_nms": greedy_nms.launches,
                "conv3x3_bn_silu": conv3x3_bn_silu.launches}
    print(f"   {n_params / 1e6:.1f} M parameters; launches {launches}; "
          f"fused convs per forward "
          f"{launches['conv3x3_bn_silu'] / len(pairs):g}")
    for (rgb, _), out, ms in zip(pairs, results, req_ms):
        print(f"   request of {len(rgb)}: {ms:.1f} ms, "
              f"{1e3 * len(rgb) / ms:.1f} pairs/s, detections per image "
              f"{[len(x) for x in out]}")
        assert len(out) == len(rgb)
        for x in out:
            assert x.ndim == 2 and x.shape[1] == 6 and len(x) <= 300, x.shape
            assert np.isfinite(x).all()
    assert launches["dual_cross_attention"] == 3 * len(pairs), launches
    assert launches["greedy_nms"] == len(pairs), launches
    assert (launches["conv3x3_bn_silu"]
            == CONVS_PER_FORWARD * len(pairs)), launches
    done(t0)

    t0 = phase("4c slice throughput and device time (yolov5l 640, b4, bf16)")
    steady = []
    for _ in range(STEADY_REQUESTS):
        t = time.perf_counter()
        engine.predict_arrays(*pairs[0])
        steady.append(1e3 * (time.perf_counter() - t))
    print(f"   {STEADY_REQUESTS} full-batch requests: median "
          f"{np.median(steady):.2f} ms, min {min(steady):.2f} ms -> "
          f"{1e3 * BATCH / np.median(steady):.1f} pairs/s (median)")
    profile_requests(engine, pairs[0], float(np.median(steady)))
    done(t0)

    t0 = phase("4d bf16 vs fp32 engine (not gated)")
    fp32 = ServingEngine(model, 640, BATCH, conf_thres=0.001, dtype="float32")
    ref = fp32.predict_arrays(*pairs[0])
    with torch.inference_mode():
        dec = {}
        for name, eng in (("bf16", engine), ("fp32", fp32)):
            x, y = (torch.from_numpy(a).cuda().permute(0, 3, 1, 2).float()
                    / 255 for a in pairs[0])
            dec[name] = eng.model(x.to(eng.dtype), y.to(eng.dtype))
        d = (dec["bf16"] - dec["fp32"]).abs()
        q = lambda t: float(torch.quantile(t.flatten().float(), 0.99))
        print(f"   decoded predictions, 99th percentile of |bf16 - fp32|: "
              f"xy {q(d[..., :2]):.3f} px, wh {q(d[..., 2:4]):.3f} px, "
              f"obj {q(d[..., 4]):.4f}, cls {q(d[..., 5:]):.4f}")
    agree = [round(matched(a, r), 4) for a, r in zip(results[0], ref)]
    print(f"   bf16 vs fp32 engine (not gated): share of bf16 detections "
          f"with an fp32 detection of the same class at IoU > 0.5: {agree}")
    done(t0)

    t0 = phase("5 trained yolov5n-Transfusion (n320): Evaluator, 77 val pairs")
    ckpt = REPO / "artifacts" / "trained_n320"
    record = json.loads((REPO / "TRAINED_PARITY.json").read_text())
    ref_map50 = record["torch"]["map50"]     # the reference stack, CPU fp32
    n320 = load_jax_variables(
        build_model(icafusion_config("n", nc=3, fusion="tfb")),
        load_inference_variables(ckpt / "stripped.ckpt"))
    data = ckpt / "data"
    val = PairedDetectionDataset(str(data / "visible" / "val"),
                                 str(data / "infrared" / "val"), 320, nc=3)
    wrappers = (dual_cross_attention, greedy_nms, conv3x3_bn_silu)
    for dtype, tag in (("float32", "fp32"), ("bfloat16", "bf16")):
        ev = Evaluator(n320, nc=3, dtype=dtype)
        for fn in wrappers:
            fn.launches = 0
        r = ev.run(PairedLoader(val, 8).val_batches(), 320)
        counts = {fn.__name__: fn.launches for fn in wrappers}
        jax_rec = record["ours"][tag]["ref_scored"]
        print(f"   {tag}: mAP@50 {r['map50']:.5f} mAP {r['map']:.5f} P "
              f"{r['mp']:.5f} R {r['mr']:.5f} over {r['seen']} pairs; "
              f"reference stack {ref_map50:.5f} (delta "
              f"{100 * (r['map50'] - ref_map50):+.3f} pts), JAX {tag} record "
              f"{jax_rec['map50']:.5f} (delta "
              f"{100 * (r['map50'] - jax_rec['map50']):+.3f} pts); "
              f"{r['t_total_ms']:.2f} ms per image; launches {counts}")
        assert r["seen"] == record["n_images"], r["seen"]
        assert all(counts.values()), counts
        # ACCURACY.md's gate is the reference stack's mAP@50; the JAX bf16
        # record is itself 0.436 points below it (one box ~ 0.65 points on
        # 152 labels), so bf16 is held to the gate and its JAX record only
        # printed; fp32 is also held to its JAX record.
        assert abs(r["map50"] - ref_map50) <= MAP50_GATE, (tag, r["map50"])
        if tag == "fp32":
            assert abs(r["map50"] - jax_rec["map50"]) <= MAP50_GATE, r["map50"]
    done(t0)

    t0 = phase("6a train step: card vs CPU (tiny, 64 px, b2, fp32)")
    train_card_vs_cpu()
    check_pool_grads(gen)
    done(t0)

    with tempfile.TemporaryDirectory() as tmp:
        from icafusion_tpu_torch.data.synthetic import make_dataset
        data_yaml = make_dataset(Path(tmp) / "data", 48,
                                 np.random.default_rng(0), hw=(512, 640))
        t0 = phase("6b slice: training yolov5l-Transfusion 640, b8, bf16, SGD")
        train_slice(data_yaml, card)
        done(t0)
        t0 = phase("6c fit: yolov5n-Transfusion 320, 2 epochs, b16, bf16")
        fit_slice(data_yaml, Path(tmp) / "runs")
        done(t0)

    kernels = []
    for name, src, tpu in (
            ("dual_cross_attention",
             "icafusion_tpu_torch/csrc/dual_cross_attention.cu",
             "icafusion_tpu/kernels/cross_attention.py:71"),
            ("greedy_nms", "icafusion_tpu_torch/csrc/greedy_nms.cu",
             "icafusion_tpu/kernels/nms.py:71"),
            ("conv3x3_bn_silu", "icafusion_tpu_torch/csrc/conv3x3_bn_silu.cu",
             "icafusion_tpu/kernels/packed_conv.py:120")):
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "/".join(sorted(r["bound_by"])),
            "library_ms": r["library_ms"]})
    print(f"== total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


TRAIN_WARMUP, TRAIN_TIMED, TRAIN_BATCH = 2, 10, 8


def _no_dropout(model):
    from icafusion_tpu_torch.nn.fusion import Dropout
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


# Card against CPU, tiny model, 64 px, batch 2, fp32. BatchNorm over 8
# values per channel at P5 magnifies rounding: on the CPU alone a change of
# one ulp in the input moves the weights and statistics by 7.7e-6 after
# three steps, and the card's own summation orders (cuDNN's choice of
# algorithm, atomics) moved them by 2.4e-5 and 1.9e-4 in two runs. So the
# first step's gradients are held tensor by tensor (GRAD_RTOL of the
# tensor's largest gradient, plus GRAD_RTOL / 10 of the largest of all for
# those near zero) and the state after three steps to STATE_ATOL.
GRAD_RTOL, STATE_ATOL = 1e-3, 1e-3


def train_card_vs_cpu():
    """One tiny model from one batch, dropout off, on the card and on the
    CPU: the first step's gradients; then three Trainer steps: loss and
    items rtol 1e-4, parameters, BatchNorm statistics and EMA within
    STATE_ATOL (the momentum printed)."""
    from icafusion_tpu_torch.config import load_hyp_config
    from icafusion_tpu_torch.models.assembler import build_model, init_weights
    from icafusion_tpu_torch.models.zoo import tiny_icafusion_config
    from icafusion_tpu_torch.train.loss import pad_targets
    from icafusion_tpu_torch.train.trainer import Trainer
    base = _no_dropout(init_weights(build_model(tiny_icafusion_config()),
                                    torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    rgb = torch.from_numpy(rng.random((2, 3, 64, 64), np.float32))
    ir = torch.from_numpy(rng.random((2, 3, 64, 64), np.float32))
    labels = [np.array([[0, 0.5, 0.5, 0.4, 0.4], [1, 0.25, 0.25, 0.2, 0.3],
                        [2, 0.7, 0.3, 0.1, 0.15]], np.float32)] * 2
    t, m = (torch.from_numpy(a) for a in pad_targets(labels, 8))
    runs, grads = {}, {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(copy.deepcopy(base), load_hyp_config(), epochs=3,
                     steps_per_epoch=1, batch_size=2, imgsz=64,
                     warmup_min_steps=2, device=dev)
        batch = [x.to(dev) for x in (rgb, ir, t, m)]
        model = copy.deepcopy(base).to(dev).train()
        tr.loss_fn(model(*batch[:2]), *batch[2:])[0].backward()
        grads[dev] = {k: p.grad.double().cpu()
                      for k, p in model.named_parameters()}
        step = tr.make_train_step()
        mets = [step(*batch) for _ in range(3)]
        runs[dev] = (tr, [{k: float(v) for k, v in mt.items()}
                          for mt in mets])
    top = max(g.abs().max().item() for g in grads["cpu"].values())
    worst_g = 0.0
    for k, g in grads["cpu"].items():
        d = (grads["cuda"][k] - g).abs().max().item()
        worst_g = max(worst_g, d / (g.abs().max().item() + top / 10))
        assert d <= GRAD_RTOL * (g.abs().max().item() + top / 10), (k, d)
    (tc, mc), (tp, mp) = runs["cuda"], runs["cpu"]
    for a, b in zip(mc, mp):
        for k in ("loss", "lbox", "lobj", "lcls"):
            assert math.isclose(a[k], b[k], rel_tol=1e-4), (k, a[k], b[k])
    worst = {}
    for name, x, y in (("state", tc.model.state_dict(),
                        tp.model.state_dict()),
                       ("momentum", tc.opt.momentum, tp.opt.momentum),
                       ("ema", tc.ema.tree, tp.ema.tree)):
        worst[name] = max((x[k].double().cpu() - y[k].double()).abs().max()
                          .item() for k in y
                          if not k.endswith("num_batches_tracked"))
    print(f"   first-step gradients: max |card - CPU| / (tensor max + "
          f"global max / 10) = {worst_g:.3g}; losses "
          f"{[round(r['loss'], 6) for r in mc]} (card) vs "
          f"{[round(r['loss'], 6) for r in mp]} (CPU); max |card - CPU| "
          f"after 3 steps: {worst}")
    for name in ("state", "ema"):
        assert worst[name] <= STATE_ATOL, (name, worst[name])


def train_slice(data_yaml: Path, card: str):
    """yolov5l-Transfusion at 640, batch 8, bf16 autocast, SGD: batches from
    the port's PairedLoader (mosaic, HSV, flips) over the synthetic pairs,
    2 warm-up and 10 timed steps; every loss finite, the parameters moved,
    every tensor of the state on the card."""
    from icafusion_tpu_torch.config import load_data_config, load_hyp_config
    from icafusion_tpu_torch.data.datasets import PairedDetectionDataset
    from icafusion_tpu_torch.data.loader import PairedLoader
    from icafusion_tpu_torch.models.assembler import build_model, init_weights
    from icafusion_tpu_torch.models.zoo import icafusion_config
    from icafusion_tpu_torch.train.trainer import Trainer
    dc = load_data_config(data_yaml)
    hyp = load_hyp_config("hyp.scratch.yaml")
    root = Path(dc.path)
    ds = PairedDetectionDataset(str(root / dc.train_rgb),
                                str(root / dc.train_ir), 640, nc=dc.nc,
                                hyp=hyp, augment=True)
    loader = PairedLoader(ds, TRAIN_BATCH, max_targets=128, seed=0,
                          num_workers=8)
    t = time.perf_counter()
    host = []
    epoch = 0
    while len(host) < TRAIN_WARMUP + TRAIN_TIMED:
        host += list(loader.epoch(epoch))
        epoch += 1
    host = host[:TRAIN_WARMUP + TRAIN_TIMED]
    load_s = time.perf_counter() - t

    def up(b):
        img = lambda a: (torch.from_numpy(a).cuda().permute(0, 3, 1, 2)
                         .float().div_(255.0))
        return (img(b["rgb"]), img(b["ir"]), torch.from_numpy(
            b["targets"]).cuda(), torch.from_numpy(b["mask"]).cuda())

    batches = [up(b) for b in host]
    print(f"   {len(batches)} batches of {TRAIN_BATCH} from PairedLoader over "
          f"{len(ds)} pairs in {load_s:.1f} s; targets per image "
          f"{float(np.mean([b['mask'].sum(1).mean() for b in host])):.1f}")
    model = init_weights(build_model(icafusion_config("l", nc=3)),
                         torch.Generator().manual_seed(0))
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(model, hyp, epochs=10, steps_per_epoch=loader.steps_per_epoch,
                 batch_size=TRAIN_BATCH, imgsz=640, bf16=True)
    step = tr.make_train_step()
    losses, ms = [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        met = step(*b)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        losses.append(float(met["loss"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert all(math.isfinite(x) for x in losses), losses
    moved = sum(not torch.equal(before[k], v.cpu())
                for k, v in tr.model.state_dict().items())
    assert moved > 0.9 * len(before), (moved, len(before))
    on_card = [t.is_cuda for t in itertools.chain(
        tr.model.parameters(), tr.model.buffers(),
        tr.opt.momentum.values(), tr.ema.tree.values())]
    assert all(on_card), "a tensor of the train state is off the card"
    timed = ms[TRAIN_WARMUP:]
    med = float(np.median(timed))
    dev_us, wall_us = profile_calls(lambda: step(*batches[-1]), 3)
    busy = sum(dev_us.values()) / 3 / 1e3
    if not busy:
        raise RuntimeError("the profiler recorded no device time")
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    print(f"   {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
          f"parameters; losses {[round(x, 4) for x in losses]}; "
          f"{moved}/{len(before)} state tensors moved")
    print(f"   step ms (host clock, synchronised): warm-up "
          f"{[round(x, 1) for x in ms[:TRAIN_WARMUP]]}, timed "
          f"{[round(x, 1) for x in timed]}; median {med:.2f} ms -> "
          f"{1e3 * TRAIN_BATCH / med:.1f} images/s (pairs)")
    print(f"   device busy {busy:.2f} ms per step (torch.profiler, 3 steps; "
          f"profiled wall {wall_us / 3 / 1e3:.2f} ms) -> idle share "
          f"{1 - busy / med:.3f} of the unprofiled median; peak memory "
          f"{peak:.2f} GiB (max_memory_allocated); {card}")
    for k, v in top:
        print(f"   {100 * v / 3e3 / busy:5.1f}%  {v / 3e3:8.3f} ms  {k[:90]}")


def fit_slice(data_yaml: Path, project: Path):
    """fit() of yolov5n-Transfusion at 320 on the synthetic pairs: 2 epochs
    of batch 16 in bf16 with the EMA evaluated after each; results.csv,
    last/best checkpoints, the kernels launched by the evaluations, and the
    stripped checkpoint read back and served on the card."""
    from icafusion_tpu_torch.config import load_data_config, load_hyp_config
    from icafusion_tpu_torch.kernels.cross_attention import dual_cross_attention
    from icafusion_tpu_torch.kernels.nms import greedy_nms
    from icafusion_tpu_torch.kernels.packed_conv import conv3x3_bn_silu
    from icafusion_tpu_torch.models.assembler import build_model
    from icafusion_tpu_torch.models.zoo import icafusion_config
    from icafusion_tpu_torch.serve.engine import ServingEngine
    from icafusion_tpu_torch.train.fit import FitConfig, fit
    from icafusion_tpu_torch.utils.checkpoint import load_inference_variables
    from icafusion_tpu_torch.utils.convert import load_jax_variables
    import csv
    cfg = FitConfig(model_cfg=icafusion_config("n", nc=3),
                    data_cfg=load_data_config(data_yaml),
                    hyp=load_hyp_config("hyp.scratch.yaml"), epochs=2,
                    batch_size=16, imgsz=320, project=str(project),
                    bf16=True, workers=8)
    wrappers = (dual_cross_attention, greedy_nms, conv3x3_bn_silu)
    for fn in wrappers:
        fn.launches = 0
    t = time.perf_counter()
    result = fit(cfg)
    fit_s = time.perf_counter() - t
    counts = {fn.__name__: fn.launches for fn in wrappers}
    run = Path(result["run_dir"])
    with open(run / "results.csv") as f:
        rows = list(csv.DictReader(f))
    print(f"   fit {fit_s:.1f} s; launches during fit {counts}")
    for r in rows:
        print(f"   {dict(r)}")
    assert len(rows) == 2, rows
    for r in rows:
        for k in ("lbox", "lobj", "lcls", "mAP50", "mAP"):
            assert math.isfinite(float(r[k])), (k, r)
    w = run / "weights"
    for name in ("last.ckpt", "best.ckpt", "stripped.ckpt"):
        assert (w / name).is_file(), name
    assert all(counts.values()), counts
    model = load_jax_variables(build_model(icafusion_config("n", nc=3)),
                               load_inference_variables(w / "stripped.ckpt"))
    engine = ServingEngine(model, 320, 4, conf_thres=0.001)
    rng = np.random.default_rng(2)
    out = engine.predict_arrays(
        rng.integers(0, 256, (4, 320, 320, 3), np.uint8),
        rng.integers(0, 256, (4, 320, 320, 3), np.uint8))
    assert len(out) == 4 and all(
        x.ndim == 2 and x.shape[1] == 6 and np.isfinite(x).all()
        for x in out), [x.shape for x in out]
    print(f"   stripped.ckpt served on the card: detections per image "
          f"{[len(x) for x in out]}")


if __name__ == "__main__":
    sys.exit(main())
