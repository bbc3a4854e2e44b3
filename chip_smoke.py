#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (icafusion_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds; any failure raises, so the
exit code is non-zero and the final line is never printed:

0. the card (nvidia-smi name and power limit), torch and CUDA versions, and
   which of msgpack, yaml, cv2, PIL, torchvision and matplotlib import;
1. the build of the CUDA kernels (one nvcc per source, in parallel) with the
   -Xptxas -v report;
2. the dual cross-attention kernel against its plain PyTorch version on the
   card, at the serving path's three shapes (at B = 4, and at the
   MicroBatcher's buckets 1 and 32), at the fusion levels of every other
   shipped config (B = 4; heads of 8 to 256 values) and five ragged
   lengths, float32 and bfloat16, timed beside the plain version and a
   library yardstick, each by device time (torch.profiler) and by CUDA
   events;
3. the greedy NMS kernels (suppression bitmask, then the walk) against the
   plain loop on the card, B = 4, at K = 1, 1024 (the serving pool), 4096,
   8193 and 20000, at B = 1 and 32 with K = 1024, at B = 8, K = 8192 (the
   Evaluator's shape), and with padding of 0, -0.5 and -2 in place of -1;
   ties present: keep and ok must be equal. Each case prints its time and
   kept count;
3b. the fused conv3x3 + BatchNorm + SiLU kernel (64 channels) against its
   plain version, at the serving path's shape (4, 64, 160, 160), at
   batches 1 and 32 of it, on a 512 x 640 canvas (16, 64, 128, 160), six
   ragged ones and the validation path's rect (2, 64, 68, 84) and TTA
   (2, 64, 56, 56) maps, float32 and bfloat16, channels_last (the serving
   path's layout) and NCHW, timed like phase 2;
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
   the three kernels launched there, the stripped checkpoint served;
7. validation: the trained yolov5s-Transfusion checkpoint
   (artifacts/trained_s640) on its 141 held-out extval pairs at 640,
   batch 16, each run with the three kernels' launches counted: (a)
   python -m icafusion_tpu_torch.cli.val in fp32 with the MR txts, the
   COCO json scored against ground truth built from the labels, and the
   confusion matrix; (b) the Evaluator in bf16; (c) cli.val --rect (one
   544 x 672 canvas); (d) cli.val --augment, and the TTA predictions of
   two pairs on the card against the port's CPU run. mAP@50 of (a), (b)
   and (c) within 0.3 points of the JAX package's records and the
   reference stack's in TRAINED_PARITY_640.json;
8. serving through the entry points a user calls, each run with the three
   kernels' launches counted and held to 3 attention, 1 NMS and 5 (s) or
   6 (l) conv launches a batch: (a) python -m icafusion_tpu_torch.cli.detect
   on trained s640 over the 141 extval pairs, fp32, batch 16, square and
   --rect (one 512 x 640 canvas): every txt row equal to
   ServingEngine.predict_arrays' on the same letterboxed pairs; (b)
   predict_paths on a 512 x 640 engine, pipelined equal to serial equal
   to predict_arrays on decode_letterbox_batch; (c) the MicroBatcher over
   yolov5l-Transfusion 640 in bf16 (phase 4b's weights), every bucket
   warmed, 96 extval pairs submitted from 24 threads, held to serial
   batch-1 predict_arrays, with the latency of a lone request and the
   time a pair at bucket 32; (d) the HTTP server over s640 on 512 x 640 in
   bf16 with a MicroBatcher, 16 clients POSTing the 141 pairs as base64
   JPEGs, held to predict_arrays, /v1/stats and a 400; (e)
   ServingEngine.throughput at l 640, batch 4, bf16, beside phase 4c;
10. every shipped model config: (a) yolov5l_NiNfusion, yolov5l_Add,
   yolov5x_Transfusion, yolov5_VGG16_Transfusion and
   yolov5_ResNet50_Transfusion at 640 with seeded He-uniform weights
   (seeded_model): fp32 decoded predictions at batch 1 and the fused maps
   on the card against the port on the CPU (1e-3), then three bf16
   requests of 4 through predict_arrays with the launches held to the
   modules' (attention once per TransformerFusionBlock, the conv once per
   64-channel 3x3 SiLU Conv), and the device ms of a request's forward and
   NMS; (b) all 21 configs/models/*.yaml and zoo:dmaf:n at 320, batch 1,
   bf16: finite predictions, one detection array, the same launch rule;
   (c) phase 6a's card-against-CPU Trainer check for the nin, add and
   dmaf zoo kinds and narrow VGG16 and ResNet50 configs, with the CPU's
   own drift under one-ulp input changes printed beside;
11. int8 W8A8 serving: (a) the int8 conv kernel against its plain version
   at every quantized shape class of yolov5l-Transfusion 640, the rect
   canvas's P3 and two yolov5x widths, at B = 1, 4 and 32, fp32 and bf16
   (and NCHW input at B = 4): int32 accumulators equal, outputs within
   1e-5 (fp32) and 3e-2 (bf16) of the largest, timed beside the bound,
   the plain version, a cuDNN bf16 conv and, for 1x1, torch._int_mm, with
   the path each class takes (kernels/conv_int8.py: plan);
   (b) the flagship engine (phase 4b's weights) quantized by
   ServingEngine.quantize on two seeded batches, three counted requests
   (162 int8 launches a forward, 3 attention, 1 NMS, 0 fused convs),
   every int8 conv of a forward held to the plain version on its own
   input, each class's input layout and path (all but the stems on the
   tma path from a channels_last map, asserted), the summed time beside
   the first design's and cuDNN's, and device busy beside the bf16
   engine's; (c)
   cli.val --int8 on
   trained s640 (extval, fp32) within 0.3 mAP@50 points of the JAX int8
   record and of 7a, the same calibration served in bf16 (printed), and
   trained n320 within 0.3 points of its JAX int8 record; (d) the HTTP
   server --int8 calibrated on 16 extval pairs, then restarted from its
   <weights>.calib, its responses against predict_arrays.

Before the last line it prints one JSON object with each kernel's launches
on the main path (phases 4b, 8 and 10a; the int8 conv's in 11b), error,
device times (kernel, plain version and library yardstick, from
torch.profiler) and bound; the
last line is {"ok": true, "device": {...}}. Should the profiler record no
device time in two windows running, it is not used again in the run: later
device times come from calls queued behind a sleep kernel between CUDA
events (queued_ms), and the breakdowns by kernel print "not measured".
Exits non-zero without a CUDA device and outside a checkout of the
repository.
"""

from __future__ import annotations

import contextlib
import copy
import importlib.util
import io
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
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,   # dense
              torch.int8: 1979e12}
ATTN_SHAPES = ((400, 256), (256, 512), (100, 1024))   # (N, D) at P3/P4/P5
# the fusion levels of every other shipped config at 640: the n, s, m and x
# scales and the VGG16 and ResNet50 towers (dk 8 to 256), timed apart
ATTN_SHIPPED = ((400, 64), (256, 128), (100, 256), (400, 128), (256, 256),
                (100, 512), (400, 192), (256, 384), (100, 768), (400, 320),
                (256, 640), (100, 1280), (400, 512), (256, 1024), (100, 2048))
ATTN_RAGGED = ((1, 48), (63, 256), (65, 1024), (65, 1280), (63, 2048))
HEADS, BATCH = 8, 4
BUCKETS = (1, 32)     # the MicroBatcher's smallest and largest buckets
CONV_SHAPES = ((4, 64, 160, 160),    # the serving path: first C3 of a tower
               (1, 64, 160, 160),    # the batcher's buckets 1 and 32
               (32, 64, 160, 160),
               (16, 64, 128, 160),   # a 512 x 640 canvas (detect --rect,
                                     # predict_paths, the HTTP server)
               (1, 64, 20, 20), (2, 64, 10, 13), (1, 64, 7, 5),
               (1, 64, 1, 1),       # the halo is all padding
               (3, 64, 161, 33),    # ragged tiles in both directions
               (1, 64, 8, 16),      # one tile, fewer tiles than SMs
               (2, 64, 68, 84),     # rect val at 640: 544 x 672 canvas
               (2, 64, 56, 56))     # the third TTA pass at 640 (448)
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


# Set once torch.profiler has recorded no device event in two windows
# running: from then on device times come from queued_ms. CUPTI through
# torch.profiler records nothing now and then, and on some machines stops
# recording for the rest of the process.
PROFILER = {"dead": False}


def queued_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms without the profiler: the calls are
    queued behind a sleep kernel that outlasts their launches, so the card
    runs them back to back and two CUDA events around them time the card
    alone. Host launch work does not count; the card's own gaps between
    the kernels of a call do (the profiler's sum of kernel times does not
    count those)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t           # launch work, card running
    torch.cuda.synchronize()
    khz = getattr(torch.cuda.get_device_properties(0), "clock_rate", 0)
    hz = 1e3 * khz if khz else 2.0e9           # the H100's boost clock
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0, 2 * host_s + 1e-3) * hz))
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
    recorded no device event is profiled once again; if that one records
    nothing either, the profiler is not used again in this run, and this
    and every later call returns {"all kernels (queued_ms)": queued_ms}."""
    from torch.profiler import ProfilerActivity, profile
    if PROFILER["dead"]:
        return {"all kernels (queued_ms)": queued_ms(fn, iters, warmup)}
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = {e.key: e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA}
        if sum(us.values()):
            return {k: v / iters / 1e3 for k, v in us.items()}
        print("   (the profiler recorded no device time: again)")
    PROFILER["dead"] = True
    print("   (the profiler recorded no device time twice running: every "
          "later device time comes from queued CUDA events, queued_ms)")
    return {"all kernels (queued_ms)": queued_ms(fn, iters, warmup)}


def timing_source() -> str:
    return "queued_ms" if PROFILER["dead"] else "torch.profiler"


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, all its kernels summed."""
    return sum(device_times(fn, iters, warmup).values())


def both_ms(fn, iters: int = 20, warmup: int = 3):
    """(device time, CUDA-event time) of fn() in ms, as above."""
    return device_ms(fn, iters, warmup), cuda_ms(fn, iters, warmup)


def attention_case(B: int, N: int, D: int, dtype, gen: torch.Generator):
    dev = torch.device("cuda")
    vis = torch.randn(B, N, D, generator=gen).to(dev, dtype)
    ir = torch.randn(B, N, D, generator=gen).to(dev, dtype)
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


def attention_bound(B: int, N: int, D: int, dtype):
    s = torch.finfo(dtype).bits // 8
    flops = 12 * B * N * D * D + 8 * B * N * N * D
    nbytes = 4 * B * N * D * s + 6 * D * D * s + 6 * D * 4
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
    """Share of the rows of a with a row of r of the same class at IoU > 0.5,
    or within 1 px in every coordinate: a box of zero area has no IoU, and
    random weights give many (a saturated size logit underflows w or h to
    0)."""
    if not len(a):
        return 1.0
    if not len(r):
        return 0.0
    lt = np.maximum(a[:, None, :2], r[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], r[None, :, 2:4])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    iou = inter / (area(a)[:, None] + area(r)[None, :] - inter + 1e-9)
    near = np.abs(a[:, None, :4] - r[None, :, :4]).max(-1) <= 1.0
    same = a[:, None, 5] == r[None, :, 5]
    return float((((iou > 0.5) | near) & same).any(1).mean())


def nms_case(B: int, K: int, gen: torch.Generator, pad: float = -1.0):
    """Clustered boxes (so suppression happens), scores descending with
    runs of equal values (ties), a tail of `pad`, and, where B > 1, one
    image that is all `pad` (no live candidate when pad <= -1)."""
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
    if B > 1:
        s[B - 1] = pad
    return boxes.cuda().contiguous(), s.cuda().contiguous()


STEADY_REQUESTS = 20


def profile_calls(fn, n: int = 3):
    """(device time by kernel in us over n calls of fn, by torch.profiler
    / CUPTI; the profiled wall time in us). ({}, 0.0) once the profiler
    has been found to record nothing (PROFILER)."""
    from torch.profiler import ProfilerActivity, profile
    if PROFILER["dead"]:
        return {}, 0.0
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
    (the profiler's own host overhead stretches the profiled wall).
    Returns (device busy ms a request, idle share), or None where the
    profiler recorded nothing."""
    dev_us, wall_us = profile_calls(lambda: engine.predict_arrays(*pair), n)
    busy = sum(dev_us.values())
    if not busy:
        print("   device time by kernel: not measured (the profiler "
              "recorded no device events)")
        return None
    groups = {"dual_cross_attention": ("projections_wgmma_kernel",
                                       "flash_attention_kernel",
                                       "projections_f32_kernel",
                                       "attention_f32_kernel"),
              "greedy_nms": ("nms_mask_kernel", "nms_scan_kernel"),
              "conv3x3_bn_silu": ("conv3x3_bf16_nhwc_kernel",
                                  "conv3x3_bf16_nchw_kernel",
                                  "conv3x3_f32_kernel", "pack_weights_kernel"),
              "conv_int8_bn_act": ("conv_int8_kernel",
                                   "conv_int8_tma_kernel")}
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
    return busy_ms, 1 - busy_ms / wall_ms


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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--trained-l640"]):
        print("usage: chip_smoke.py [--trained-l640]", file=sys.stderr)
        return 2
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
             for m in ("msgpack", "yaml", "cv2", "PIL", "torchvision",
                       "matplotlib")}
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

    if argv == ["--trained-l640"]:
        with tempfile.TemporaryDirectory() as tmp:
            l640_slice(Path(tmp))
        print(f"== total {time.perf_counter() - t_all:.1f} s")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    report = {}
    gen = torch.Generator().manual_seed(0)

    t0 = phase("2 dual cross-attention vs plain (B=4, 1 and 32, h=8; every "
               "shipped width at B=4)")
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
    per_bucket = {}        # (B, dtype) -> kernel, plain, library ms a forward
    cases = ([(BATCH, N, D) for N, D in ATTN_SHAPES + ATTN_RAGGED
              + ATTN_SHIPPED]
             + [(B, N, D) for B in BUCKETS for N, D in ATTN_SHAPES])
    for dtype in (torch.float32, torch.bfloat16):
        for B, N, D in cases:
            vis, ir, ws, bs = attention_case(B, N, D, dtype, gen)
            out = dual_cross_attention(vis, ir, ws, bs, HEADS)
            ref = dual_cross_attention_reference(vis, ir, ws, bs, HEADS)
            torch.cuda.synchronize()
            rtol, atol = tol[dtype]
            err = 0.0
            for o, r in zip(out, ref):
                torch.testing.assert_close(o.float(), r.float(), rtol=rtol,
                                           atol=atol)
                err = max(err, (o.float() - r.float()).abs().max().item())
            if (N, D) in ATTN_RAGGED:
                print(f"   {str(dtype)[6:]:8s} B={B:2d} N={N:3d} D={D:4d}: "
                      f"max_abs_err {err:.3g} (ragged, not timed)")
                continue
            ms, ms_ev = both_ms(
                lambda: dual_cross_attention(vis, ir, ws, bs, HEADS))
            plain, plain_ev = both_ms(lambda: dual_cross_attention_reference(
                vis, ir, ws, bs, HEADS))
            lib, lib_ev = both_ms(lambda: attention_library(vis, ir, ws, bs))
            bnd, by = attention_bound(B, N, D, dtype)
            print(f"   {str(dtype)[6:]:8s} B={B:2d} N={N:3d} D={D:4d}: "
                  f"max_abs_err {err:.3g}  device ms: kernel {ms:.4f} plain "
                  f"{plain:.4f} "
                  f"library {lib:.4f}; events ms: kernel {ms_ev:.4f} plain "
                  f"{plain_ev:.4f} library {lib_ev:.4f}; bound {bnd:.5f} ms "
                  f"({by}){'' if (N, D) in ATTN_SHAPES else ' (shipped)'}")
            if (N, D) not in ATTN_SHAPES:
                continue
            acc = per_bucket.setdefault((B, dtype), [0.0, 0.0, 0.0, 0.0])
            for i, v in enumerate((ms, plain, lib, bnd)):
                acc[i] += v
            if dtype == torch.bfloat16 and B == BATCH:  # the engine's
                for k, v in (("ms", ms), ("plain_ms", plain),
                             ("bound_ms", bnd), ("library_ms", lib)):
                    main_path[k] += v
                events["ms"] += ms_ev
                events["library_ms"] += lib_ev
                main_path["max_abs_err"] = max(main_path["max_abs_err"], err)
                main_path["bound_by"].add(by)
    report["dual_cross_attention"] = main_path
    for (B, dtype), (k, p, l, b) in sorted(per_bucket.items(),
                                           key=lambda kv: kv[0][0]):
        print(f"   B={B:2d} {str(dtype)[6:]:8s} per forward (3 calls), device "
              f"time: kernel {k:.4f} ms, plain {p:.4f}, library {l:.4f}, "
              f"bound {b:.5f}")
    print(f"   per forward (3 calls, bf16), device time: kernel "
          f"{main_path['ms']:.4f} ms, plain {main_path['plain_ms']:.4f} ms, "
          f"library {main_path['library_ms']:.4f} ms, bound "
          f"{main_path['bound_ms']:.5f} ms; events: kernel "
          f"{events['ms']:.4f} ms, library {events['library_ms']:.4f} ms")
    done(t0)

    t0 = phase("3 greedy NMS vs plain loop (max_det=300)")
    for B, K, pad in ((BATCH, 1, -1.0), (BATCH, 1024, -1.0),
                      (BUCKETS[0], 1024, -1.0), (BUCKETS[1], 1024, -1.0),
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
        split = {k: f"{sum(v for n, v in by_kernel.items() if k in n):.4f}"
                 if not PROFILER["dead"] else "not measured"
                 for k in ("nms_mask_kernel", "nms_scan_kernel")}
        # per step and candidate of the argmax loop: 4 min/max, 2 sub,
        # 2 clamp, 2 mul, 2 add, 1 sub, 1 div, 1 compare = 15 operations
        bnd, by = bound(15 * B * K * 300, B * K * 20 + B * 300 * 5,
                        torch.float32)
        line = (f"   B={B} K={K:5d} pad={pad:4.1f}: keep/ok equal "
                f"({int(ok.sum())} kept)  device ms: kernels {ms:.4f} "
                f"(mask {split['nms_mask_kernel']}, walk "
                f"{split['nms_scan_kernel']})")
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

    with tempfile.TemporaryDirectory() as tmp:
        s640_fp32_map50 = val_slice(Path(tmp))

    with tempfile.TemporaryDirectory() as tmp:
        served = serve_slice(Path(tmp), model,
                             1e3 * BATCH / float(np.median(steady)), card)
    launches = {k: v + served[k] for k, v in launches.items()}
    del model, engine, fp32
    torch.cuda.empty_cache()

    full = full_width_slice(card)
    launches = {k: v + full[k] for k, v in launches.items()}
    t0 = phase(f"10b every shipped config and zoo:dmaf:n at "
               f"{ALL_CONFIGS_SIZE}, b1, bf16")
    all_configs_slice()
    done(t0)
    t0 = phase("10c train steps card vs CPU: tiny nin, add, dmaf; narrow "
               "VGG16, ResNet50 (64 px, b2, fp32)")
    train_families_card_vs_cpu()
    done(t0)

    report["conv_int8_bn_act"], int8 = int8_slice(card, s640_fp32_map50)
    launches["conv_int8_bn_act"] = int8["conv_int8_bn_act"]

    kernels = []
    for name, src, tpu in (
            ("dual_cross_attention",
             "icafusion_tpu_torch/csrc/dual_cross_attention.cu",
             "icafusion_tpu/kernels/cross_attention.py:71"),
            ("greedy_nms", "icafusion_tpu_torch/csrc/greedy_nms.cu",
             "icafusion_tpu/kernels/nms.py:71"),
            ("conv3x3_bn_silu", "icafusion_tpu_torch/csrc/conv3x3_bn_silu.cu",
             "icafusion_tpu/kernels/packed_conv.py:120"),
            # no Pallas kernel: XLA's int8 conv of Conv._int8_conv
            ("conv_int8_bn_act", "icafusion_tpu_torch/csrc/conv_int8.cu",
             "icafusion_tpu/nn/layers.py:172")):
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
ULP_DRAWS = 6


def train_card_vs_cpu(cfg=None, steps: int = 3, ulp_probe=()):
    """One tiny model (``cfg``, default the zoo's tiny DMFF model) from one
    batch, dropout off, on the card and on the CPU: the first step's
    gradients; then ``steps`` Trainer steps: loss and items rtol 1e-4,
    parameters, BatchNorm statistics and EMA within STATE_ATOL (the
    momentum printed). For each count of steps in ``ulp_probe`` it also
    prints how far the CPU's own state and loss items move when each RGB
    value moves by one ulp up, down or not at all (the most over ULP_DRAWS
    seeded draws): what rounding alone does to the comparison."""
    from icafusion_tpu_torch.config import load_hyp_config
    from icafusion_tpu_torch.models.assembler import build_model, init_weights
    from icafusion_tpu_torch.models.zoo import tiny_icafusion_config
    from icafusion_tpu_torch.train.loss import pad_targets
    from icafusion_tpu_torch.train.trainer import Trainer
    base = _no_dropout(init_weights(
        build_model(cfg or tiny_icafusion_config()),
        torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    rgb = torch.from_numpy(rng.random((2, 3, 64, 64), np.float32))
    ir = torch.from_numpy(rng.random((2, 3, 64, 64), np.float32))
    labels = [np.array([[0, 0.5, 0.5, 0.4, 0.4], [1, 0.25, 0.25, 0.2, 0.3],
                        [2, 0.7, 0.3, 0.1, 0.15]], np.float32)] * 2
    t, m = (torch.from_numpy(a) for a in pad_targets(labels, 8))

    def trainer(dev):
        return Trainer(copy.deepcopy(base), load_hyp_config(), epochs=3,
                       steps_per_epoch=1, batch_size=2, imgsz=64,
                       warmup_min_steps=2, device=dev)

    def cpu_run(x, n):
        tr = trainer("cpu")
        step = tr.make_train_step()
        mets = [step(x, ir, t, m) for _ in range(n)]
        return tr.model.state_dict(), mets

    drift, g = {}, torch.Generator().manual_seed(5)
    for n in ulp_probe:
        (ref, ref_mets), drift[n] = cpu_run(rgb, n), [0.0, 0.0]
        for _ in range(ULP_DRAWS):
            way = torch.randint(-1, 2, rgb.shape, generator=g).float()
            x = torch.where(way == 0, rgb, torch.nextafter(rgb, 2.0 * way))
            state, mets = cpu_run(x, n)
            drift[n][0] = max(drift[n][0], max(
                (v - ref[k]).abs().max().item() for k, v in state.items()
                if not k.endswith("num_batches_tracked")))
            drift[n][1] = max(drift[n][1], max(
                abs(float(a[k]) / float(b[k]) - 1) for a, b in
                zip(mets, ref_mets) for k in ("loss", "lbox", "lobj",
                                              "lcls")))
    runs, grads = {}, {}
    for dev in ("cuda", "cpu"):
        tr = trainer(dev)
        batch = [x.to(dev) for x in (rgb, ir, t, m)]
        model = copy.deepcopy(base).to(dev).train()
        tr.loss_fn(model(*batch[:2]), *batch[2:])[0].backward()
        grads[dev] = {k: p.grad.double().cpu()
                      for k, p in model.named_parameters()}
        step = tr.make_train_step()
        mets = [step(*batch) for _ in range(steps)]
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
          f"after {steps} steps: {worst}")
    for n, (ds, dl) in drift.items():
        print(f"   the CPU's own run of {n} steps, each RGB value one ulp off "
              f"({ULP_DRAWS} draws): state max |change| {ds:.3g}, loss "
              f"items max relative change {dl:.3g}")
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
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    print(f"   {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
          f"parameters; losses {[round(x, 4) for x in losses]}; "
          f"{moved}/{len(before)} state tensors moved")
    print(f"   step ms (host clock, synchronised): warm-up "
          f"{[round(x, 1) for x in ms[:TRAIN_WARMUP]]}, timed "
          f"{[round(x, 1) for x in timed]}; median {med:.2f} ms -> "
          f"{1e3 * TRAIN_BATCH / med:.1f} images/s (pairs)")
    if busy:
        print(f"   device busy {busy:.2f} ms per step (torch.profiler, 3 "
              f"steps; profiled wall {wall_us / 3 / 1e3:.2f} ms) -> idle "
              f"share {1 - busy / med:.3f} of the unprofiled median")
    else:
        print("   device busy and idle share: not measured (the profiler "
              "recorded no device events)")
    print(f"   peak memory {peak:.2f} GiB (max_memory_allocated); {card}")
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


def counted(fn, int8: bool = False):
    """fn() with every wrapper's launch count set to 0 just before it; (its
    result, the launches it made): the three TPU kernels' wrappers, and
    with int8 the int8 conv's too."""
    from icafusion_tpu_torch.kernels.conv_int8 import conv_int8_bn_act
    from icafusion_tpu_torch.kernels.cross_attention import dual_cross_attention
    from icafusion_tpu_torch.kernels.nms import greedy_nms
    from icafusion_tpu_torch.kernels.packed_conv import conv3x3_bn_silu
    wrappers = (dual_cross_attention, greedy_nms, conv3x3_bn_silu) + (
        (conv_int8_bn_act,) if int8 else ())
    for w in wrappers:
        w.launches = 0
    out = fn()
    return out, {w.__name__: w.launches for w in wrappers}


S640 = REPO / "artifacts" / "trained_s640"
S640_CFG = "yolov5s_Transfusion.yaml"
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



# Phase 8 (serving through the entry points a user calls) holds the
# results of the MicroBatcher and the HTTP server against serial
# predict_arrays calls on the same pairs, in bf16 at another batch size:
# the share of all their detections that have a partner of the same class
# (matched), both ways. cuDNN may take another algorithm at another batch,
# and one bf16 rounding can reorder near-tied scores or move a score across
# the threshold. The thresholds are set from a run on an H100 80GB HBM3
# at 700 W (PERF.md section 6), which measured 0.9965 behind the batcher
# (the random flagship at conf 0.001) and 0.9967 behind the HTTP server
# (trained s640 at conf 0.25).
MATCH_SHARE = {"http": 0.97, "batcher": 0.97}
SERVE_PAIRS, SERVE_THREADS = 96, 24
HTTP_THREADS = 16
RECT = (512, 640)
VIDEO_FRAMES = 10
# The random flagship amplifies a difference of rounding through its
# depth, so its bf16 decoded predictions at bucket 32 and at batch 1
# differ far more than the kernels do (that run: 439 px and 0.72 at most,
# 0.0027 at the 99th percentile of obj). In fp32 they are held to these
# (box rtol, box atol px, obj and cls atol); that run measured 0.23 px and
# 7.7e-4 at most.
FP32_BUCKET_TOL = (1e-3, 1.0, 5e-3)


def extval_files():
    """(rgb paths, ir paths) of the 141 extval pairs, in cli.detect's order."""
    from icafusion_tpu_torch.data.datasets import discover_images
    ext = S640 / "extval"
    return (discover_images(str(ext / "visible" / "val")),
            discover_images(str(ext / "infrared" / "val")))


def read_rgb(path):
    import cv2
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


def engine_rows(engine, files1, files2, canvas, auto: bool):
    """Per stem, the rows cli.detect --save-txt writes for each pair, from
    engine.predict_arrays on the pairs letterboxed as detect does
    (scaleup off): [cls, xc, yc, w, h, conf], normalised to the native
    image."""
    from icafusion_tpu_torch.data.augment import letterbox
    from icafusion_tpu_torch.ops.boxes import scale_coords_np
    out = {}
    B = engine.batch_size
    for s in range(0, len(files1), B):
        items = []
        for f1, f2 in zip(files1[s:s + B], files2[s:s + B]):
            a, b = read_rgb(f1), read_rgb(f2)
            la, ratio, pad = letterbox(a, canvas, scaleup=False, auto=auto)
            lb = letterbox(b, canvas, scaleup=False, auto=auto)[0]
            items.append((Path(f1).stem, la, lb, a.shape[:2], (ratio, pad)))
        dets = engine.predict_arrays(np.stack([it[1] for it in items]),
                                     np.stack([it[2] for it in items]))
        for (stem, _, _, (h0, w0), rp), d in zip(items, dets):
            d = d.copy()
            d[:, :4] = scale_coords_np(tuple(engine.canvas), d[:, :4],
                                       (h0, w0), ratio_pad=rp)
            x1, y1, x2, y2, conf, cls = d.T.astype(np.float64)
            out[stem] = np.stack([cls, (x1 + x2) / 2 / w0, (y1 + y2) / 2 / h0,
                                  (x2 - x1) / w0, (y2 - y1) / h0, conf], 1)
    return out


def check_txts(out_dir: Path, want: dict) -> int:
    """detect's txt of each stem against the engine's rows: the same count
    and classes, every number within 1e-4 (the txt prints six significant
    digits). Returns the rows compared."""
    n = 0
    for stem, rows in want.items():
        txt = out_dir / f"{stem}.txt"
        got = np.loadtxt(txt, ndmin=2) if txt.exists() else np.zeros((0, 6))
        assert got.shape == rows.shape, (stem, got.shape, rows.shape)
        assert np.array_equal(got[:, 0], rows[:, 0]), stem
        err = float(np.abs(got[:, 1:] - rows[:, 1:]).max()) if len(got) else 0
        assert err <= 1e-4, (stem, err)
        n += len(rows)
    return n


def txt_map50(out_dir: Path, files1) -> float:
    """mAP@50 of detect's txts against the extval labels, scored with the
    port's matching and eval/metrics.py."""
    from icafusion_tpu_torch.eval.evaluator import IOUV, match_predictions
    from icafusion_tpu_torch.eval.metrics import summarize

    def xyxy(r, h, w):
        cx, cy, bw, bh = r[:, 0] * w, r[:, 1] * h, r[:, 2] * w, r[:, 3] * h
        return np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                        1)

    stats = []
    for f in files1:
        stem = Path(f).stem
        h, w = read_rgb(f).shape[:2]
        lab = np.loadtxt(S640 / "extval" / "labels" / "val" / f"{stem}.txt",
                         ndmin=2)
        txt = out_dir / f"{stem}.txt"
        rows = np.loadtxt(txt, ndmin=2) if txt.exists() else np.zeros((0, 6))
        pred = np.concatenate([xyxy(rows[:, 1:5], h, w), rows[:, 5:6],
                               rows[:, :1]], 1)
        correct = (match_predictions(pred, xyxy(lab[:, 1:5], h, w), lab[:, 0])
                   if len(pred) else np.zeros((0, len(IOUV)), bool))
        stats.append((correct, pred[:, 4], pred[:, 5], lab[:, 0]))
    return summarize(stats, 3)["map50"]


def check_match(tag, got, want, gate):
    """The share of all detections of got with a partner in want (matched,
    pair by pair), and of want in got; both at least gate."""
    def share(a, b):
        n = sum(len(x) for x in a)
        return sum(matched(x, y) * len(x) for x, y in zip(a, b)) / max(n, 1)

    fwd, back = share(got, want), share(want, got)
    worst = min(min(matched(g, w), matched(w, g)) for g, w in zip(got, want))
    print(f"   {tag}: share of detections matched (same class, IoU > 0.5 "
          f"or within 1 px): "
          f"{fwd:.4f} of {sum(map(len, got))}, back {back:.4f} of "
          f"{sum(map(len, want))} (gate >= {gate}); the worst pair "
          f"{worst:.4f}")
    assert min(fwd, back) >= gate, (tag, fwd, back)


def serve_slice(work: Path, model_l, pairs_per_s: float, card: str) -> dict:
    """Phase 8: the serving entry points on the card. (a) cli.detect on the
    trained s640 checkpoint over the 141 extval pairs, square and --rect;
    (b) ServingEngine.predict_paths, pipelined and not; (c) the
    MicroBatcher over the flagship at 640 in bf16 (model_l: random weights
    from seed 0); (d) the HTTP server with a MicroBatcher over s640;
    (e) ServingEngine.throughput. Returns the launches of the three kernels
    summed over (a)-(d)."""
    from icafusion_tpu_torch.cli import detect as cli_detect
    from icafusion_tpu_torch.cli._common import load_model_for_inference
    from icafusion_tpu_torch.data.decode import decode_letterbox_batch
    from icafusion_tpu_torch.serve.engine import ServingEngine

    files1, files2 = extval_files()
    n_pairs = len(files1)
    total = {"dual_cross_attention": 0, "greedy_nms": 0, "conv3x3_bn_silu": 0}

    def add(launches, batches, convs):
        want = {"dual_cross_attention": 3 * batches, "greedy_nms": batches,
                "conv3x3_bn_silu": convs * batches}
        assert launches == want, (launches, want)
        for k, v in launches.items():
            total[k] += v

    _, s640 = load_model_for_inference(S640_CFG, str(S640 / "stripped.ckpt"),
                                       nc=3)
    batches = -(-n_pairs // VAL_BATCH)
    base = ["--weights", str(S640 / "stripped.ckpt"), "--cfg", S640_CFG,
            "--source1", str(S640 / "extval" / "visible" / "val"),
            "--source2", str(S640 / "extval" / "infrared" / "val"),
            "--img-size", "640", "--batch-size", str(VAL_BATCH),
            "--conf-thres", "0.001", "--iou-thres", "0.5", "--save-txt",
            "--save-conf", "--nosave"]
    kw = dict(batch_size=VAL_BATCH, conf_thres=0.001, iou_thres=0.5,
              dtype="float32")
    rect_engine = ServingEngine(s640, RECT, **kw)
    for tag, extra, engine, auto in (
            ("square 640", [], ServingEngine(s640, 640, **kw), False),
            ("--rect", ["--rect"], rect_engine, True)):
        t0 = phase(f"8a cli.detect s640 fp32 {tag}, {n_pairs} extval pairs, "
                   f"batch {VAL_BATCH}")
        out = work / f"8a{len(extra)}"
        said = io.StringIO()      # a line an image: kept out of the report
        t = time.perf_counter()
        with contextlib.redirect_stdout(said):
            _, launches = counted(lambda: cli_detect.main(
                base + extra + ["--save-dir", str(out)]))
        wall = time.perf_counter() - t
        print(f"   cli.detect: {said.getvalue().splitlines()[-2]}")
        add(launches, batches, 5)
        rows = check_txts(out, engine_rows(engine, files1, files2,
                                           640 if auto else engine.canvas,
                                           auto))
        print(f"   {wall:.1f} s for {n_pairs} pairs; launches {launches}; "
              f"{rows} txt rows equal predict_arrays' (classes exact, "
              f"numbers within 1e-4); mAP@50 of the txts "
              f"{txt_map50(out, files1):.5f} (best-class NMS at top_k 1024: "
              f"not gated)")
        done(t0)

    t0 = phase(f"8b predict_paths s640 fp32 on {RECT}, batch {VAL_BATCH}")
    t = time.perf_counter()
    piped, launches = counted(lambda: rect_engine.predict_paths(files1,
                                                                files2))
    t_piped = time.perf_counter() - t
    add(launches, batches, 5)
    t = time.perf_counter()
    serial = rect_engine.predict_paths(files1, files2, pipeline=False)
    t_serial = time.perf_counter() - t
    rgb, ir, _, _, hw = decode_letterbox_batch(files1, files2, RECT,
                                               scaleup=True)
    direct = []
    for s in range(0, n_pairs, VAL_BATCH):
        part = slice(s, s + VAL_BATCH)
        direct += rect_engine.predict_arrays(rgb[part], ir[part],
                                             orig_hw=hw[part].tolist())
    assert len(piped) == len(serial) == len(direct) == n_pairs
    for a, b, c in zip(piped, serial, direct):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    print(f"   pipelined {t_piped:.2f} s, serial {t_serial:.2f} s (host "
          f"clock, {n_pairs} pairs); equal to each other and to "
          f"predict_arrays on decode_letterbox_batch ({sum(map(len, piped))} "
          f"detections); launches {launches}")
    done(t0)

    t0 = phase("8c MicroBatcher: yolov5l-Transfusion 640, bf16, batch_size "
               f"32, {SERVE_PAIRS} pairs from {SERVE_THREADS} threads")
    served = microbatcher_slice(model_l, files1, files2, add)
    done(t0)

    t0 = phase(f"8d HTTP server: s640 on {RECT}, bf16, MicroBatcher, "
               f"{HTTP_THREADS} client threads")
    http_slice(s640, files1, files2, add)
    done(t0)

    t0 = phase("8e ServingEngine.throughput: yolov5l-Transfusion 640, b4, "
               "bf16 (not gated)")
    engine = ServingEngine(model_l, 640, BATCH, conf_thres=0.001)
    rng = np.random.default_rng(3)
    pair = [rng.integers(0, 256, (BATCH, 640, 640, 3), np.uint8)
            for _ in range(2)]
    engine.predict_arrays(*pair)
    t = time.perf_counter()
    for _ in range(20):
        engine.predict_arrays(*pair)
    arrays_rate = 20 * BATCH / (time.perf_counter() - t)
    rate = engine.throughput(20)
    print(f"   throughput() {rate:.1f} pairs/s (host clock, 20 calls on "
          f"device tensors, one synchronisation); 20 predict_arrays calls "
          f"just before it {arrays_rate:.1f} pairs/s, phase 4c's "
          f"{pairs_per_s:.1f}; {card}")
    del engine
    done(t0)

    t0 = phase(f"8f cli.detect on a pair of {VIDEO_FRAMES}-frame MJPG videos, "
               "s640 fp32")
    video_slice(work, s640, files1, files2, add)
    done(t0)
    return total


def video_slice(work: Path, s640, files1, files2, add):
    """8f: the video branch of cli.detect over two MJPG .avi files written
    from extval pairs: each frame's detections (recorded where detect draws
    them) equal predict_arrays' on the frames cv2 reads back."""
    import cv2

    from icafusion_tpu_torch.cli import detect as cli_detect
    from icafusion_tpu_torch.data.augment import letterbox
    from icafusion_tpu_torch.serve.engine import ServingEngine

    paths, frames = [], []
    for files, name in ((files1, "rgb.avi"), (files2, "ir.avi")):
        p = work / name
        w = cv2.VideoWriter(str(p), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                            (640, 512))
        assert w.isOpened(), "cv2 cannot write MJPG"
        for f in files[:VIDEO_FRAMES]:
            w.write(cv2.imread(f))
        w.release()
        cap, got = cv2.VideoCapture(str(p)), []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            got.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
        cap.release()
        assert len(got) == VIDEO_FRAMES, (name, len(got))
        paths.append(str(p))
        frames.append(got)
    seen = []
    draw = cli_detect._annotate_bgr

    def record(im0, pred, names, args):
        seen.append(pred.copy())
        return draw(im0, pred, names, args)

    cli_detect._annotate_bgr = record
    try:
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            n, launches = counted(lambda: cli_detect.main([
                "--weights", str(S640 / "stripped.ckpt"), "--cfg", S640_CFG,
                "--source1", paths[0], "--source2", paths[1], "--img-size",
                "640", "--conf-thres", "0.001", "--iou-thres", "0.5",
                "--nosave", "--save-dir", str(work / "8f")]))
    finally:
        cli_detect._annotate_bgr = draw
    assert n == len(seen) == VIDEO_FRAMES, (n, len(seen))
    add(launches, n, 5)
    engine = ServingEngine(s640, 640, 1, conf_thres=0.001, iou_thres=0.5,
                           dtype="float32")
    rows = 0
    for pred, a, b in zip(seen, *frames):
        want = engine.predict_arrays(letterbox(a, 640)[0][None],
                                     letterbox(b, 640)[0][None],
                                     orig_hw=[a.shape[:2]])[0]
        assert pred.shape == want.shape, (pred.shape, want.shape)
        assert np.array_equal(pred[:, 5], want[:, 5])
        assert not len(pred) or np.abs(pred[:, :5] - want[:, :5]).max() <= 1e-4
        rows += len(pred)
    print(f"   cli.detect: {said.getvalue().splitlines()[-1]}; {n} frames, "
          f"launches {launches}; {rows} detections equal predict_arrays' on "
          f"the frames read back (classes exact, numbers within 1e-4)")


def microbatcher_slice(model_l, files1, files2, add):
    """8c: warm every bucket, then SERVE_PAIRS letterboxed extval pairs
    submitted from SERVE_THREADS threads; each result against a serial
    predict_arrays of its pair at batch 1."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from icafusion_tpu_torch.data.augment import letterbox
    from icafusion_tpu_torch.serve.batcher import MicroBatcher
    from icafusion_tpu_torch.serve.engine import ServingEngine

    pairs = [(letterbox(read_rgb(a), 640)[0], letterbox(read_rgb(b), 640)[0])
             for a, b in zip(files1[:SERVE_PAIRS], files2[:SERVE_PAIRS])]
    engine = ServingEngine(model_l, 640, 32, conf_thres=0.001)
    with MicroBatcher(engine) as mb:
        t = time.perf_counter()
        mb.warmup()
        print(f"   warm-up of buckets {mb.buckets}: "
              f"{time.perf_counter() - t:.1f} s")
        barrier = threading.Barrier(SERVE_THREADS)

        def client(j):
            barrier.wait(timeout=120)
            return [(i, mb.submit(*pairs[i]))
                    for i in range(j, SERVE_PAIRS, SERVE_THREADS)]

        def run():
            with ThreadPoolExecutor(SERVE_THREADS) as ex:
                return [r for rs in ex.map(client, range(SERVE_THREADS))
                        for r in rs]

        t = time.perf_counter()
        results, launches = counted(run)
        wall = time.perf_counter() - t
        stats = mb.stats()
        assert stats["requests"] == SERVE_PAIRS, stats
        add(launches, stats["batches"], CONVS_PER_FORWARD)
        print(f"   {SERVE_PAIRS} requests in {wall:.2f} s -> "
              f"{SERVE_PAIRS / wall:.1f} pairs/s; stats {stats}; launches "
              f"{launches}")
        lat = []
        for i in range(10):
            t = time.perf_counter()
            mb.submit(*pairs[i % len(pairs)])
            lat.append(1e3 * (time.perf_counter() - t))
        big = [np.stack([p[k] for p in pairs[:32]]) for k in (0, 1)]
        per32 = []
        for _ in range(5):
            t = time.perf_counter()
            engine._finalize(*engine._dispatch(*big, batch=32))
            per32.append(1e3 * (time.perf_counter() - t) / 32)
        print(f"   host clock: a lone request (bucket 1) median "
              f"{np.median(lat):.2f} ms over 10; bucket 32 "
              f"{np.median(per32):.3f} ms a pair (median of 5)")
    one = ServingEngine(model_l, 640, 1, conf_thres=0.001)
    serial = [one.predict_arrays(a[None], b[None])[0] for a, b in pairs]
    got = [r for _, r in sorted(results, key=lambda x: x[0])]
    print(f"   detections a pair: batcher {np.mean([len(g) for g in got]):.1f}"
          f", serial {np.mean([len(w) for w in serial]):.1f}")
    check_match("batcher vs serial batch 1", got, serial,
                MATCH_SHARE["batcher"])
    # decoded predictions of 4 pairs at bucket 1 and at bucket 32
    x = [np.stack([p[k] for p in pairs[:32]]) for k in (0, 1)]
    fp32 = ServingEngine(model_l, 640, 32, dtype="float32")
    rtol, atol, score_tol = FP32_BUCKET_TOL
    for eng in (engine, fp32):
        with torch.inference_mode():
            rgb, ir = ((torch.from_numpy(a).to(eng.device).permute(0, 3, 1, 2)
                        .float() / 255.0).to(eng.dtype) for a in x)
            big = eng.model(rgb, ir)[:4].float()
            alone = torch.cat([eng.model(rgb[i:i + 1], ir[i:i + 1])
                               for i in range(4)]).float()
        d = (alone - big).abs()
        print(f"   {str(eng.dtype)[6:]} decoded predictions, bucket 1 vs "
              f"bucket 32 (4 pairs): max |box| {d[..., :4].max():.4g} px, "
              f"max |obj| {d[..., 4].max():.4g}, max |cls| "
              f"{d[..., 5:].max():.4g}, 99th percentile |obj| "
              f"{torch.quantile(d[..., 4].flatten(), 0.99):.4g}")
    torch.testing.assert_close(alone[..., :4], big[..., :4], rtol=rtol,
                               atol=atol)
    assert d[..., 4:].max() <= score_tol, float(d[..., 4:].max())


def http_slice(s640, files1, files2, add):
    """8d: the HTTP server with a MicroBatcher over s640 on the 512 x 640
    canvas in bf16, on 127.0.0.1 in a thread; HTTP_THREADS clients POST
    the extval pairs as base64 JPEGs."""
    import base64
    import http.client
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from icafusion_tpu_torch.data.augment import letterbox
    from icafusion_tpu_torch.serve import http_server
    from icafusion_tpu_torch.serve.batcher import MicroBatcher
    from icafusion_tpu_torch.serve.engine import ServingEngine

    def request(port, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request(method, path, body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, data

    engine = ServingEngine(s640, RECT, 32)
    with MicroBatcher(engine) as mb:
        mb.warmup()
        srv = http_server.make_server(engine, mb, ["red", "green", "blue"],
                                      host="127.0.0.1", port=0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        port = srv.server_address[1]
        bodies = [json.dumps({"rgb": base64.b64encode(Path(a).read_bytes())
                              .decode(), "ir": base64.b64encode(
                                  Path(b).read_bytes()).decode()})
                  for a, b in zip(files1, files2)]
        try:
            t = time.perf_counter()
            with ThreadPoolExecutor(HTTP_THREADS) as ex:
                replies, launches = counted(lambda: list(ex.map(
                    lambda body: request(port, "POST", "/v1/detect", body),
                    bodies)))
            wall = time.perf_counter() - t
            status, data = request(port, "GET", "/v1/stats")
            stats = json.loads(data)
            bad = request(port, "POST", "/v1/detect", '{"rgb": "nope!!"}')
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)
    assert status == 200 and stats["requests"] == len(files1), stats
    assert bad[0] == 400 and "error" in json.loads(bad[1]), bad
    add(launches, stats["batches"], 5)
    got = []
    for code, data in replies:
        assert code == 200, (code, data[:200])
        got.append(np.array([[r[k] for k in ("xmin", "ymin", "xmax", "ymax",
                                             "confidence", "class")]
                             for r in json.loads(data)],
                            np.float32).reshape(-1, 6))
    want = []
    for s in range(0, len(files1), engine.batch_size):
        imgs = [(read_rgb(a), read_rgb(b)) for a, b in
                zip(files1[s:s + engine.batch_size],
                    files2[s:s + engine.batch_size])]
        lb = [np.stack([letterbox(p[k], RECT)[0] for p in imgs])
              for k in (0, 1)]
        want += engine.predict_arrays(*lb, orig_hw=[p[0].shape[:2]
                                                    for p in imgs])
    print(f"   {len(files1)} POSTs in {wall:.2f} s -> "
          f"{len(files1) / wall:.1f} pairs/s; stats {stats}; launches "
          f"{launches}; malformed body -> {bad[0]}; detections a pair "
          f"{np.mean([len(g) for g in got]):.2f}")
    check_match("HTTP vs predict_arrays", got, want, MATCH_SHARE["http"])



L640 = REPO / "artifacts" / "trained_l640"
L640_CFG = "yolov5l_Transfusion.yaml"


def l640_slice(work: Path):
    """chip_smoke.py --trained-l640: the trained flagship
    (artifacts/trained_l640, yolov5l-Transfusion at 640) over the 141
    extval pairs: (a) cli.detect fp32, every txt row equal to
    predict_arrays'; (b) cli.val fp32, mAP@50 within 0.3 points of
    TRAINED_PARITY_L640.json's JAX and reference-stack records; (d)
    cli.val --int8 fp32, within 0.3 points of the JAX int8 record; (c)
    the Evaluator in bf16 beside the JAX bf16 record (not gated). The
    checkpoint and extval do not fit one chip copy beside the whole tree,
    so this runs apart from the default phases, in a copy without docs/,
    trained_n320 and trained_s640/stripped.ckpt."""
    from icafusion_tpu_torch.cli import detect as cli_detect
    from icafusion_tpu_torch.cli import val as cli_val
    from icafusion_tpu_torch.cli._common import load_model_for_inference
    from icafusion_tpu_torch.data.datasets import PairedDetectionDataset
    from icafusion_tpu_torch.data.loader import PairedLoader
    from icafusion_tpu_torch.eval.evaluator import Evaluator
    from icafusion_tpu_torch.serve.engine import ServingEngine

    rec = json.loads((REPO / "TRAINED_PARITY_L640.json").read_text())
    jax_rec = {k: rec["ours"][k]["ref_scored"]["map50"]
               for k in ("fp32", "bf16")}
    ext = S640 / "extval"
    files1, files2 = extval_files()
    batches = -(-len(files1) // VAL_BATCH)
    want = {"dual_cross_attention": 3 * batches, "greedy_nms": batches,
            "conv3x3_bn_silu": CONVS_PER_FORWARD * batches}
    _, l640 = load_model_for_inference(L640_CFG, str(L640 / "stripped.ckpt"),
                                       nc=3)

    t0 = phase(f"9a cli.detect trained l640 fp32, {len(files1)} extval "
               f"pairs, batch {VAL_BATCH}")
    out = work / "9a"
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        _, launches = counted(lambda: cli_detect.main([
            "--weights", str(L640 / "stripped.ckpt"), "--cfg", L640_CFG,
            "--source1", str(ext / "visible" / "val"),
            "--source2", str(ext / "infrared" / "val"), "--img-size", "640",
            "--batch-size", str(VAL_BATCH), "--conf-thres", "0.001",
            "--iou-thres", "0.5", "--save-txt", "--save-conf", "--nosave",
            "--save-dir", str(out)]))
    assert launches == want, (launches, want)
    engine = ServingEngine(l640, 640, VAL_BATCH, conf_thres=0.001,
                           iou_thres=0.5, dtype="float32")
    rows = check_txts(out, engine_rows(engine, files1, files2, (640, 640),
                                       False))
    del engine
    print(f"   cli.detect: {said.getvalue().splitlines()[-2]}; launches "
          f"{launches}; {rows} txt rows equal predict_arrays' (classes "
          f"exact, numbers within 1e-4); mAP@50 of the txts "
          f"{txt_map50(out, files1):.5f} (best-class NMS at top_k 1024: not "
          f"gated)")
    done(t0)

    t0 = phase("9b cli.val trained l640 fp32")
    data = work / "extval.yaml"
    data.write_text(f"path: {ext}\nval_rgb: visible/val\n"
                    "val_ir: infrared/val\nnc: 3\n"
                    "names: ['red', 'green', 'blue']\n")
    r, launches = counted(lambda: cli_val.main([
        "--weights", str(L640 / "stripped.ckpt"), "--cfg", L640_CFG,
        "--data", str(data), "--img-size", "640", "--batch-size",
        str(VAL_BATCH), "--save-dir", str(work / "9b")]))
    ref = rec["torch"]["map50"]
    print(f"   fp32: mAP@50 {r['map50']:.5f} mAP {r['map']:.5f} over "
          f"{r['seen']} pairs; JAX fp32 record {jax_rec['fp32']:.5f} (delta "
          f"{100 * (r['map50'] - jax_rec['fp32']):+.3f} pts), reference stack "
          f"{ref:.5f} (delta {100 * (r['map50'] - ref):+.3f} pts); "
          f"{r['t_total_ms']:.2f} ms per image; launches {launches}")
    assert r["seen"] == len(files1) and launches == want, launches
    assert abs(r["map50"] - jax_rec["fp32"]) <= MAP50_GATE, r["map50"]
    assert abs(r["map50"] - ref) <= MAP50_GATE, r["map50"]
    done(t0)

    t0 = phase("9d cli.val --int8 trained l640 fp32")
    link = work / "l640.ckpt"       # <weights>.calib is written beside it
    link.symlink_to(L640 / "stripped.ckpt")
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        r, launches = counted(lambda: cli_val.main([
            "--weights", str(link), "--cfg", L640_CFG, "--data", str(data),
            "--img-size", "640", "--batch-size", str(VAL_BATCH), "--int8",
            "--save-dir", str(work / "9d")]), int8=True)
    rec_int8 = int8_record("l640")
    print(f"   int8 fp32: mAP@50 {r['map50']:.5f} mAP {r['map']:.5f}; JAX "
          f"int8 record {rec_int8:.5f} (delta "
          f"{100 * (r['map50'] - rec_int8):+.3f} pts); {r['t_total_ms']:.2f} "
          f"ms per image; launches {launches}")
    assert launches["conv_int8_bn_act"] == INT8_CONVS_L * batches, launches
    assert abs(r["map50"] - rec_int8) <= MAP50_GATE, r["map50"]
    done(t0)

    t0 = phase("9c Evaluator trained l640 bf16 (not gated)")
    ds = PairedDetectionDataset(str(ext / "visible" / "val"),
                                str(ext / "infrared" / "val"), 640, nc=3)
    r = Evaluator(l640, nc=3, dtype="bfloat16").run(
        PairedLoader(ds, VAL_BATCH).val_batches(), 640)
    print(f"   bf16: mAP@50 {r['map50']:.5f} mAP {r['map']:.5f}; JAX bf16 "
          f"record {jax_rec['bf16']:.5f} (delta "
          f"{100 * (r['map50'] - jax_rec['bf16']):+.3f} pts); "
          f"{r['t_total_ms']:.2f} ms per image")
    done(t0)


# Phase 10: every shipped model config on the card.
FULL_WIDTH = ("yolov5l_NiNfusion.yaml", "yolov5l_Add.yaml",
              "yolov5x_Transfusion.yaml", "yolov5_VGG16_Transfusion.yaml",
              "yolov5_ResNet50_Transfusion.yaml")
FULL_REQUESTS = 3        # bf16 requests of BATCH pairs a config, counted
ALL_CONFIGS_SIZE = 320
RESIDUAL_SCALE = 0.3     # see seeded_model


def narrow_config(kind: str):
    """Narrow two-stream VGG16 (TransformerFusionBlocks at grids 4x4, 4x4,
    2x2) and ResNet50 (NiNfusion) configs for 64 px training: the zoo's
    graphs at a fraction of the widths, as tests/test_torch_port_backbones.py
    builds them."""
    from icafusion_tpu_torch.models import zoo
    if kind == "vgg16":
        tower = lambda f: [[f, 1, "VGGblock", [2, 3, 8]],
                           [-1, 1, "VGGblock", [2, 8, 16]],
                           [-1, 1, "VGGblock", [3, 16, 16]],
                           [-1, 1, "VGGblock", [3, 16, 24]],
                           [-1, 1, "VGGblock", [3, 24, 32]]]
        fused = [[[2, 7], 1, "TransformerFusionBlock", [16, 4, 4]],
                 [[3, 8], 1, "TransformerFusionBlock", [24, 4, 4]],
                 [[4, 9], 1, "TransformerFusionBlock", [32, 2, 2]]]
        return zoo._two_stream(tower(-1) + tower(-4), "tfb", fused, 3, 1.0,
                               1.0, zoo.COCO_ANCHORS, "narrow_vgg16",
                               widths=(32, 16), p5_out=32)
    tower = lambda f: [[f, 1, "ResNetlayer", [3, 8, 1, "True", 1]],
                       [-1, 1, "ResNetlayer", [8, 8, 1, "False", 1]],
                       [-1, 1, "ResNetlayer", [32, 8, 2, "False", 2]],
                       [-1, 1, "ResNetlayer", [32, 16, 2, "False", 1]],
                       [-1, 1, "ResNetlayer", [64, 16, 2, "False", 1]]]
    fused = zoo._fusion_rows("nin", ((2, 7), (3, 8), (4, 9)), (32, 64, 64))
    return zoo._two_stream(tower(-1) + tower(-4), "nin", fused, 3, 1.0, 1.0,
                           zoo.COCO_ANCHORS, "narrow_resnet50",
                           widths=(32, 16))


def seeded_model(cfg, residual_scale: float = RESIDUAL_SCALE):
    """``cfg`` with build_model's He-uniform weights from seed 0, as phases
    4a and 4b draw them, and in each ResNet50 bottleneck the last
    BatchNorm's scale at ``residual_scale`` (1.0 leaves build_model's).
    With BatchNorm at identity statistics every bottleneck would otherwise
    add a branch as large as its input, doubling the residual stream's
    variance 16 times over, and fp32 itself then misses 10a's 1e-3: on
    ResNet50-Transfusion at 640 the CPU's own fp32 predictions lie 3.8
    times that bound from a float64 run, the card's 8.1 times (2.2 with
    cuDNN off), each of its layers' own error within 1-9 times the CPU's
    (port_probes.py fp64; PERF.md, section 6). At 0.3 the variance grows
    by 1.09 a block, about 4 in all, those ratios fall to 0.05 and 0.19,
    and the towers still carry the signal: a wrong attention output moves
    the boxes by pixels."""
    from icafusion_tpu_torch.models.assembler import build_model
    from icafusion_tpu_torch.nn.backbones import ResNetblock
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ResNetblock):
                m.bn3.weight.fill_(residual_scale)
    return model


def expected_launches(model, requests: int) -> dict:
    """What a forward launches, from the modules: the attention once per
    TransformerFusionBlock, the fused conv once per 64-channel 3x3 SiLU
    Conv (none in the VGG16 and ResNet50 towers, nor at the m and x scales,
    whose C3 widths never reach 64), NMS once a batch."""
    from icafusion_tpu_torch.nn.fusion import TransformerFusionBlock
    from icafusion_tpu_torch.nn.layers import Conv
    mods = list(model.modules())
    return {"dual_cross_attention": requests * sum(
                isinstance(m, TransformerFusionBlock) for m in mods),
            "greedy_nms": requests,
            "conv3x3_bn_silu": requests * sum(
                isinstance(m, Conv) and m.fused for m in mods)}


def full_width_slice(card: str) -> dict:
    """Phase 10a: five shipped configs at 640 with seeded weights
    (seeded_model). fp32 decoded predictions at batch 1, card against the
    port on the CPU (rtol/atol 1e-3, as 4a); then FULL_REQUESTS bf16
    requests of BATCH pairs through ServingEngine.predict_arrays with
    every launch counted and held to expected_launches; the device ms of
    a request's forward and NMS on uploaded pairs. Returns the launches of
    the counted requests."""
    from icafusion_tpu_torch.config import load_model_config
    from icafusion_tpu_torch.nn import backbones, fusion
    from icafusion_tpu_torch.nn.layers import Conv
    from icafusion_tpu_torch.serve.engine import ServingEngine
    total = {"dual_cross_attention": 0, "greedy_nms": 0, "conv3x3_bn_silu": 0}
    FUSIONS = (fusion.TransformerFusionBlock, fusion.NiNfusion, fusion.Add)
    rng = np.random.default_rng(10)
    for name in FULL_WIDTH:
        t0 = phase(f"10a {name} at 640: fp32 card vs CPU (b1), bf16 serving "
                   f"(b{BATCH})")
        model = seeded_model(load_model_config(name))
        n_params = sum(p.numel() for p in model.parameters())
        towers = [m for m in model.modules()
                  if isinstance(m, (backbones.VGGblock,
                                    backbones.ResNetlayer))]
        assert not any(isinstance(m, Conv) for t in towers
                       for m in t.modules()), name
        one = [rng.integers(0, 256, (1, 640, 640, 3), np.uint8)
               for _ in range(2)]
        preds, fused = {}, {}
        for dev in ("cuda", "cpu"):
            eng = ServingEngine(model, 640, 1, conf_thres=0.001,
                                dtype="float32", device=dev)
            fused[dev] = {}
            hooks = [m.register_forward_hook(
                lambda mod, i, o, n=n, d=fused[dev]: d.__setitem__(n, o.cpu()))
                for n, m in eng.model.named_children()
                if isinstance(m, FUSIONS)]
            with torch.inference_mode():
                x, y = (torch.from_numpy(a).to(dev).permute(0, 3, 1, 2)
                        .float() / 255 for a in one)
                preds[dev] = eng.model(x, y).cpu()
            for h in hooks:
                h.remove()
            del eng
        torch.testing.assert_close(preds["cuda"], preds["cpu"], rtol=1e-3,
                                   atol=1e-3)
        err = (preds["cuda"] - preds["cpu"]).abs().max().item()
        # the fused P3/P4/P5 maps, where the attention kernel enters: max
        # |card - CPU| within 1e-3 of the map's largest value
        rel = {n: ((fused["cuda"][n] - v).abs().max()
                   / v.abs().max()).item()
               for n, v in fused["cpu"].items()}
        assert len(rel) == 3 and max(rel.values()) <= 1e-3, rel
        engine = ServingEngine(model, 640, BATCH, conf_thres=0.001,
                               dtype="bfloat16")
        pair = [rng.integers(0, 256, (BATCH, 640, 640, 3), np.uint8)
                for _ in range(2)]
        engine.predict_arrays(*pair)                      # warm-up
        torch.cuda.synchronize()
        req_ms = []

        def serve():
            for _ in range(FULL_REQUESTS):
                t = time.perf_counter()
                out = engine.predict_arrays(*pair)
                req_ms.append(1e3 * (time.perf_counter() - t))
            return out

        out, launches = counted(serve)
        want = expected_launches(engine.model, FULL_REQUESTS)
        assert launches == want, (name, launches, want)
        assert len(out) == BATCH and all(
            x.ndim == 2 and x.shape[1] == 6 and np.isfinite(x).all()
            for x in out), [x.shape for x in out]
        for k, v in launches.items():
            total[k] += v
        on_card = [torch.from_numpy(a).cuda() for a in pair]
        dev_ms = device_ms(lambda: engine._serve(*on_card), iters=5,
                           warmup=1)
        print(f"   {n_params / 1e6:.1f} M parameters; fp32 decoded "
              f"predictions card vs CPU max |diff| {err:.3g} (rtol/atol "
              f"1e-3), fused maps max |diff| / max |CPU| "
              f"{max(rel.values()):.3g}; bf16 request of {BATCH}: device "
              f"{dev_ms:.3f} ms (forward + NMS on uploaded pairs, "
              f"{timing_source()}), "
              f"predict_arrays host clock "
              f"{[round(x, 1) for x in req_ms]} ms; launches in "
              f"{FULL_REQUESTS} requests {launches}; detections per image "
              f"{[len(x) for x in out]}; {card}")
        del model, engine, preds
        torch.cuda.empty_cache()
        done(t0)
    return total


def all_configs_slice():
    """Phase 10b: every configs/models/*.yaml and zoo:dmaf:n on the card at
    ALL_CONFIGS_SIZE, batch 1, bf16, seeded weights: finite decoded
    predictions and one (k, 6) detection array, launches as
    expected_launches."""
    from icafusion_tpu_torch.cli._common import resolve_model_config
    from icafusion_tpu_torch.serve.engine import ServingEngine
    specs = sorted(p.name for p in (REPO / "configs" / "models").glob(
        "*.yaml")) + ["zoo:dmaf:n"]
    assert len(specs) == 22, specs
    S = ALL_CONFIGS_SIZE
    rng = np.random.default_rng(11)
    pair = [rng.integers(0, 256, (1, S, S, 3), np.uint8) for _ in range(2)]
    for spec in specs:
        t = time.perf_counter()
        model = seeded_model(resolve_model_config(spec, nc=3))
        engine = ServingEngine(model, S, 1, conf_thres=0.001,
                               dtype="bfloat16")
        build_s = time.perf_counter() - t
        with torch.inference_mode():
            x, y = (torch.from_numpy(a).cuda().permute(0, 3, 1, 2).float()
                    .div(255).to(torch.bfloat16) for a in pair)
            pred = engine.model(x, y)
        assert bool(torch.isfinite(pred).all()), spec
        t = time.perf_counter()
        out, launches = counted(lambda: engine.predict_arrays(*pair))
        ms = 1e3 * (time.perf_counter() - t)
        assert launches == expected_launches(engine.model, 1), (spec,
                                                                 launches)
        assert len(out) == 1 and out[0].ndim == 2 and out[0].shape[1] == 6
        assert np.isfinite(out[0]).all(), spec
        n_params = sum(p.numel() for p in model.parameters())
        print(f"   {spec:34s} {n_params / 1e6:6.1f} M  pred "
              f"{tuple(pred.shape)}  {len(out[0]):3d} detections  request "
              f"{ms:6.1f} ms (host, first)  launches "
              f"{list(launches.values())}  built in {build_s:.1f} s")
        del model, engine, pred
        torch.cuda.empty_cache()


# Trainer steps of phase 10c: as many as rounding alone leaves the
# comparison well inside phase 6a's tolerances, as the one-ulp probe that
# 10c prints at these counts and at two and three steps shows (PERF.md,
# section 6). At three steps the CPU's own loss items move by about 1e-4
# for the nin kind and the narrow ResNet50, the loss tolerance itself; the
# VGG16 towers have no normalisation, and the narrow VGG16's training is
# chaotic from its second step (its state moves by 0.02, twenty times
# STATE_ATOL). Every count holds the first step's gradients.
FAMILY_STEPS = {"tiny nin": 2, "tiny add": 2, "tiny dmaf": 2,
                "narrow vgg16": 1, "narrow resnet50": 2}


def train_families_card_vs_cpu():
    """Phase 10c: phase 6a's card-against-CPU Trainer check for the nin,
    add and dmaf zoo kinds and the narrow VGG16 and ResNet50 configs."""
    from icafusion_tpu_torch.models.zoo import tiny_icafusion_config
    for tag, cfg in [(f"tiny {k}", tiny_icafusion_config(fusion=k))
                     for k in ("nin", "add", "dmaf")] + [
            (f"narrow {k}", narrow_config(k)) for k in ("vgg16", "resnet50")]:
        print(f"   {tag}:")
        steps = FAMILY_STEPS[tag]
        train_card_vs_cpu(cfg, steps, ulp_probe=sorted({steps, 2, 3}))


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
# yolov5l-Transfusion at 640, the 512 x 640 canvas's P3 and two yolov5x
# widths (Cin up to 2560, Cout 1280)
INT8_SHAPES = ((3, 64, 6, 2, 640, 640),       # the stems (K = 108)
               (64, 128, 3, 2, 320, 320),     # P2 down-sample
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
INT8_MAP50_FIRST = {"s640": 0.96649, "n320": 0.97869}


def plan_text(pl) -> str:
    """The path a conv takes, and for the tma path its tile, groups,
    splits and shared memory."""
    if pl.path != "tma":
        return "direct"
    return (f"tma {pl.tile[0]}x{pl.tile[1]} G{pl.groups} S{pl.splits} "
            f"{pl.smem // 1024}K")


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
    """11a: the int8 conv against its plain version at INT8_SHAPES, at B =
    1, 4 and 32, in fp32 and bf16 (channels_last, and NCHW at B = 4), each
    bf16 case timed beside its bound, the plain version and the
    yardsticks."""
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
        # every int8 conv but the stem is served by the tma path from a
        # channels_last map
        assert Cin == 3 or (path == "tma" and layout == "NHWC"), (
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
          f"({ratio:.3f}x) and cuDNN bf16 conv + SiLU "
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
    results, launches = counted(
        lambda: [engine.predict_arrays(*p) for p in pairs], int8=True)
    want = {"dual_cross_attention": 3 * len(pairs), "greedy_nms": len(pairs),
            "conv3x3_bn_silu": 0, "conv_int8_bn_act": n_int8 * len(pairs)}
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
    """Phase 11; returns (the int8 conv's kernels-line entry, the launches
    of 11b's counted requests)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = phase("11a int8 conv vs plain (B = 1, 4, 32; fp32, bf16)")
    int8_kernel_slice(gen)
    done(t0)
    t0 = phase("11b int8 serving: yolov5l-Transfusion 640, b4, bf16")
    entry, launches = int8_serving_slice(card)
    done(t0)
    with tempfile.TemporaryDirectory() as tmp:
        int8_val_slice(Path(tmp), fp32_map50)
        t0 = phase("11d HTTP server --int8: s640 on 512 x 640")
        int8_http_slice(Path(tmp))
        done(t0)
    return entry, launches


if __name__ == "__main__":
    sys.exit(main())
