"""What the phases of chip_smoke.py share: the card's rates and the
phases' shapes, timing (CUDA events, torch.profiler's device time, calls
queued behind a sleep), the work bounds, the kernel cases and their library
yardsticks, launch counting, and the trained s640 checkpoint with its
extval pairs."""

from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
# The fp32 kernels multiply on tf32 tensor cores with the 3xTF32 split
# (three tf32 products a product, fp32 accuracy): their operations bound is
# at a third of the dense tf32 rate, beside FFMA's 67 TFLOP/s.
TF32X3 = "3xtf32"
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,   # dense
              torch.int8: 1979e12, TF32X3: 495e12 / 3}
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
# The NCHW conv's first designs (a weight pre-pass, then WMMA in bf16 and
# CUDA-core FFMA in fp32), since replaced by the nchw routes: device ms by
# torch.profiler at CONV_SHAPES in chip_smoke.py's last run of them on an
# NVIDIA H100 80GB HBM3 at 700 W, printed beside the NCHW routes in phase
# 3b. (1, 64, 1, 1) is dense in both layouts and never took them.
FIRST_DESIGN_NCHW_MS = {
    (torch.float32, (4, 64, 160, 160)): 0.3353,
    (torch.float32, (1, 64, 160, 160)): 0.0859,
    (torch.float32, (32, 64, 160, 160)): 1.9404,
    (torch.float32, (16, 64, 128, 160)): 0.8030,
    (torch.float32, (1, 64, 20, 20)): 0.0712,
    (torch.float32, (2, 64, 10, 13)): 0.0637,
    (torch.float32, (1, 64, 7, 5)): 0.0605,
    (torch.float32, (3, 64, 161, 33)): 0.0764,
    (torch.float32, (1, 64, 8, 16)): 0.0635,
    (torch.float32, (2, 64, 68, 84)): 0.0763,
    (torch.float32, (2, 64, 56, 56)): 0.0753,
    (torch.bfloat16, (4, 64, 160, 160)): 0.0994,
    (torch.bfloat16, (1, 64, 160, 160)): 0.0369,
    (torch.bfloat16, (32, 64, 160, 160)): 0.5980,
    (torch.bfloat16, (16, 64, 128, 160)): 0.2425,
    (torch.bfloat16, (1, 64, 20, 20)): 0.0355,
    (torch.bfloat16, (2, 64, 10, 13)): 0.0336,
    (torch.bfloat16, (1, 64, 7, 5)): 0.0318,
    (torch.bfloat16, (3, 64, 161, 33)): 0.0369,
    (torch.bfloat16, (1, 64, 8, 16)): 0.0320,
    (torch.bfloat16, (2, 64, 68, 84)): 0.0365,
    (torch.bfloat16, (2, 64, 56, 56)): 0.0365}
# the conv's launches on its NCHW routes: the key counted() adds with nchw
NCHW_KEY = "conv3x3_bn_silu (nchw)"

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


def bound(flops: float, nbytes: float, dtype, peak=None):
    """(least ms, what bounds it): operations at the dense peak of dtype
    (or of `peak`, a PEAK_FLOPS key), or bytes (each input read once, each
    output written once) at HBM rate."""
    t_ops = 1e3 * flops / PEAK_FLOPS[dtype if peak is None else peak]
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bound(B: int, N: int, D: int, dtype, peak=None):
    s = torch.finfo(dtype).bits // 8
    flops = 12 * B * N * D * D + 8 * B * N * N * D
    nbytes = 4 * B * N * D * s + 6 * D * D * s + 6 * D * 4
    return bound(flops, nbytes, dtype, peak)


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


def conv_bound(shape, dtype, peak=None):
    B, C, H, W = shape
    s = torch.finfo(dtype).bits // 8
    return bound(2 * B * H * W * C * C * 9,
                 2 * B * C * H * W * s + C * C * 9 * s + 2 * C * 4, dtype,
                 peak)


def bounds_text(fn, *args, dtype) -> str:
    """fn's bound as printed beside a time: in fp32 at 3xTF32 and at FFMA
    (a tensor-core kernel may run below the FFMA bound)."""
    if dtype != torch.float32:
        return "bound {:.5f} ms ({})".format(*fn(*args, dtype))
    return ("bound {:.5f} ms ({}) at 3xTF32, {:.5f} ms ({}) at FFMA".format(
        *fn(*args, dtype, TF32X3), *fn(*args, dtype)))


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
                                       "projections_tf32_kernel",
                                       "attention_tf32_kernel"),
              "greedy_nms": ("nms_mask_kernel", "nms_scan_kernel"),
              "conv3x3_bn_silu": ("conv3x3_bf16_", "conv3x3_tf32_"),
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


# the int8 conv's launches by path: the keys counted() adds with int8
INT8_PATH_KEYS = {"stem_launches": "conv_int8_bn_act (stem)",
                  "grouped_launches": "conv_int8_bn_act (grouped)"}


def counted(fn, int8: bool = False, nchw: bool = False):
    """fn() with every wrapper's launch count set to 0 just before it; (its
    result, the launches it made): the three TPU kernels' wrappers, and
    with int8 the int8 conv's too, with its launches on the "stem" and
    "grouped" paths under INT8_PATH_KEYS' names; with nchw the fused conv's
    launches on its NCHW routes under NCHW_KEY."""
    from icafusion_tpu_torch.kernels.conv_int8 import conv_int8_bn_act
    from icafusion_tpu_torch.kernels.cross_attention import dual_cross_attention
    from icafusion_tpu_torch.kernels.nms import greedy_nms
    from icafusion_tpu_torch.kernels.packed_conv import conv3x3_bn_silu
    wrappers = (dual_cross_attention, greedy_nms, conv3x3_bn_silu) + (
        (conv_int8_bn_act,) if int8 else ())
    for w in wrappers:
        w.launches = 0
    if int8:
        for attr in INT8_PATH_KEYS:
            setattr(conv_int8_bn_act, attr, 0)
    conv3x3_bn_silu.nchw_launches = 0
    out = fn()
    launches = {w.__name__: w.launches for w in wrappers}
    if nchw:
        launches[NCHW_KEY] = conv3x3_bn_silu.nchw_launches
    if int8:
        launches.update({key: getattr(conv_int8_bn_act, attr)
                         for attr, key in INT8_PATH_KEYS.items()})
    return out, launches


S640 = REPO / "artifacts" / "trained_s640"
S640_CFG = "yolov5s_Transfusion.yaml"


RECT = (512, 640)


def extval_files():
    """(rgb paths, ir paths) of the 141 extval pairs, in cli.detect's order."""
    from icafusion_tpu_torch.data.datasets import discover_images
    ext = S640 / "extval"
    return (discover_images(str(ext / "visible" / "val")),
            discover_images(str(ext / "infrared" / "val")))


def read_rgb(path):
    import cv2
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
