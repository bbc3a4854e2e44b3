"""chip_smoke.py's phases of the BatchNorm + activation epilogue
(kernels/bn_act.py) on the card: the kernel against its plain version
(3c), the shapes a served forward launches it at (4b), and at those
shapes (4e) the kernel against its plain version again and its time,
read from HBM, beside its bound, the plain version and the BatchNorm and
SiLU it replaces, with the host's cost a call."""

from __future__ import annotations

import collections
import itertools
import time

import torch
import torch.nn.functional as F

from icafusion_tpu_torch.kernels.bn_act import bn_act_, bn_act_reference_
from icafusion_tpu_torch.nn.layers import FoldedIdentity, FoldedSiLU
from icafusion_tpu_torch.smoke.common import (HBM_BYTES_PER_S, cuda_ms,
                                              device_ms, queued_ms)

EPILOGUES_PER_FORWARD = 159    # yolov5l: 165 Convs less the 6 fused
# (B, C, H, W): the vector modes in both layouts, an odd W and odd
# channel counts for the per-element mode and its scalar tail, a 1 x 1 map
CHECK_SHAPES = ((4, 128, 80, 80), (2, 64, 20, 21), (3, 5, 7, 9),
                (2, 3, 1, 1), (1, 1024, 20, 20))


def case(shape, dtype, layout, gen):
    """y ~ N(0, 2), scale ~ U(0.5, 1.5), bias ~ N(0, 0.3), on the card."""
    dev = torch.device("cuda")
    C = shape[1]
    y = (2 * torch.randn(shape, generator=gen)).to(dev, dtype).contiguous(
        memory_format=layout)
    scale = (0.5 + torch.rand(C, generator=gen)).to(dev)
    bias = (0.3 * torch.randn(C, generator=gen)).to(dev)
    return y, scale, bias


def assert_bf16_close(got, want, what) -> None:
    """bf16: within one bf16 ulp of the plain version, and 2e-6 absolute
    where y * scale and the bias cancel (check_slice)."""
    d = (got.float() - want.float()).abs()
    _, e = torch.frexp(want.float())
    ulp = torch.ldexp(torch.ones_like(d), e - 8)
    assert (d <= ulp + 2e-6).all(), (what, (d - ulp).max().item())


def check_slice(gen) -> float:
    """3c: the kernel in place against the plain version. The plain
    version rounds y * scale before it adds the bias, where the kernel's
    fmaf does not: where the two cancel, they differ by that rounding,
    half an fp32 ulp of y * scale (|y * scale| < 32 here: 2e-6 absolute).
    fp32: besides, expf against torch's silu, a few ulp (rtol 1e-5); bf16:
    besides, one bf16 ulp (both round fp32 values once). Returns the
    largest error of the bf16 channels_last cases, the serving path's."""
    worst = 0.0
    layouts = {"NHWC": torch.channels_last, "NCHW": torch.contiguous_format}
    for dtype, shape, (lname, layout), silu in itertools.product(
            (torch.float32, torch.bfloat16), CHECK_SHAPES, layouts.items(),
            (True, False)):
        y, s, b = case(shape, dtype, layout, gen)
        want = bn_act_reference_(y.clone(), s, b, silu)
        ptr, strides, n0 = y.data_ptr(), y.stride(), bn_act_.launches
        with torch.inference_mode():
            got = bn_act_(y, s, b, silu)
        torch.cuda.synchronize()
        assert got is y and y.data_ptr() == ptr and y.stride() == strides
        assert bn_act_.launches == n0 + 1
        d = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6)
            ulps = 0
        else:
            assert_bf16_close(got, want, (shape, lname, silu))
            ulps = int((d > 0).sum())
            if lname == "NHWC":
                worst = max(worst, d.max().item())
        print(f"   {str(dtype)[6:]:8s} {lname} {str(shape):18s} "
              f"{'silu' if silu else 'identity':8s}: max_abs_err "
              f"{d.max().item():.3g}"
              + (f", {ulps} of {d.numel()} one ulp apart" if ulps else ""))
    return worst


def forward_shapes(engine, pair) -> list:
    """(C, H, W) of every epilogue one served forward launches, in order
    (forward pre-hooks on the folded activations)."""
    shapes = []
    hook = lambda m, args: shapes.append(tuple(args[0].shape[1:]))
    handles = [m.register_forward_pre_hook(hook)
               for m in engine.model.modules()
               if isinstance(m, (FoldedSiLU, FoldedIdentity))]
    try:
        engine.predict_arrays(*pair)
    finally:
        for h in handles:
            h.remove()
    return shapes


def host_us(fn, n: int = 2000) -> float:
    """Host microseconds a call of fn() on a map small enough that the
    card keeps up: the launch work alone."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    us = 1e6 * (time.perf_counter() - t) / n
    torch.cuda.synchronize()
    return us


def hbm_copies(nbytes: int) -> int:
    """Copies of a map of ``nbytes`` to rotate through so that each call
    reads it from HBM: together four times the L2 cache, and at least 2."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 << 20)   # the H100's
    return max(2, -(-4 * l2 // nbytes))


def hbm_ms(fn, bound: float) -> float:
    """device_ms of fn(), which reads and writes every byte in HBM. A
    reading under ``bound`` lost kernels (torch.profiler now and then
    records part of a window), so it is taken again by queued_ms."""
    ms = device_ms(fn)
    if ms < bound:
        print(f"   (the profiler read {ms:.4f} ms, under the bound "
              f"{bound:.4f}: timed again by queued_ms)")
        ms = queued_ms(fn)
    return ms


def timing_slice(shapes, batch: int, gen, max_abs_err: float) -> dict:
    """4e: a served forward's epilogues at ``batch`` (bf16, channels_last),
    each unique shape first held to the plain version (3c's bf16 rule),
    then timed alone and weighted by its count: the kernel (device time,
    torch.profiler, and CUDA events), its bound (a read and a write of y
    at HBM rate), the plain version, and the BatchNorm and SiLU it
    replaced (F.batch_norm then F.silu, each a new tensor). Each call
    takes the next of ``hbm_copies`` copies of the map, so none is read
    from L2 (``hbm_ms``); the kernel's time on one map, warm in L2 where
    it fits, is printed beside. Then the host's cost a call beside
    F.silu's. Returns the kernel table's row, its ``max_abs_err`` the
    largest of 3c's and these shapes'."""
    counts = collections.Counter(shapes)
    tot = collections.Counter()
    for (C, H, W), k in sorted(counts.items()):
        y, s, b = case((batch, C, H, W), torch.bfloat16,
                       torch.channels_last, gen)
        want = bn_act_reference_(y.clone(), s, b)
        with torch.inference_mode():
            bn_act_(y, s, b)
        assert_bf16_close(y, want, (batch, C, H, W))
        max_abs_err = max(max_abs_err,
                          (y.float() - want.float()).abs().max().item())
        del want
        ys = [y] + [y.clone() for _ in range(hbm_copies(y.nbytes) - 1)]
        nxt = itertools.cycle(ys).__next__
        mean, var = torch.zeros_like(s), torch.ones_like(s)
        bound = 1e3 * 2 * y.nbytes / HBM_BYTES_PER_S
        with torch.inference_mode():
            ms = {
                "kernel": hbm_ms(lambda: bn_act_(nxt(), s, b), bound),
                "kernel_events": cuda_ms(lambda: bn_act_(nxt(), s, b)),
                "kernel_warm": device_ms(lambda: bn_act_(y, s, b)),
                "plain": hbm_ms(lambda: bn_act_reference_(nxt(), s, b),
                                bound),
                "library": hbm_ms(lambda: F.silu(F.batch_norm(
                    nxt(), mean, var, s, b, False, 0.0, 1e-3)), bound),
                "bound": bound,
            }
        for key, v in ms.items():
            tot[key] += k * v
        print(f"   ({batch}, {C}, {H}, {W}) x {k}, {len(ys)} copies: kernel "
              f"{ms['kernel']:.4f} ms ({100 * ms['bound'] / ms['kernel']:.1f}"
              f" % of bound {ms['bound']:.4f}), events "
              f"{ms['kernel_events']:.4f}, one map {ms['kernel_warm']:.4f}, "
              f"plain {ms['plain']:.4f}, batch_norm + silu "
              f"{ms['library']:.4f}")
        del y, ys
    print(f"   a forward's {sum(counts.values())} epilogues at batch {batch}: "
          f"kernel {tot['kernel']:.3f} ms ({100 * tot['bound'] / tot['kernel']:.1f}"
          f" % of bound {tot['bound']:.3f}), events {tot['kernel_events']:.3f}, "
          f"one map each {tot['kernel_warm']:.3f}, plain {tot['plain']:.3f}, "
          f"batch_norm + silu {tot['library']:.3f}; max_abs_err "
          f"{max_abs_err:.3g}")
    y, s, b = case((1, 64, 8, 8), torch.bfloat16, torch.channels_last, gen)
    mean, var = torch.zeros_like(s), torch.ones_like(s)
    silu_mod, folded = torch.nn.SiLU(), FoldedSiLU(s, b).eval()
    bn = torch.nn.BatchNorm2d(64, eps=1e-3).cuda().eval()
    with torch.inference_mode():
        host = {"bn_act_": host_us(lambda: bn_act_(y, s, b)),
                "F.silu": host_us(lambda: F.silu(y)),
                "F.batch_norm + F.silu": host_us(lambda: F.silu(F.batch_norm(
                    y, mean, var, s, b, False, 0.0, 1e-3))),
                "FoldedSiLU module": host_us(lambda: folded(y)),
                "SiLU module": host_us(lambda: silu_mod(y)),
                "BatchNorm2d + SiLU modules": host_us(
                    lambda: silu_mod(bn(y)))}
    print("   host us a call: " + ", ".join(f"{k} {v:.2f}"
                                           for k, v in host.items()))
    return {"ms": tot["kernel"], "plain_ms": tot["plain"],
            "bound_ms": tot["bound"], "library_ms": tot["library"],
            "max_abs_err": max_abs_err, "bound_by": {"bytes"}}
