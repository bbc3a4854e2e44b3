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

    python3 port_probes.py fp32 [--root DIR]

        Device time of the fp32 kernels on their channels_last and
        flagship paths, each call first held against its plain version at
        chip_smoke.py's fp32 gates: the dual cross-attention summed over
        the flagship's three shapes, split by launch (the projections, the
        core), and the 64-channel conv at (B, 64, 160, 160), at B = 1, 4
        and 32, by torch.profiler over 50 calls. The package comes from
        DIR, as for attention, so that one call can time the first
        designs of a parent checkout beside this one's.

    python3 port_probes.py conv-layouts [--root DIR] [--iters N]

        The 64-channel conv (conv3x3_bn_silu) in both dtypes and both
        layouts at every shape of smoke/common.CONV_SHAPES: each call held
        against the plain version at phase 3b's gates (output strides equal
        to the input's), then timed by torch.profiler over N calls (default
        50) by kernel name, beside one cuDNN call (BN-folded weights, bias,
        then SiLU) on the same input. Prints the -Xptxas -v lines of the
        conv kernels where this process built the library. The package
        comes from DIR, as for attention, so that one call can time a
        parent checkout's kernels beside this one's: parent, change,
        change, parent.

    python3 port_probes.py fp32-variants

        Where the fp32 kernels' time goes: copies of
        csrc/dual_cross_attention.cu and csrc/conv3x3_bn_silu.cu (and
        hopper.cuh) with one part cut out (FP32_VARIANTS: the two small
        products of every 3xTF32 product, the projections' split of W),
        each built beside build/ and launched through the wrappers at the
        flagship attention and the (B, 64, 160, 160) conv, B = 4 and 32,
        timed by torch.profiler. A cut copy gives wrong sums and is only
        timed.

    python3 port_probes.py conv-variants [--iters N]

        Which NCHW load path each dtype of the 64-channel conv wants, and
        where bf16 NCHW's time goes: copies of csrc/conv3x3_bn_silu.cu
        (and hopper.cuh) whose C entry takes any route (CONV_VARIANTS: as
        shipped; without bf16's halo fill, loads and stores; without bf16's
        NCHW stores, the epilogue's arithmetic kept; bf16 storing each
        pixel apart, 2 bytes, at every W), each built beside
        build/ and called through its C entry with the route forced, at
        the shapes of smoke/common.CONV_SHAPES whose rows are a multiple of
        16 bytes in bf16 (so both NCHW routes can run them), in both
        dtypes: nchw_tma and nchw_ld, and nhwc on the same values, every
        case of the copies that compute held against the plain version at
        phase 3b's gates, then timed by torch.profiler over N calls
        (default 50) in two passes, the second in reverse order, so that
        the two readings of a case give its spread. A cut copy gives wrong
        values and is only timed.

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

    python3 port_probes.py int8-small

        The int8 conv's "stem" and "grouped" paths against the first
        design's direct path (launched through kernels/conv_int8.py:
        _launch with a "direct" plan) on the same inputs: the stem
        (3 -> 64, k6 s2, 640 px), the merged stem (6 -> 128) and the
        depthwise 3x3 64 -> 64 at (B, 64, 160, 160) (groups 64), at B = 1,
        4 and 32 in bf16 and fp32, channels_last and NCHW; each path's
        int32 accumulators against the plain version, then its time
        (queued_ms) beside the bound and cuDNN's bf16 conv + SiLU.

    python3 port_probes.py int8-small-variants

        Where the "stem" and "grouped" kernels' time goes: copies of
        csrc/conv_int8_small.cu with one phase cut out or one setting
        changed (SMALL_VARIANTS), each built beside build/ and launched
        through the wrapper at int8-small's stem, merged stem and
        depthwise classes at B = 4, bf16, channels_last, timed by
        queued_ms; the shipped copy also with identity in place of SiLU
        and with the raw int32 sums (epilogue off). Variants that cut a
        phase give wrong sums and are only timed.

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

    python3 port_probes.py wrapper-cost [--root DIR]

        The host's cost of one eager call of each kernel wrapper
        (dual_cross_attention, conv3x3_bn_silu, conv_int8_bn_act,
        greedy_nms) under torch.inference_mode, at shapes whose kernels
        run in a few microseconds: 1000 calls queued back to back, timed
        by the host clock and by CUDA events around them (the card waits
        on the host there, so both give the host's time a call), the
        median of 5 such rounds. The
        package comes from DIR, as for attention, so that one call can
        compare a change with its parent.

    python3 port_probes.py export

        chip_smoke.py's phase 14 alone (export, Grad-CAM, the grouped int8
        path, an ensemble), after the kernels' build. Returns phase 14's
        launches and the grouped path's kernels-line entry.

    python3 port_probes.py merge

        chip_smoke.py's phase 15 alone (stream merging served, validated
        and trained, cli.train --evolve, profiling), after the kernels'
        build, on 48 synthetic 512 x 640 pairs as phase 6 writes them.
        Returns phase 15's launches on its merged runs.

Each prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import contextlib
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


def fp32_kernels(root: Path) -> dict:
    sys.path.insert(0, str(root))
    from icafusion_tpu_torch.smoke import common as cs
    from icafusion_tpu_torch.kernels.cross_attention import (
        dual_cross_attention, dual_cross_attention_reference)
    from icafusion_tpu_torch.kernels.packed_conv import (
        conv3x3_bn_silu, conv3x3_bn_silu_reference)
    assert Path(dual_cross_attention.__code__.co_filename).is_relative_to(
        root), dual_cross_attention.__code__.co_filename
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    out = {}
    for B in (1, 4, 32):
        split = {"projections": 0.0, "core": 0.0}
        for N, D in FLAGSHIP:
            args = cs.attention_case(B, N, D, torch.float32, gen)
            for g, w in zip(dual_cross_attention(*args, num_heads=8),
                            dual_cross_attention_reference(*args,
                                                           num_heads=8)):
                torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-5)
            by = cs.device_times(
                lambda: dual_cross_attention(*args, num_heads=8), iters=50,
                warmup=5)
            for k, v in by.items():
                split["projections" if "projections" in k else "core"] += v
            del args
        x, w, sc, bi = cs.conv_case((B, 64, 160, 160), torch.float32,
                                    torch.channels_last, gen)
        torch.testing.assert_close(conv3x3_bn_silu(x, w, sc, bi),
                                   conv3x3_bn_silu_reference(x, w, sc, bi),
                                   rtol=1e-4, atol=1e-4)
        conv = cs.device_times(lambda: conv3x3_bn_silu(x, w, sc, bi),
                               iters=50, warmup=5)
        out[f"B={B}"] = {"attention": {k: round(v, 5)
                                       for k, v in split.items()},
                         "conv": {k[:60]: round(v, 5)
                                  for k, v in conv.items()}}
        print(f"   fp32 B={B}: {out[f'B={B}']} ({cs.timing_source()})",
              flush=True)
        del x
        torch.cuda.empty_cache()
    return out


def _kernel_name(key: str) -> str:
    """A profiler key's kernel name without its namespaces and arguments."""
    import re
    m = re.search(r"\w+_kernel\b", key)
    return m.group(0) if m else key[:40]


def conv_layouts(root: Path, iters: int) -> dict:
    sys.path.insert(0, str(root))
    from icafusion_tpu_torch.smoke import common as cs
    from icafusion_tpu_torch.kernels import _build, packed_conv
    assert Path(packed_conv.__file__).is_relative_to(root), packed_conv.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b = _build.build()
    print(f"   {b.path.name}: nvcc {b.seconds:.1f} s")
    conv = False
    for line in b.log.splitlines():
        if "Compiling entry" in line:
            conv = "conv3x3" in line
        if conv and any(k in line for k in ("Compiling entry", "registers",
                                            "spill", "smem")):
            print(f"   {line.strip()}")
    route = getattr(packed_conv, "route", None)   # absent before the routes
    gen = torch.Generator().manual_seed(0)
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in cs.CONV_SHAPES:
            for lname, layout in (("NHWC", torch.channels_last),
                                  ("NCHW", torch.contiguous_format)):
                x, w, sc, bi = cs.conv_case(shape, dtype, layout, gen)
                fn = lambda: packed_conv.conv3x3_bn_silu(x, w, sc, bi)
                got = fn()
                ref = packed_conv.conv3x3_bn_silu_reference(x, w, sc, bi)
                torch.cuda.synchronize()
                assert got.stride() == x.stride(), (got.stride(), x.stride())
                err = float((got.float() - ref.float()).abs().max())
                torch.testing.assert_close(got.float(), ref.float(),
                                           rtol=tol[dtype], atol=tol[dtype])
                by = cs.device_times(fn, iters=iters, warmup=5)
                w_f = (w.float() * sc[:, None, None, None]).to(dtype)
                lib = cs.device_ms(lambda: cs.conv_library(x, w_f,
                                                           bi.to(dtype)),
                                   iters=iters, warmup=5)
                key = f"{str(dtype)[6:]} {lname} {shape}"
                out[key] = {
                    "route": route(x) if route else None,
                    "max_abs_err": err, "ms": sum(by.values()),
                    "cudnn_ms": lib,
                    "kernels": {_kernel_name(k): round(v, 5)
                                for k, v in by.items()}}
                print(f"   {key:36s} {out[key]}", flush=True)
                del x, got, ref
        torch.cuda.empty_cache()
    return out


# fp32-variants: name -> replacements (old, new) of every occurrence in
# the fp32 kernels' sources
FP32_VARIANTS = {
    "shipped": (),
    "big products only (1xTF32)": (
        ("  mma_tf32_1688(d, as, bb0, bb1);\n  mma_tf32_1688(d, ab, bs0, bs1);\n",
         ""),
        ("      wgmma_m64n128k8_tf32_rs(acc, as[kk], desc_sw128(wb + kk * 32), "
         "kk != 0);\n      wgmma_m64n128k8_tf32_rs(acc, ab[kk], "
         "desc_sw128(wsm + kk * 32), 1);\n      wgmma_m64n128k8_tf32_rs(acc, "
         "ab[kk], desc_sw128(wb + kk * 32), 1);",
         "      wgmma_m64n128k8_tf32_rs(acc, ab[kk], desc_sw128(wb + kk * 32), "
         "kk != 0);"),
        ("        wgmma_m64n32k8_tf32_rs(acc[set][0], as[u & 1][st], "
         "desc_sw128(wb), sd);\n        wgmma_m64n32k8_tf32_rs(acc[set][1], "
         "ab[u & 1][st],\n                               desc_sw128(wb + "
         "kWBytes), sd);\n", "")),
    "projections: W not split": (
        ("    for (int q = 0; q < kTile / 16 / kThreads; ++q) {",
         "    for (int q = 0; q < 0; ++q) {"),),
}


def fp32_variants() -> dict:
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    from icafusion_tpu_torch.kernels import _build
    from icafusion_tpu_torch.kernels.cross_attention import (
        dual_cross_attention)
    from icafusion_tpu_torch.kernels.packed_conv import conv3x3_bn_silu
    from icafusion_tpu_torch.smoke import common as cs
    names = ("dual_cross_attention.cu", "conv3x3_bn_silu.cu", "hopper.cuh")
    texts = {n: (_build.CSRC / n).read_text() for n in names}
    work = _build.BUILD_DIR / "fp32_variants"

    def build(i_name):
        i, name = i_name
        d = work / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        out = dict(texts)
        for a, b in FP32_VARIANTS[name]:
            hits = [n for n in names if a in out[n]]
            assert hits, (name, a)
            for n in hits:
                out[n] = out[n].replace(a, b)
        for n, text in out.items():
            (d / n).write_text(text)
        so = d / "lib.so"
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                            "-o", str(so), str(d / names[0]),
                            str(d / names[1])], capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        lib = ctypes.CDLL(str(so))
        for entry in ("icaf_dual_cross_attention", "icaf_conv3x3_bn_silu"):
            fn = getattr(lib, entry)
            fn.argtypes = _build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
        lib.icaf_error_string.argtypes = (ctypes.c_int,)
        lib.icaf_error_string.restype = ctypes.c_char_p
        return name, lib

    with ThreadPoolExecutor(len(FP32_VARIANTS)) as pool:
        libs = list(pool.map(build, enumerate(FP32_VARIANTS)))
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    real, out = _build.library, {}
    try:
        for B in (4, 32):
            att = [cs.attention_case(B, N, D, torch.float32, gen)
                   for N, D in FLAGSHIP]
            conv = cs.conv_case((B, 64, 160, 160), torch.float32,
                                torch.channels_last, gen)
            for name, lib in libs:
                _build.library = lambda lib=lib: lib
                split = {"projections": 0.0, "core": 0.0}
                for args in att:
                    by = cs.device_times(
                        lambda: dual_cross_attention(*args, num_heads=8),
                        iters=50, warmup=5)
                    for k, v in by.items():
                        split["projections" if "projections" in k
                              else "core"] += v
                row = {**split, "conv": cs.device_ms(
                    lambda: conv3x3_bn_silu(*conv), iters=50, warmup=5)}
                out[f"B={B} {name}"] = {k: round(v, 5)
                                        for k, v in row.items()}
                print(f"   B={B} {name}: {out[f'B={B} {name}']} ms",
                      flush=True)
            del att, conv
            torch.cuda.empty_cache()
    finally:
        _build.library = real
    return out


# conv-variants: name -> replacements (old, new) of every occurrence in
# csrc/conv3x3_bn_silu.cu; every copy's C entry takes any route
ANY_ROUTE = ("  if (route != route_of(W, is_bf16, nhwc)) "
             "return cudaErrorInvalidValue;\n", "")
CONV_VARIANTS = {
    "shipped": (ANY_ROUTE,),
    "bf16: no halo fill": (
        ANY_ROUTE,
        ("      *reinterpret_cast<uint4*>(halo + p * 128 + ((c ^ (p & 7)) "
         "<< 4)) =\n          make_uint4(v[k][0], v[k][1], v[k][2], "
         "v[k][3]);", "      (void)p;")),
    "bf16: no NCHW stores": (
        ANY_ROUTE,
        ("          if (h >= g.H) continue;",
         "          if (h >= g.H || lo != -12345.f) continue;")),
    "bf16 nchw_ld: two 2-byte stores at any W": (
        ANY_ROUTE,
        ("          if (R == kNchwTma || (g.W & 1) == 0) {",
         "          if constexpr (R == kNchwTma) {")),
}
CONV_ROUTES = ("nhwc", "nchw_tma", "nchw_ld")   # the C entry's Route


def conv_variants(iters: int) -> dict:
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    from icafusion_tpu_torch.kernels import _build
    from icafusion_tpu_torch.kernels.packed_conv import (
        conv3x3_bn_silu_reference)
    from icafusion_tpu_torch.smoke import common as cs
    names = ("conv3x3_bn_silu.cu", "hopper.cuh")
    texts = {n: (_build.CSRC / n).read_text() for n in names}
    work = _build.BUILD_DIR / "conv_variants"

    def build(i_name):
        i, name = i_name
        d = work / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        text = texts[names[0]]
        for a, b in CONV_VARIANTS[name]:
            assert a in text, (name, a)
            text = text.replace(a, b)
        (d / names[0]).write_text(text)
        (d / names[1]).write_text(texts[names[1]])
        so = d / "lib.so"
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                            "-o", str(so), str(d / names[0])],
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        fn = ctypes.CDLL(str(so)).icaf_conv3x3_bn_silu
        fn.argtypes = _build.SIGNATURES["icaf_conv3x3_bn_silu"]
        fn.restype = ctypes.c_int
        return name, fn

    with ThreadPoolExecutor(len(CONV_VARIANTS)) as pool:
        entries = dict(pool.map(build, enumerate(CONV_VARIANTS)))
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    shapes = [s for s in cs.CONV_SHAPES if s[3] % 8 == 0 and s[2:] != (1, 1)]
    cases = []   # (key, entry, (x, w, scale, bias), route, checked)
    for dtype in (torch.bfloat16, torch.float32):
        for shape in shapes:
            nchw = cs.conv_case(shape, dtype, torch.contiguous_format, gen)
            nhwc = (nchw[0].contiguous(memory_format=torch.channels_last),
                    *nchw[1:])
            for name, entry in entries.items():
                if dtype == torch.float32 and name != "shipped":
                    continue
                routes = CONV_ROUTES if name == "shipped" else CONV_ROUTES[1:]
                if name.startswith("bf16 nchw_ld"):
                    routes = ("nchw_ld",)
                for r in routes:
                    cases.append((f"{str(dtype)[6:]} {shape} {r} [{name}]",
                                  entry, nhwc if r == "nhwc" else nchw, r,
                                  "no " not in name))

    def call(entry, args, r):
        x, w, scale, bias = args
        out = torch.empty_like(x)
        B, _, H, W = x.shape
        err = entry(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), B, H, W,
                    int(x.dtype == torch.bfloat16), int(r == "nhwc"),
                    CONV_ROUTES.index(r), _build.stream_handle(x.device))
        assert err == 0, err
        return out

    out = {}
    for key, entry, args, r, checked in cases:
        got = call(entry, args, r)
        torch.cuda.synchronize()
        assert got.stride() == args[0].stride(), key
        if checked:
            ref = conv3x3_bn_silu_reference(*args)
            t = tol[args[0].dtype]
            torch.testing.assert_close(got.float(), ref.float(), rtol=t,
                                       atol=t)
        out[key] = {"max_abs_err": float((got.float() - ref.float()).abs()
                                         .max()) if checked else None,
                    "ms": []}
    for order in (cases, cases[::-1]):
        for key, entry, args, r, _ in order:
            out[key]["ms"].append(round(cs.device_ms(
                lambda: call(entry, args, r), iters=iters, warmup=5), 5))
    for key, row in out.items():
        print(f"   {key:64s} {row}", flush=True)
    # the 2-byte stores' copy at every NCHW width
    entry = entries["bf16 nchw_ld: two 2-byte stores at any W"]
    for shape in cs.CONV_SHAPES:
        args = cs.conv_case(shape, torch.bfloat16, torch.contiguous_format,
                            gen)
        torch.testing.assert_close(
            call(entry, args, "nchw_ld").float(),
            conv3x3_bn_silu_reference(*args).float(), rtol=1e-2, atol=1e-2)
    print("   2-byte stores: every NCHW shape within 1e-2", flush=True)
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
        # from the caller's model: the engine's own has its BatchNorms
        # folded into float32 (scale, bias)
        m64 = copy.deepcopy(engines["cpu"]._float_model).double()
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
            if shape[0] % 16 == 0:          # the stems take the stem path
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


# int8-small: (name, (Cin, Cout, k, s, H, W), groups)
SMALL_CLASSES = (("stem", (3, 64, 6, 2, 640, 640), 1),
                 ("merged stem", (6, 128, 6, 2, 640, 640), 1),
                 ("depthwise", (64, 64, 3, 1, 160, 160), 64))


def int8_small() -> dict:
    import torch.nn.functional as F
    from icafusion_tpu_torch.kernels import conv_int8 as ci
    from icafusion_tpu_torch.smoke import int8 as cs
    from icafusion_tpu_torch.smoke.common import bound
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, shape, g in SMALL_CLASSES:
        Cin, Cout, k, s, H, W = shape
        for B in (1, 4, 32):
            for dtype in (torch.bfloat16, torch.float32):
                for layout in (torch.channels_last, torch.contiguous_format):
                    x, w8, s_in, s_w, bn, st, p = cs.int8_case(
                        B, shape, dtype, gen, layout)
                    if g > 1:
                        w8 = w8[..., :Cin // g].contiguous()
                        s_in = s_in.max().reshape(()).expand(Cin).contiguous()
                    args = (x, w8, s_in, s_w, bn, st, p)
                    pl = ci.plan_for(x, w8, st, p, g)
                    direct = ci.Plan("direct", "the first design")
                    ref = ci.conv_int8_bn_act_reference(*args, epilogue=False,
                                                        groups=g)
                    for plan_ in (pl, direct):
                        got = ci._launch(*args, True, False, plan_, g)
                        assert torch.equal(got, ref), (name, B, plan_.path)
                    ms = {pl_.path: cs.queued_ms(
                        lambda: ci._launch(*args, True, True, pl_, g),
                        iters=10, warmup=2) for pl_ in (pl, direct)}
                    mult, add = ci.fold_epilogue(s_w, bn)
                    wf = (w8.permute(0, 3, 1, 2).float()
                          * mult[:, None, None, None]).bfloat16()
                    xb, b = x.bfloat16(), add.bfloat16()
                    lib = cs.queued_ms(lambda: F.silu(F.conv2d(
                        xb, wf, b, st, p, groups=g)), iters=10, warmup=2)
                    if g == 1:
                        bnd, by = cs.int8_bound(B, shape, dtype)
                    else:
                        Ho, Wo = cs.conv_out_hw(H, W, k, s)
                        sz = torch.finfo(dtype).bits // 8
                        bnd, by = bound(
                            2 * B * Ho * Wo * Cout * k * k * Cin // g,
                            B * (Cin * H * W + Cout * Ho * Wo) * sz
                            + Cout * k * k * Cin // g + 4 * (6 * Cout + 1),
                            torch.int8)
                    lay = ("NHWC" if layout == torch.channels_last
                           else "NCHW")
                    key = f"{name} B={B} {str(dtype)[6:]} {lay}"
                    print(f"   {key}: {pl.path} {pl.tile} {ms[pl.path]:.4f} "
                          f"ms, direct {ms['direct']:.4f} ms, cuDNN bf16 "
                          f"{lib:.4f} ms, bound {bnd:.5f} ({by}); "
                          "accumulators equal", flush=True)
                    out[key] = {"path": pl.path, "ms": ms[pl.path],
                                "direct_ms": ms["direct"], "cudnn_ms": lib,
                                "bound_ms": bnd}
                    del x, args, ref
            torch.cuda.empty_cache()
    return out


# int8-small-variants: name -> (replacements (old, new) of every occurrence
# in conv_int8_small.cu and its headers, kernels/conv_int8.py constants
# the plans of that copy need)
_FAST_SILU = (("  if (act) y = __fdiv_rn(y, __fadd_rn(1.f, expf(-y)));",
               "  if (act) y = __fdividef(y, 1.f + __expf(-y));"),)
SMALL_VARIANTS = {
    "shipped": ((), {}),
    "stem: no products": ((
        ("      for (int ks = 0; ks < p.steps; ++ks) {",
         "      for (int ks = 0; ks < 0; ++ks) {"),), {}),
    "stem: k-steps unrolled 1": ((
        ("#pragma unroll 2\n      for (int ks",
         "#pragma unroll 1\n      for (int ks"),), {}),
    "stem: no window loads": ((
        ("  fetch(blockIdx.x);\n", ""),
        ("    if (tile + static_cast<int>(gridDim.x) < p.tiles)\n      "
         "fetch(tile + gridDim.x);\n", "")), {}),
    "stem: no stores": ((
        ("      copy_out<kStemThreads>(p, tl, stage, n0, min(kNC, p.Cout - n0), "
         "esz);\n", ""),), {}),
    "stem: 4 blocks an SM of 4 warps, 64-pixel tiles": ((
        ("constexpr int kStemThreads = 256;", "constexpr int kStemThreads = 128;"),
        ("constexpr int kStemBlocks = 2;", "constexpr int kStemBlocks = 4;"),
        ("constexpr int kSlots = 128;", "constexpr int kSlots = 64;")),
        {"STEM_THREADS": 128, "STEM_BLOCKS": 4, "STEM_SLOTS": 64}),
    "stem: phases stamped": ((
        ("using namespace icaf_int8;\n",
         "using namespace icaf_int8;\n__device__ unsigned long long "
         "g_ph[1 << 14];\n__device__ __forceinline__ unsigned long long "
         "now() { unsigned long long t; asm volatile(\"mov.u64 %0, "
         "%%globaltimer;\" : \"=l\"(t)); return t; }\n"),
        ("  fetch(blockIdx.x);\n  for (int tile = blockIdx.x;",
         "  fetch(blockIdx.x);\n  unsigned long long ph[6] = {}, t_ = now(), "
         "u_;\n  for (int tile = blockIdx.x;"),
        ("    stash();\n    __syncthreads();   // the window is in; the stage "
         "is free\n",
         "    stash();\n    u_ = now(); ph[0] += u_ - t_; t_ = u_;\n"
         "    __syncthreads();\n    u_ = now(); ph[1] += u_ - t_; t_ = u_;\n"),
        ("      // rows i0 (acc[jn][0, 1]) and i0 + 8",
         "      u_ = now(); ph[2] += u_ - t_; t_ = u_;\n"
         "      // rows i0 (acc[jn][0, 1]) and i0 + 8"),
        ("      __syncthreads();   // the stage is full; the window is free\n",
         "      u_ = now(); ph[3] += u_ - t_; t_ = u_;\n      __syncthreads();\n"
         "      u_ = now(); ph[4] += u_ - t_; t_ = u_;\n"),
        ("esz);\n      if (n0 + kNC < p.Cout) __syncthreads();\n    }\n  }\n}",
         "esz);\n      u_ = now(); ph[5] += u_ - t_; t_ = u_;\n"
         "      if (n0 + kNC < p.Cout) __syncthreads();\n    }\n  }\n"
         "  if (tid == 0) for (int i = 0; i < 6; ++i) g_ph[blockIdx.x * 6 + i]"
         " = ph[i];\n}"),
        ("             : launch_grouped<float>(p, static_cast<int>(grid), "
         "smem, st);\n}\n",
         "             : launch_grouped<float>(p, static_cast<int>(grid), "
         "smem, st);\n}\nextern \"C\" int icaf_stem_phases(void* h, int n) "
         "{ return cudaMemcpyFromSymbol(h, g_ph, n * 8); }\n")), {}),
    "fast SiLU": (_FAST_SILU, {}),
    "grouped: no products": ((
        ("      for (int ky = 0; ky < p.kh; ++ky) {\n        const int8_t* xr",
         "      for (int ky = 0; ky < 0; ++ky) {\n        const int8_t* xr"),),
        {}),
    "grouped: no window": ((
        ("      while (wr < p.hh) {", "      while (wr < 0) {"),), {}),
    "grouped: no stores": ((
        ("  copy_out<kThreads>(p, tl, stage, co_lo, cout, esz);\n}", "}"),),
        {}),
    "grouped: 2 blocks an SM": ((
        ("__launch_bounds__(kThreads, kKW <= 3 ? 4 : 2)\n",
         "__launch_bounds__(kThreads, 2)\n"),), {}),
}


@contextlib.contextmanager
def _plan_constants(ci, values: dict):
    """kernels/conv_int8.py's module constants set to ``values`` (and
    plan's cache cleared) inside the block."""
    old = {k: getattr(ci, k) for k in values}
    ci.plan.cache_clear()
    for k, v in values.items():
        setattr(ci, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(ci, k, v)
        ci.plan.cache_clear()


def int8_small_variants() -> dict:
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    from icafusion_tpu_torch.kernels import _build
    from icafusion_tpu_torch.kernels import conv_int8 as ci
    from icafusion_tpu_torch.smoke import int8 as cs
    names = ("conv_int8_small.cu", *_build.HEADERS)
    texts = {n: (_build.CSRC / n).read_text() for n in names}
    work = _build.BUILD_DIR / "int8_small_variants"

    def build(i_name):
        i, name = i_name
        d = work / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        out = dict(texts)
        for a, b in SMALL_VARIANTS[name][0]:
            hits = [n for n in names if a in out[n]]
            assert hits, (name, a)
            for n in hits:
                out[n] = out[n].replace(a, b)
        for n, text in out.items():
            (d / n).write_text(text)
        so = d / "lib.so"
        r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                            "-o", str(so), str(d / names[0])],
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        spills = sorted({ln.strip() for ln in r.stderr.splitlines()
                         if "spill" in ln and not ln.strip().startswith("0 ")})
        lib = ctypes.CDLL(str(so))
        for entry in ("icaf_conv_int8_stem", "icaf_conv_int8_grouped"):
            fn = getattr(lib, entry)
            fn.argtypes = _build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
        return name, lib, spills

    with ThreadPoolExecutor(len(SMALL_VARIANTS)) as pool:
        libs = list(pool.map(build, enumerate(SMALL_VARIANTS)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for name, shape, g in SMALL_CLASSES:
        Cin = shape[0]
        x, w8, s_in, s_w, bn, st, p = cs.int8_case(4, shape, torch.bfloat16,
                                                   gen)
        if g > 1:
            w8 = w8[..., :Cin // g].contiguous()
            s_in = s_in.max().reshape(()).expand(Cin).contiguous()
        cases.append((name, (x, w8, s_in, s_w, bn, st, p), g))
    real, out = _build.library, {}
    try:
        for name, lib, spills in libs:
            _build.library = lambda lib=lib: lib
            row = {}
            for cname, args, g in cases:
                kind = name.split(":")[0]      # a variant of one kernel
                if (kind, g > 1) in (("stem", True), ("grouped", False)):
                    continue
                with _plan_constants(ci, SMALL_VARIANTS[name][1]):
                    pl = ci.plan_for(*args[:2], args[5], args[6], g)
                runs = {"": (True, True)}
                if name == "shipped":
                    runs.update({" identity": (False, True),
                                 " int32": (True, False)})
                for tag, (act, epi) in runs.items():
                    row[cname + tag] = cs.queued_ms(
                        lambda: ci._launch(*args, act, epi, pl, g),
                        iters=20, warmup=3)
                if "no " not in name:      # a whole kernel: its sums
                    y = ci._launch(*args, True, False, pl, g)
                    row[cname + " exact"] = bool(torch.equal(
                        y, ci.conv_int8_bn_act_reference(
                            *args, epilogue=False, groups=g)))
            if name == "stem: phases stamped":
                for cname, args, g in cases:
                    if g > 1:
                        continue
                    pl = ci.plan_for(*args[:2], args[5], args[6], g)
                    ci._launch(*args, True, True, pl, g)
                    torch.cuda.synchronize()
                    t = np.zeros(pl.grid * 6, np.uint64)
                    lib.icaf_stem_phases.argtypes = (ctypes.c_void_p,
                                                     ctypes.c_int)
                    lib.icaf_stem_phases(t.ctypes.data, pl.grid * 6)
                    t = t.reshape(-1, 6).astype(np.float64).sum(0) / pl.tiles
                    row[cname + " us a tile (quantize, wait, products, "
                        "epilogue, wait, stores)"] = [round(v / 1e3, 3)
                                                      for v in t]
            print(f"   {name}: " + ", ".join(
                f"{k} {v}" if isinstance(v, (bool, list))
                else f"{k} {v:.4f} ms"
                for k, v in row.items())
                  + (f"; spills {spills}" if spills else ""), flush=True)
            out[name] = row
    finally:
        _build.library = real
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


def wrapper_cost(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import time
    from icafusion_tpu_torch.kernels import _build
    from icafusion_tpu_torch.kernels.conv_int8 import conv_int8_bn_act
    from icafusion_tpu_torch.kernels.cross_attention import (
        dual_cross_attention)
    from icafusion_tpu_torch.kernels.nms import greedy_nms
    from icafusion_tpu_torch.kernels.packed_conv import conv3x3_bn_silu
    from icafusion_tpu_torch.smoke import common as cs
    from icafusion_tpu_torch.smoke import int8 as si
    assert Path(dual_cross_attention.__code__.co_filename).is_relative_to(
        root), dual_cross_attention.__code__.co_filename
    _build.library()
    gen = torch.Generator().manual_seed(0)
    cgen = torch.Generator(device="cuda").manual_seed(0)
    att = cs.attention_case(1, 16, 64, torch.bfloat16, gen)
    conv = cs.conv_case((1, 64, 8, 8), torch.bfloat16, torch.channels_last,
                        gen)
    q = si.int8_case(1, (64, 64, 1, 1, 8, 8), torch.bfloat16, cgen)
    boxes, scores = cs.nms_case(1, 64, gen)
    calls = {
        "dual_cross_attention": lambda: dual_cross_attention(*att,
                                                             num_heads=8),
        "conv3x3_bn_silu": lambda: conv3x3_bn_silu(*conv),
        "conv_int8_bn_act": lambda: conv_int8_bn_act(*q),
        "greedy_nms": lambda: greedy_nms(boxes, scores, 0.45, 10)}
    out = {}
    with torch.inference_mode():
        for name, fn in calls.items():
            for _ in range(50):
                fn()
            host, events = [], []
            for _ in range(5):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t = time.perf_counter()
                for _ in range(1000):
                    fn()
                host.append(1e3 * (time.perf_counter() - t))
                end.record()
                torch.cuda.synchronize()
                events.append(start.elapsed_time(end))
            out[name] = {"host_us": round(float(np.median(host)), 3),
                         "events_us": round(float(np.median(events)), 3),
                         "events_us_min": round(min(events), 3)}
            print(f"   {name}: {out[name]['host_us']:.3f} us a call (host "
                  f"clock), {out[name]['events_us']:.3f} us (CUDA events; "
                  f"least {out[name]['events_us_min']:.3f}), median of 5 x "
                  "1000 calls", flush=True)
    return out


def export_phase(card: str) -> dict:
    import tempfile

    from icafusion_tpu_torch.kernels import _build
    from icafusion_tpu_torch.smoke.export import export_slice
    torch.backends.cuda.matmul.allow_tf32 = False    # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    with tempfile.TemporaryDirectory() as tmp:
        entry, total = export_slice(card, Path(tmp))
    entry["bound_by"] = sorted(entry["bound_by"])
    return {"grouped": entry, "launches": total}


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


def merge(card: str) -> dict:
    import tempfile

    from icafusion_tpu_torch.data.synthetic import make_dataset
    from icafusion_tpu_torch.kernels import _build
    from icafusion_tpu_torch.smoke.merge import merge_slice
    torch.backends.cuda.matmul.allow_tf32 = False    # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    with tempfile.TemporaryDirectory() as tmp:
        data = make_dataset(Path(tmp) / "data", 48,
                            np.random.default_rng(0), hw=(512, 640))
        (Path(tmp) / "15").mkdir()
        return merge_slice(card, data, Path(tmp) / "15")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("attention")
    a.add_argument("--root", type=Path, default=HERE)
    f = sub.add_parser("fp32")
    f.add_argument("--root", type=Path, default=HERE)
    c = sub.add_parser("conv-layouts")
    c.add_argument("--root", type=Path, default=HERE)
    c.add_argument("--iters", type=int, default=50)
    sub.add_parser("fp32-variants")
    v = sub.add_parser("conv-variants")
    v.add_argument("--iters", type=int, default=50)
    sub.add_parser("fp64")
    sub.add_parser("int8-splits")
    sub.add_parser("int8-phases")
    sub.add_parser("int8-forward")
    sub.add_parser("int8-small")
    sub.add_parser("int8-small-variants")
    sub.add_parser("dist-faults")
    sub.add_parser("reference")
    w = sub.add_parser("wrapper-cost")
    w.add_argument("--root", type=Path, default=HERE)
    sub.add_parser("export")
    sub.add_parser("merge")
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
    elif args.cmd == "fp32":
        res = {"root": str(args.root.resolve()),
               "fp32": fp32_kernels(args.root.resolve())}
    elif args.cmd == "conv-layouts":
        res = {"root": str(args.root.resolve()),
               "conv_layouts": conv_layouts(args.root.resolve(), args.iters)}
    elif args.cmd == "fp32-variants":
        res = {"fp32_variants": fp32_variants()}
    elif args.cmd == "conv-variants":
        res = {"conv_variants": conv_variants(args.iters)}
    elif args.cmd == "int8-splits":
        res = {"int8_splits": int8_splits()}
    elif args.cmd == "int8-phases":
        res = {"int8_phases": int8_phases()}
    elif args.cmd == "int8-small-variants":
        res = {"int8_small_variants": int8_small_variants()}
    elif args.cmd == "int8-small":
        res = {"int8_small": int8_small()}
    elif args.cmd == "int8-forward":
        res = {"int8_forward": int8_forward(card)}
    elif args.cmd == "dist-faults":
        res = {"dist_faults": dist_faults()}
    elif args.cmd == "reference":
        res = {"reference": reference(card)}
    elif args.cmd == "wrapper-cost":
        res = {"root": str(args.root.resolve()),
               "wrapper_cost": wrapper_cost(args.root.resolve())}
    elif args.cmd == "export":
        res = {"export": export_phase(card)}
    elif args.cmd == "merge":
        res = {"merge": merge(card)}
    else:
        res = {"fp64": fp64(FP64_CFG, FP64_SIZE, FP64_SCALES)}
    res["card"] = card
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
