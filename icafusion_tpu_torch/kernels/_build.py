"""Build and load the port's CUDA kernels.

One ``nvcc -c`` per source in ``csrc/``, all run in parallel, and one link
build one shared library with a plain ``extern "C"`` interface (no PyTorch
headers, so it builds in seconds), under ``build/`` at the repository root.
The library is named by a hash of the sources, headers and flags, so an
edited source is rebuilt at its first use and an unchanged one is loaded as
it is. ``ctypes`` binds it: every pointer and the stream pass as
``c_void_p``, and every entry returns ``cudaGetLastError()``, which
``check`` turns into an exception.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("dual_cross_attention.cu", "greedy_nms.cu", "conv3x3_bn_silu.cu",
           "conv_int8.cu", "conv_int8_small.cu", "bn_act_epilogue.cu")
HEADERS = ("hopper.cuh", "conv_int8.cuh")   # included by the sources: part of the hash
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# entry name -> argtypes (see each source's extern "C" block)
SIGNATURES = {
    # vis, ir, weights[6], biases[6], qkv scratch, out_vis, out_ir,
    # B, N, D, H, dkp (the scratch's row width), is_bf16, stream
    "icaf_dual_cross_attention": (_P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _P),
    # boxes, scores, mask scratch (B, K, nms.mask_words(K)) int64, keep, ok,
    # B, K, max_det, iou_thres, stream
    "icaf_greedy_nms": (_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P),
    # x, w, scale, bias, out, B, H, W, is_bf16, nhwc, route
    # (packed_conv.ROUTES' index), stream
    "icaf_conv3x3_bn_silu": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _P),
    # x, its strides (b, c, h, w), w8, s_in, s_w, gamma, beta, mean, var,
    # eps, out, B, Cin, H, W, Cout, kh, kw, stride_h, stride_w, pad_h,
    # pad_w, Ho, Wo, is_bf16, act, epilogue, groups, stream
    "icaf_conv_int8": (_P, _L, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P,
                       ctypes.c_float, _P, *(_I,) * 17, _P),
    # the same up to out, then the split-K scratch ws and counters (null
    # without a split), the first 16 ints of icaf_conv_int8, and the plan: th,
    # tw, groups, splits, slice_units, chunks, b_stages and its layout
    # (copy_bytes, off_q, off_ep, off_bar, smem); stream
    "icaf_conv_int8_tma": (_P, _L, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P,
                           ctypes.c_float, _P, _P, _P, *(_I,) * 28, _P),
    # icaf_conv_int8's arguments up to epilogue, then the plan: th, tw, the
    # grid of persistent blocks, the shared memory a block; stream
    "icaf_conv_int8_stem": (_P, _L, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P,
                            ctypes.c_float, _P, *(_I,) * 20, _P),
    # icaf_conv_int8's arguments up to groups, then the plan: th, tw,
    # groups a block, the shared memory a block; stream
    "icaf_conv_int8_grouped": (_P, _L, _L, _L, _L, _P, _P, _P, _P, _P, _P,
                               _P, ctypes.c_float, _P, *(_I,) * 21, _P),
    # y (in place), scale, bias, numel, C, H * W, flags (bf16, channels_last,
    # SiLU), stream
    "icaf_bn_act": (_P, _P, _P, _L, _L, _L, _I, _P),
}


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float   # 0.0 when the library was already built
    log: str         # nvcc's stderr: the -Xptxas -v report per kernel


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build() -> Build:
    """Compile the sources unless a library with their hash exists: one
    ``nvcc -c`` per source, all started together, then one link."""
    srcs = [CSRC / s for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in (*srcs, *(CSRC / x for x in HEADERS)):
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libicafusion_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # unique per process and thread; os.replace publishes it atomically
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in srcs]
    t0 = time.perf_counter()
    nvcc = _nvcc()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stderr=subprocess.PIPE, text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[1] for p in procs]
    try:
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n{log}")
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return Build(out, time.perf_counter() - t0, "".join(logs))


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.icaf_error_string.argtypes = (_I,)
    lib.icaf_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry."""
    if err != 0:
        msg = library().icaf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
