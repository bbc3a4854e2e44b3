"""Build and load the port's CUDA kernels.

One ``nvcc`` call compiles every source in ``csrc/`` into one shared library
with a plain ``extern "C"`` interface (no PyTorch headers, so it builds in
seconds), under ``build/`` at the repository root. The library is named by a
hash of the sources and flags, so an edited source is rebuilt at its first
use and an unchanged one is loaded as it is. ``ctypes`` binds it: every
pointer and the stream pass as ``c_void_p``, and every entry returns
``cudaGetLastError()``, which ``check`` turns into an exception.

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
SOURCES = ("dual_cross_attention.cu", "greedy_nms.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry name -> argtypes (see each source's extern "C" block)
SIGNATURES = {
    # vis, ir, weights[6], biases[6], qkv scratch, out_vis, out_ir,
    # B, N, D, H, is_bf16, stream
    "icaf_dual_cross_attention": (_P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _P),
    # boxes, scores, keep, ok, B, K, max_det, iou_thres, stream
    "icaf_greedy_nms": (_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P),
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
    """Compile the sources unless a library with their hash exists."""
    srcs = [CSRC / s for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libicafusion_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # unique per process and thread; os.replace publishes it atomically
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           *map(str, srcs)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return Build(out, time.perf_counter() - t0, proc.stderr)


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
