"""Model summary, FLOPs and per-layer timing, and device traces.

The counterpart of the JAX package's utils/profiling.py (reference
utils/torch_utils.py:205-235 model_info with thop's GFLOPs, and
models/yolo_test.py:144-152, the forward's per-layer profile):

- FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over a
  float32 CPU copy of the model, so the count is that of the kernels' plain
  versions and the same wherever the model lies: the hand-written kernels
  launch through ctypes, which the counter does not see. It counts
  matrix products and convolutions (two operations a multiply-add); XLA's
  cost analysis in the JAX package adds the elementwise operations;
- ``profile_op`` times a call by CUDA events on the card, by the host
  clock on the CPU; ``profile_layers`` times each layer's own module on its
  input, captured from one forward;
- ``start_trace``/``stop_trace`` record a torch.profiler trace and write it
  as Chrome trace JSON under the log directory (TensorBoard's profiler
  plugin and Perfetto read it);
- ``span(name)`` marks a stretch of the serving call or the train step as
  a ``record_function`` range while a torch.profiler records, on the
  profiler's own clock, so that its trace (and the benchmark's readers,
  ``portbench/metrics/``) can put the card's device time and idle time
  down to it. With no profiler recording it is one shared null context.

The spans, where each opens, and the benchmark metric that reads it:

- ``serve.upload``: ``ServingEngine._dispatch``, under the engine's lock,
  the padding and the upload of the uint8 pairs (``shard_batch``);
  ``idle_io_ms.offline``.
- ``serve.forward``: ``ServingEngine._serve``, /255, the cast and the
  model's forward, per replica; ``idle_forward_ms.offline``.
- ``serve.nms``: ``ServingEngine._serve``, ``non_max_suppression``, per
  replica; ``nms_device_ms.offline``.
- ``serve.fetch``: ``ServingEngine._finalize``, the copy back, the unpad
  and the rescale; ``idle_io_ms.offline``.
- ``serve.d2h``: ``ServingEngine._finalize``, each of the four blocking
  ``.cpu()`` copies of the detections (nested in ``serve.fetch``); read
  through ``serve.fetch``.
- ``train.step``: ``Trainer.make_train_step``'s step; the count that the
  ``*_device_ms.train`` metrics divide by.
- ``train.forward``: ``Trainer._forward_loss``, the autocast forward, per
  microbatch; ``forward_device_ms.train``.
- ``train.loss``: ``Trainer._forward_loss``, the loss, per microbatch;
  ``forward_device_ms.train``.
- ``train.backward``: the step's ``loss.backward()``, per microbatch,
  while autograd's own thread launches the backward;
  ``backward_device_ms.train``.
- ``train.optimizer``: the step's gradients, all-reduce, masks and SGD
  update; ``update_device_ms.train``.
- ``train.ema``: the step's EMA update; ``update_device_ms.train``.

Nothing here swallows an exception: a layer that fails to run raises.
"""

from __future__ import annotations

import contextlib
import copy
import time
from pathlib import Path
from typing import Optional

import torch

_TRACE: Optional[tuple] = None          # (profiler, log directory)
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a torch.profiler
    records; otherwise one shared null context, so an unprofiled span costs
    a check (an unprofiled ``record_function`` costs about a hundred times
    as much on the host). Use as ``with span("serve.nms"): ...``."""
    if torch._C._autograd._profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return _NO_SPAN


def count_params(params) -> int:
    """Elements of a module's parameters, or of a mapping or sequence of
    tensors."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    elif isinstance(params, dict):
        params = params.values()
    return int(sum(p.numel() for p in params))


def flops_estimate(fn, *args) -> float:
    """Matrix-product and convolution FLOPs of ``fn(*args)`` as run
    (FlopCounterMode; a multiply-add is two)."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def model_info(model, img_size: int = 640, verbose: bool = True) -> dict:
    """Layers, parameters and GFLOPs of one paired forward at img_size x
    img_size (torch_utils.py:205-235), as {"layers", "params", "gflops"}.
    The FLOPs are counted on a float32 CPU copy (the plain versions), so
    the card's count equals the CPU's."""
    n_params = count_params(model)
    cpu = copy.deepcopy(model).to("cpu", torch.float32).eval()
    x = torch.zeros(1, 3, img_size, img_size)
    gflops = flops_estimate(cpu, x, x) / 1e9
    line = (f"Model Summary: {len(model.resolved)} layers, "
            f"{n_params / 1e6:.2f}M params, {gflops:.1f} GFLOPs @ "
            f"{img_size} (paired forward)")
    if verbose:
        print(line)
    return {"layers": len(model.resolved), "params": n_params,
            "gflops": gflops}


def profile_op(fn, *args, iters: int = 10) -> float:
    """ms a call of ``fn(*args)``, after one warm-up call: CUDA events
    around ``iters`` calls where the first tensor argument lies on the
    card, the host clock otherwise."""
    dev = next((a.device for a in _tensors(args)), torch.device("cpu"))
    with torch.inference_mode():
        fn(*args)
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters * 1e3


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)


def profile_layers(model, rgb, ir, iters: int = 5,
                   verbose: bool = True) -> list:
    """The per-layer table (yolo_test.py:144-152): one forward captures
    every layer's input, then each layer's own module is timed on it
    (profile_op). Detect, timed with the decode, is left out. Rows:
    {"i", "module", "ms", "params"}. A stream-merged model raises: its
    merged layers cannot be captured."""
    resolved = model.resolved
    with torch.inference_mode():
        _, caps = model(rgb, ir, capture=tuple(r.i for r in resolved))
    rows = []
    for r in resolved[:-1]:
        if r.f == -4:
            inp = ir
        elif r.f == -1:
            inp = caps[r.i - 1] if r.i > 0 else rgb
        elif isinstance(r.f, int):
            inp = caps[r.f]
        else:
            inp = [caps[j] if j >= 0 else caps[r.i - 1] for j in r.f]
        mod = getattr(model, f"m{r.i}")
        ms = profile_op(mod, inp, iters=iters)
        n_params = count_params(mod)
        rows.append({"i": r.i, "module": r.module, "ms": ms,
                     "params": n_params})
        if verbose:
            print(f"{r.i:3d} {r.module:28s} {ms:8.2f} ms "
                  f"{n_params / 1e3:10.1f}k")
    return rows


def start_trace(logdir: str):
    """Start recording a torch.profiler trace of the host and, where there
    is one, the card (CUPTI)."""
    global _TRACE
    if _TRACE is not None:
        raise RuntimeError("a trace is already being recorded")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _TRACE = (prof, Path(logdir))


def stop_trace() -> str:
    """Stop the trace and write it under the start_trace log directory as
    Chrome trace JSON (``trace_<ns>.pt.trace.json``); returns its path."""
    global _TRACE
    if _TRACE is None:
        raise RuntimeError("no trace is being recorded")
    prof, logdir = _TRACE
    _TRACE = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    logdir.mkdir(parents=True, exist_ok=True)
    path = logdir / f"trace_{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(str(path))
    return str(path)
