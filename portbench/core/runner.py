"""One run of one cell, as ``portbench/run.py`` drives it.

set-up (the driver's ``setup``: inputs and weights from the seed, the
measured program built and warmed on every shape the cell uses) ->
``setup_s`` -> the window (the driver's ``window``, ``seconds`` long; with
``trace`` under torch.profiler, with the ranges the cell's per-layer
readers ask for) -> the device's memory peak -> the per-layer metrics
(traced run) -> the comparison with the plain reference (the driver's
``check``, after the program's state is freed) -> the look for JAX in
``sys.modules`` -> one JSON line on stdout.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from portbench.core import bench as B

FORBIDDEN = ("jax", "jaxlib", "flax", "icafusion_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (icafusion_tpu_torch is not icafusion_tpu)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Ctx:
    """What a driver and a metric reader are given."""
    cell: str
    seed: int
    seconds: float
    trace: bool
    device: str
    spec: dict            # the workload file
    config: dict          # the configuration file
    control: bool = False  # serve the control in the program's place
    state: Any = None
    out: Optional[dict] = None
    trace_result: Any = None   # the traced window's first half
    fine_result: Any = None    # its second half, with module ranges
    ranges: Any = None


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def run(cell: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        root: Path = B.ROOT, control: bool = False,
        plant: Optional[Callable[[Any], None]] = None) -> dict:
    """The result line of one run as a dict. ``control`` serves the
    control in the program's place (tools/readings.py); ``plant`` is given
    the driver's state after set-up (the fault tests break it there). The
    plain reference finds its module files under ``root``."""
    from portbench.reference import model as refm
    with refm.modules_from(B.modules_dir(root)):
        return _run(cell, seed, seconds, trace, device, t_start, root,
                    control, plant)


def _run(cell, seed, seconds, trace, device, t_start, root, control, plant):
    import torch
    from torch.autograd.profiler import record_function

    from portbench.core import trace as T
    t_start = time.perf_counter() if t_start is None else t_start
    bench = B.load(root)
    spec = B.workload(cell, root)
    ctx = Ctx(cell, seed, seconds, trace, device, spec,
              B.config(spec["config"], root), control)
    drv = B.driver(spec["kind"], root)
    cuda = torch.device(device).type == "cuda"

    ctx.state = drv.setup(ctx)
    if plant is not None:
        plant(ctx.state)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    entries = B.metrics_for(bench, cell, trace)
    readers = {m["name"]: B.reader(m["name"], root) for m in entries} \
        if trace else {}
    fine = [r for r in readers.values() if hasattr(r, "ranges")]
    prof = None
    if trace:
        # the window's first half with the call and model ranges alone (for
        # what the host's pace moves: idle share, rates); where a reader
        # asks for module ranges, its second half with them too (for
        # device times by module, which host work does not change)
        ctx.ranges = T.Ranges()
        model = drv.served_model(ctx.state)
        ctx.ranges.add(model, "model")
        prof = T.Profile()
        prof.__enter__()
    try:
        span = seconds / 2 if fine else seconds
        with record_function("portbench.window"):
            ctx.out = drv.window(ctx, ctx.state, span)
        if fine:
            for r in fine:
                r.ranges(ctx.ranges.add, model)
            with record_function("portbench.fine"):
                second = drv.window(ctx, ctx.state, seconds - span)
            for k in ("attempted", "failed"):
                ctx.out[k] += second[k]
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    metrics: Dict[str, dict] = {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result: Dict[str, Any] = {}
    if trace:
        ctx.ranges.remove()
        tr = ctx.trace_result = prof.result("portbench.window")
        ctx.fine_result = prof.result("portbench.fine") if fine else None
        for m in entries:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(10),
                               "idle_gaps": tr.idle_gaps(10)}
        print(f"trace: {len(tr.ops)} device operations, {tr.unlinked} "
              f"without a launch, kinds {sorted(tr.kinds_seen)}",
              file=sys.stderr)
    else:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        for m in entries:
            if m["name"] in ctx.out["metrics"]:
                metrics[m["name"]] = {"value": ctx.out["metrics"][m["name"]],
                                      "unit": m["unit"]}
    prof = ctx.trace_result = ctx.fine_result = None
    gc.collect()

    checks = drv.check(ctx, ctx.state)
    from portbench.core.serving import passed
    complete = all(m["name"] in metrics for m in entries) or trace
    finite = all(math.isfinite(v["value"]) for v in metrics.values())
    correct = bool(passed(checks) and ctx.out["failed"] == 0 and complete
                   and finite)
    out = {"correct": correct, "attempted": ctx.out["attempted"],
           "failed": ctx.out["failed"], "metrics": metrics,
           "device": device_info}
    out.update(result)
    out["checks"] = checks
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark "
                                 "once and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    import torch
    bench = B.load()
    cell = {w["name"]: w for w in bench["workloads"]}.get(a.workload)
    if cell is None:
        print(f"unknown workload {a.workload}", file=sys.stderr)
        return 2
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"{a.workload} needs {cell['chips']} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 3
    print(f"card: {power_limit()}", file=sys.stderr)
    res = run(a.workload, a.seed, a.seconds, bool(a.trace), "cuda",
              t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0
