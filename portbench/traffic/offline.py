"""Offline serving: one client calls ``ServingEngine.predict_arrays`` back
to back in a closed loop, ``batch`` pairs a call, uint8 arrays in and numpy
detections out, as a batch job over recorded drives does.

Workload keys: ``batch`` (pairs a call), ``pool`` (distinct pairs drawn
from the seed; the calls take them ``batch`` at a time in a seed-drawn
order, round and round), ``sample_calls`` (calls whose outputs the check
compares, a reservoir over the window). End-to-end: ``pairs_per_s``, the
pairs returned over the window's wall time (the window ends when the call
running at its deadline returns).
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch
from torch.autograd.profiler import record_function

from portbench.core import serving as S
from portbench.core.inputs import ORDER_STREAM, rng


@dataclasses.dataclass
class State:
    inputs: Any
    server: Any
    batches: List[tuple]
    order: List[np.ndarray]
    capture: Any
    kept: Dict[int, list] = dataclasses.field(default_factory=dict)
    int8_launches: int = 0      # over the window's calls
    forwards: int = 0


def served_model(state):
    return state.server.model


def setup(ctx) -> State:
    spec = ctx.spec
    batch = int(spec["batch"])
    inputs = S.Inputs(ctx.config, ctx.seed, int(spec["pool"]), ctx.device)
    server = S.make_server(ctx, inputs, batch)
    perm = rng(ctx.seed, ORDER_STREAM).permutation(len(inputs.rgb))
    order = [perm[i:i + batch] for i in range(0, len(perm) - batch + 1,
                                              batch)]
    batches = [(np.ascontiguousarray(inputs.rgb[o]),
                np.ascontiguousarray(inputs.ir[o])) for o in order]
    for _ in range(2):                      # every shape, twice
        for rgb, ir in batches[:2]:
            server.predict_arrays(rgb, ir)
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.synchronize()
    cap = S.Capture(server.model, int(spec["sample_calls"]),
                    ctx.seed)
    return State(inputs, server, batches, order, cap)


def window(ctx, st: State, seconds: float) -> dict:
    batch = int(ctx.spec["batch"])
    calls = failed = 0
    cuda = torch.device(ctx.device).type == "cuda"
    l0 = S.int8_launches() if cuda else 0
    st.capture.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        rgb, ir = st.batches[calls % len(st.batches)]
        try:
            with record_function("portbench.call"):
                dets = st.server.predict_arrays(rgb, ir)
        except Exception as e:  # noqa: BLE001 - counted, reported below
            failed += batch
            dets = None
            print(f"call {calls} failed: {e!r}", file=sys.stderr)
        live = {c["index"] for c in st.capture.slots}
        if calls in live:
            st.kept[calls] = dets
        for k in [k for k in st.kept if k not in live]:
            del st.kept[k]
        calls += 1
    t1 = time.perf_counter()
    st.capture.stop()
    st.forwards += st.capture.n
    if cuda:
        st.int8_launches += S.int8_launches() - l0
    return {"metrics": {"pairs_per_s": (calls * batch - failed) / (t1 - t0)},
            "attempted": calls * batch, "failed": failed, "calls": calls,
            "batch": batch, "seconds": t1 - t0}


def check(ctx, st: State) -> dict:
    samples = st.capture.host()
    st.capture.remove()
    served, rows = [], []
    for smp in samples:
        dets = st.kept.get(smp["index"])
        served.append(list(dets) if dets is not None
                      else [None] * int(ctx.spec["batch"]))
        rows.append([int(p) for p in st.order[smp["index"] % len(st.order)]])
    st.server = st.capture = None
    gc.collect()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    cuda = torch.device(ctx.device).type == "cuda"
    numbers = S.compare(ctx.config, st.inputs, samples, rows, served,
                        ctx.device, int(ctx.spec["batch"]),
                        (st.int8_launches, st.forwards) if cuda else None)
    return S.judge(ctx.config, numbers)
