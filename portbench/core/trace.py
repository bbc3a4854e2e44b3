"""The traced run: torch.profiler (CUPTI) over the window, ranges that the
harness puts around the measured package's modules and calls, and the
reduction of the profiler's events to device time by range, device busy
time, idle gaps and the operations that took the most time.

Ranges are ``record_function`` annotations: around a call (``with
record_function(name)``) or around a module's forward (``Ranges.add``, a
forward pre-hook enters it and a forward hook leaves it, per thread). A
device operation belongs to every range that was open on the host thread
that launched it, at the time it was launched (the launch is matched to
the operation by CUPTI's correlation id). Events stay in memory; no trace
file is written.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd.profiler import record_function

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class Ranges:
    """Forward hooks that open a named range around modules' forwards, and
    an optional per-call record of their input and output shapes."""

    def __init__(self):
        self._local = threading.local()
        self.handles = []
        self.calls: Dict[str, List[tuple]] = defaultdict(list)

    def _stack(self):
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def add(self, module: torch.nn.Module, name: str, record: bool = False):
        def pre(m, args):
            rf = record_function(name)
            rf.__enter__()
            self._stack().append((rf, args[0] if args else None))

        def post(m, args, out):
            rf, x = self._stack().pop()
            rf.__exit__(None, None, None)
            if record:
                y = out[0] if isinstance(out, (tuple, list)) else out
                self.calls[name].append((m, tuple(x.shape)
                                         if torch.is_tensor(x) else None,
                                         tuple(y.shape)
                                         if torch.is_tensor(y) else None))

        self.handles.append(module.register_forward_pre_hook(pre))
        self.handles.append(module.register_forward_hook(post))

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []


class Profile:
    """torch.profiler over a window; ``result()`` reduces its events."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(*exc)

    def result(self, window: str) -> "TraceResult":
        return TraceResult(self.prof.profiler.kineto_results.events(), window)


class TraceResult:
    """Device operations of the traced window, each with the ranges open
    at its launch. ``window`` names the range that spans the window."""

    def __init__(self, events, window: str):
        anns: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
        launch: Dict[tuple, Tuple[int, int]] = {}
        dev = []
        self.kinds_seen = set()
        cpu = torch.autograd.DeviceType.CPU
        for e in events:
            kind = _kind(e, cpu)
            if kind == "user_annotation":
                anns[e.start_thread_id()].append(
                    (e.start_ns(), e.end_ns(), e.name()))
            elif kind in ("cuda_runtime", "cpu_op"):
                # a runtime call shares CUPTI's id with what it launched; a
                # cpu op's id is the one its operations link to
                key = ("rt" if kind == "cuda_runtime" else "op",
                       e.correlation_id())
                launch[key] = (e.start_thread_id(), e.start_ns())
            elif e.device_type() != cpu:
                self.kinds_seen.add(kind)
                if kind in DEVICE_KINDS:
                    dev.append((e, kind))
        names = {a[2] for t in anns.values() for a in t}
        dev = [(e, k) for e, k in dev if e.name() not in names]
        win = [a for t in anns.values() for a in t if a[2] == window]
        if win:
            self.t0, self.t1 = win[0][0], win[0][1]
        else:
            self.t0 = self.t1 = 0
        # per thread: the launches, then a sweep over the nested ranges
        queries: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
        self.ops = []      # (start_ns, end_ns, name, kind, labels)
        pending = []
        for i, (e, _) in enumerate(dev):
            src = launch.get(("rt", e.correlation_id())) or launch.get(
                ("op", getattr(e, "linked_correlation_id", lambda: -1)()))
            pending.append((e, src))
            if src is not None:
                queries[src[0]].append((src[1], i))
        labels: List[Tuple[str, ...]] = [()] * len(dev)
        for tid, qs in queries.items():
            for i, lab in zip((i for _, i in sorted(qs)),
                              open_ranges(anns.get(tid, ()),
                                          sorted(ts for ts, _ in qs))):
                labels[i] = lab
        self.unlinked = sum(1 for _, src in pending if src is None)
        self.launch_threads = {tid: len(qs) for tid, qs in queries.items()}
        self.annotations = anns
        for (e, kind), lab in zip(dev, labels):
            s, t = e.start_ns(), e.end_ns()
            if self.t1 and (t <= self.t0 or s >= self.t1):
                continue
            self.ops.append((s, t, e.name(), kind, lab))

    # ---- reductions ------------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def device_s(self, within: Optional[str] = None,
                 kinds: Sequence[str] = DEVICE_KINDS,
                 name_has: Optional[str] = None) -> float:
        """Summed seconds of the device operations launched inside range
        ``within`` (any depth; None: all), of the given kinds."""
        tot = 0
        for s, t, name, kind, lab in self.ops:
            if kind in kinds and (within is None or within in lab) and (
                    name_has is None or name_has in name):
                tot += t - s
        return tot / 1e9

    def count(self, name: str) -> int:
        """Times range ``name`` was opened inside the window."""
        return sum(1 for t in self.annotations.values() for a in t
                   if a[2] == name and a[0] >= self.t0 and a[1] <= self.t1)

    def busy(self) -> List[Tuple[int, int]]:
        """Union of the device operations' intervals within the window."""
        iv = sorted((max(s, self.t0), min(t, self.t1))
                    for s, t, *_ in self.ops)
        out: List[List[int]] = []
        for s, t in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy()) / 1e9

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, int] = defaultdict(int)
        for s, t, name, *_ in self.ops:
            by[name] += t - s
        return [[k, v / 1e9] for k, v in sorted(by.items(),
                                                key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle time of the device inside the window, summed by the
        innermost range open on the launching thread (the one that
        launched the most operations) at each gap's start; "(no range)"
        where none was."""
        if not self.t1 or not self.ops:
            return []
        tid = max(self.launch_threads, key=self.launch_threads.get) \
            if self.launch_threads else None
        edges, prev = [], self.t0
        for s, t in self.busy():
            if s > prev:
                edges.append((prev, s))
            prev = t
        if prev < self.t1:
            edges.append((prev, self.t1))
        by: Dict[str, int] = defaultdict(int)
        for (a, b), lab in zip(edges, open_ranges(
                self.annotations.get(tid, ()), [a for a, _ in edges])):
            by[lab[-1] if lab else "(no range)"] += b - a
        return [[k, v / 1e9] for k, v in sorted(by.items(),
                                                key=lambda kv: -kv[1])[:n]]


def _kind(e, cpu) -> str:
    """The activity kind of a profiler event: the event's own where this
    version of torch reports it, else from its device and name."""
    f = getattr(e, "activity_type", None)
    if f is not None:
        k = f()
        k = k if isinstance(k, str) else str(k)
        if k in ("cuda_runtime", "cuda_driver"):
            return "cuda_runtime"
        if k == "gpu_user_annotation":
            return "gpu_annotation"
        return k
    ann = getattr(e, "is_user_annotation", lambda: False)()
    name = e.name()
    if e.device_type() == cpu:
        if ann:
            return "user_annotation"
        if name.startswith(("cuda", "cu")) and not name.startswith(
                "cudnn"):
            return "cuda_runtime"
        return "cpu_op"
    if ann:
        return "gpu_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def open_ranges(spans, times) -> List[Tuple[str, ...]]:
    """For each of the sorted ``times``, the names of the (start, end,
    name) spans of one thread open at it, outermost first: one sweep over
    the properly nested spans."""
    spans = sorted(spans)
    out, stack, j = [], [], 0
    for ts in times:
        while j < len(spans) and spans[j][0] <= ts:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < ts:
            stack.pop()
        out.append(tuple(sp[2] for sp in stack if sp[1] >= ts))
    return out
