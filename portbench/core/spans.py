"""What the measured package's own spans give a traced window.

The port opens ``record_function`` ranges inside its serving call and its
train step (``icafusion_tpu_torch/utils/profiling.span``: ``serve.upload``,
``serve.forward``, ``serve.nms``, ``serve.fetch``, ``serve.d2h``;
``train.step``, ``train.forward``, ``train.loss``, ``train.backward``,
``train.optimizer``, ``train.ema``). They are annotations of the
profiler's own timeline, so ``TraceResult`` already labels each device
operation with the spans open on its launching thread at its launch. Here:
the thread that opened a span, the device time launched inside spans, and
the device's idle gaps whose start falls inside spans. Every function
returns None where the window holds none of the spans asked for (a program
without them).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from portbench.core.trace import TraceResult, open_ranges


def thread_of(tr: TraceResult, name: str) -> Optional[int]:
    """The thread that opened span ``name`` inside the window; None where
    none did."""
    for tid, spans in tr.annotations.items():
        if any(n == name and s >= tr.t0 and t <= tr.t1
               for s, t, n in spans):
            return tid
    return None


def gaps(tr: TraceResult) -> List[Tuple[int, int]]:
    """The device's idle stretches inside the window, (start, end) ns."""
    out, prev = [], tr.t0
    for s, t in tr.busy():
        if s > prev:
            out.append((prev, s))
        prev = t
    if prev < tr.t1:
        out.append((prev, tr.t1))
    return out


def idle_s(tr: TraceResult, names: Iterable[str]) -> Optional[float]:
    """Seconds the device sat idle in gaps that start while one of the
    spans ``names`` is open, at any depth, on the thread that opened
    them (``open_ranges``' sweep); None where none was opened, or the
    device ran nothing."""
    names = set(names)
    tids = {thread_of(tr, n) for n in names} - {None}
    if len(tids) != 1 or not tr.t1 or not tr.ops:
        return None
    edges = gaps(tr)
    labels = open_ranges(tr.annotations[tids.pop()], [a for a, _ in edges])
    return sum(b - a for (a, b), lab in zip(edges, labels)
               if names & set(lab)) / 1e9


def device_s(tr: TraceResult, names: Iterable[str],
             quiet: bool = False) -> Optional[float]:
    """Summed seconds of the device operations launched inside any of the
    spans ``names`` (any depth); with ``quiet``, also those launched where
    no range at all was open, as on autograd's own thread, which opens
    none. None where none of the spans was opened, or the device ran
    nothing."""
    names = set(names)
    if not tr.ops or all(thread_of(tr, n) is None for n in names):
        return None
    return sum(t - s for s, t, _, _, lab in tr.ops
               if names & set(lab) or (quiet and not lab)) / 1e9


def per(tr: TraceResult, seconds: Optional[float], each: str
        ) -> Optional[float]:
    """``seconds`` in ms per opening of range ``each`` in the window; None
    where there is nothing to divide."""
    n = tr.count(each)
    return None if seconds is None or not n else 1e3 * seconds / n
