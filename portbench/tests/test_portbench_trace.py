"""The reduction of profiler events: which ranges a device operation
belongs to, device time by range, busy time, idle gaps by range."""

import pytest
import torch

from portbench.core.trace import TraceResult, open_ranges

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class Ev:
    """A stand-in for the profiler's event, with the methods read."""

    def __init__(self, name, kind, dev, start, end, tid=1, corr=0,
                 linked=-1):
        self._n, self._k, self._d = name, kind, dev
        self._s, self._e, self._t, self._c, self._l = (start, end, tid,
                                                       corr, linked)

    def name(self):
        return self._n

    def activity_type(self):
        return self._k

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def start_thread_id(self):
        return self._t

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


def events():
    """A window 0-1000 ns; two calls, the second with a model range; a
    kernel from each, a copy, and an idle stretch in each call."""
    return [
        Ev("portbench.window", "user_annotation", CPU, 0, 1000),
        Ev("portbench.call", "user_annotation", CPU, 10, 400),
        Ev("portbench.call", "user_annotation", CPU, 500, 990),
        Ev("model", "user_annotation", CPU, 520, 900),
        Ev("cudaMemcpyAsync", "cuda_runtime", CPU, 20, 25, corr=1),
        Ev("cudaLaunchKernel", "cuda_runtime", CPU, 30, 35, corr=2),
        Ev("cudaLaunchKernel", "cuda_runtime", CPU, 600, 605, corr=3),
        Ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", CUDA, 40, 140,
           corr=1),
        Ev("k1", "kernel", CUDA, 140, 300, corr=2),
        Ev("k2", "kernel", CUDA, 610, 910, corr=3),
        Ev("model", "gpu_user_annotation", CUDA, 600, 920),
    ]


def test_device_time_by_range_and_busy():
    tr = TraceResult(events(), "portbench.window")
    assert tr.window_s == 1e-6
    assert tr.unlinked == 0 and len(tr.ops) == 3
    assert tr.device_s() == 560e-9
    assert tr.device_s(within="model") == 300e-9
    assert tr.device_s(within="portbench.call", kinds=("kernel",)) == 460e-9
    assert tr.device_s(kinds=("gpu_memcpy",), name_has="HtoD") == 100e-9
    assert tr.busy() == [(40, 300), (610, 910)]
    assert tr.busy_s() == 560e-9
    assert tr.count("portbench.call") == 2
    assert tr.top_ops(2) == [["k2", 300e-9], ["k1", 160e-9]]


def test_idle_gaps_are_labelled_by_the_launching_threads_range():
    tr = TraceResult(events(), "portbench.window")
    gaps = dict(tr.idle_gaps())
    # the gaps 0-40, 300-610 and 910-1000, each labelled by the innermost
    # range open at its start: the window alone, then the first call, then
    # the second call (its model range closed at 900)
    assert gaps == {"portbench.window": 40e-9, "portbench.call": 400e-9}
    assert sum(gaps.values()) == pytest.approx((1000 - 560) * 1e-9)


def test_open_ranges_nests():
    spans = [(0, 100, "a"), (10, 20, "b"), (30, 60, "c"), (40, 50, "d")]
    assert open_ranges(spans, [5, 15, 25, 45, 55, 99, 150]) == [
        ("a",), ("a", "b"), ("a",), ("a", "c", "d"), ("a", "c"), ("a",), ()]
