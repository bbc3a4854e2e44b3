"""The readers of the measured package's spans (``core/spans.py`` and the
six ``*_ms`` metrics that read them) on hand-built profiler events: their
ms, their None where the spans are absent, and the rule that an idle gap
belongs to every span open, at any depth, at the gap's start."""

import pytest

from portbench.core import bench as B
from portbench.core import spans
from portbench.core.trace import TraceResult
from portbench.tests.test_portbench_trace import CPU, CUDA, Ev

SERVE = ("idle_forward_ms.offline", "idle_io_ms.offline",
         "nms_device_ms.offline")
TRAIN = ("forward_device_ms.train", "backward_device_ms.train",
         "update_device_ms.train")


class Ctx:
    def __init__(self, tr):
        self.trace_result = tr


def read(name, tr):
    return B.reader(name).read(Ctx(tr))


def ann(name, s, t, tid=1):
    return Ev(name, "user_annotation", CPU, s, t, tid=tid)


def launch(at, corr, tid=1):
    return Ev("cudaLaunchKernel", "cuda_runtime", CPU, at, at + 5, tid=tid,
              corr=corr)


def kernel(name, s, t, corr, kind="kernel"):
    return Ev(name, kind, CUDA, s, t, corr=corr)


def call(t, corr):
    """One predict_arrays call from ``t``, 1000 ns long: upload (its copy
    busy 20-120), forward (the model range inside it; kernels 150-350 and
    400-500), NMS (kernel 560-640), fetch (a copy 720-760 inside a d2h).
    Idle: 120-150 (starts in the upload, ends in the forward), 350-400 (in
    the model), 500-560 (in the forward, after the model), 640-720 (starts
    in NMS, ends in the fetch), and from 760 (in the fetch) past the
    call's end to the next call's copy or the window's end."""
    c = corr
    return [
        ann("portbench.call", t, t + 800),
        ann("serve.upload", t, t + 130),
        ann("serve.forward", t + 130, t + 520),
        ann("model", t + 140, t + 450),
        ann("serve.nms", t + 520, t + 700),
        ann("serve.fetch", t + 700, t + 790),
        ann("serve.d2h", t + 705, t + 780),
        launch(t + 10, c), kernel("Memcpy HtoD (Pageable -> Device)",
                                  t + 20, t + 120, c, "gpu_memcpy"),
        launch(t + 145, c + 1), kernel("conv", t + 150, t + 350, c + 1),
        launch(t + 380, c + 2), kernel("bn", t + 400, t + 500, c + 2),
        launch(t + 530, c + 3), kernel("greedy_nms", t + 560, t + 640,
                                       c + 3),
        launch(t + 710, c + 4), kernel("Memcpy DtoH (Device -> Pageable)",
                                       t + 720, t + 760, c + 4,
                                       "gpu_memcpy"),
    ]


def serving(with_spans=True):
    evs = [ann("portbench.window", 0, 2000)] + call(0, 10) + call(1000, 20)
    if not with_spans:
        evs = [e for e in evs if not e.name().startswith("serve.")]
    return TraceResult(evs, "portbench.window")


def test_serving_readers():
    tr = serving()
    # a call: the forward's gaps 350-400 (inside the model) and 500-560;
    # the upload's 0-20 (the window's start), 120-150 and 1120-1150; the
    # fetch's 760-1020 and 1760-2000, whole, as each starts in the fetch
    assert read("idle_forward_ms.offline", tr) == pytest.approx(
        1e3 * (50 + 60) * 1e-9)
    assert read("idle_io_ms.offline", tr) == pytest.approx(
        1e3 * (20 + 30 + 30 + 260 + 240) / 2 * 1e-9)
    assert read("nms_device_ms.offline", tr) == pytest.approx(1e3 * 80e-9)


def test_a_gap_belongs_to_the_spans_open_at_its_start():
    tr = serving()
    # the gap from 0 (the upload opens at 0), and those from 760 and 1760:
    # the fetch is open at their start and closes 30 ns later, while they
    # run on into the next call or to the window's end
    assert spans.idle_s(tr, ["serve.upload"]) == pytest.approx(
        (20 + 30 + 30) * 1e-9)
    assert spans.idle_s(tr, ["serve.fetch"]) == pytest.approx(
        (260 + 240) * 1e-9)
    # nested: the model's gap belongs to the forward too
    assert spans.idle_s(tr, ["model"]) == pytest.approx(2 * 50e-9)
    total = sum(b - a for a, b in spans.gaps(tr)) / 1e9
    assert total == pytest.approx(2000e-9 - tr.busy_s())
    parts = sum(spans.idle_s(tr, [n]) for n in (
        "serve.upload", "serve.forward", "serve.nms", "serve.fetch"))
    assert parts == pytest.approx(total)


def step(t, corr):
    """One Trainer step from ``t``: two microbatches of forward (a kernel
    of 100), loss (20), backward (autograd's thread 2 launches 200, and the
    step's thread one of 10 inside train.backward), then the optimizer
    (30) and EMA (5). An add of 1 between the stages stays outside them."""
    c, evs = corr, [ann("portbench.call", t, t + 2000),
                    ann("train.step", t, t + 1990)]
    for m in (0, 900):
        b = t + m
        evs += [ann("train.forward", b, b + 100),
                ann("train.loss", b + 100, b + 150),
                ann("train.backward", b + 150, b + 850),
                launch(b + 10, c), kernel("fwd", b + 20, b + 120, c),
                launch(b + 110, c + 1), kernel("loss", b + 130, b + 150,
                                               c + 1),
                launch(b + 160, c + 2, tid=2), kernel("bwd", b + 200,
                                                      b + 400, c + 2),
                launch(b + 170, c + 3), kernel("acc", b + 400, b + 410,
                                               c + 3),
                launch(b + 860, c + 4), kernel("add", b + 870, b + 871,
                                               c + 4)]
        c += 5
    evs += [ann("train.optimizer", t + 1800, t + 1900),
            ann("train.ema", t + 1900, t + 1950),
            launch(t + 1810, c), kernel("sgd", t + 1820, t + 1850, c),
            launch(t + 1910, c + 1), kernel("ema", t + 1920, t + 1925,
                                            c + 1)]
    return evs


def training(with_spans=True):
    evs = [ann("portbench.window", 0, 4000)] + step(0, 100) + step(2000, 200)
    if not with_spans:
        evs = [e for e in evs if not e.name().startswith("train.")]
    return TraceResult(evs, "portbench.window")


def test_training_readers():
    tr = training()
    assert spans.thread_of(tr, "train.step") == 1
    assert set(tr.launch_threads) == {1, 2} and 2 not in tr.annotations
    assert read("forward_device_ms.train", tr) == pytest.approx(
        1e3 * 2 * 120e-9)
    assert read("backward_device_ms.train", tr) == pytest.approx(
        1e3 * 2 * 210e-9)
    assert read("update_device_ms.train", tr) == pytest.approx(1e3 * 35e-9)
    # the stages and the adds between them make up the step's device time
    stages = sum(read(n, tr) for n in TRAIN)
    assert stages + 1e3 * 2e-9 == pytest.approx(
        1e3 * tr.device_s() / tr.count("train.step"))


def test_backward_needs_a_thread_that_opened_no_range():
    evs = [e for e in (ann("portbench.window", 0, 4000),) + tuple(
        step(0, 100)) if e.start_thread_id() != 2]
    tr = TraceResult(evs, "portbench.window")
    assert read("backward_device_ms.train", tr) is None
    assert read("forward_device_ms.train", tr) is not None


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_absent_spans_read_none(name):
    """A program that opens none of the spans: every reader returns None,
    in both kinds of window, and so on a window the device never
    touched."""
    for tr in (serving(False), training(False)):
        assert read(name, tr) is None
    empty = TraceResult([ann("portbench.window", 0, 10),
                         ann("serve.forward", 1, 5),
                         ann("serve.nms", 5, 6), ann("train.step", 1, 9),
                         ann("train.backward", 2, 3),
                         ann("portbench.call", 1, 9)], "portbench.window")
    assert read(name, empty) is None


def test_the_six_are_in_the_benchmark():
    bench = B.load()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in SERVE + TRAIN:
        m = entries[name]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert m["workloads"] == [
            w["name"] for w in bench["workloads"]
            if w["traffic"] == ("offline-b32" if name in SERVE
                                else "train-b64")]
