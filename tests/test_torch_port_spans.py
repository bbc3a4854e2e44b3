"""The port's spans (utils/profiling.span) on the CPU: a shared null context
while no profiler records; under torch.profiler, the serving call's and
the train step's spans, each as often as its stage runs and properly
nested; and the same detections and the same state after a step with the
profiler on and off."""

import numpy as np
import pytest
import torch

from icafusion_tpu_torch.config import load_hyp_config
from icafusion_tpu_torch.models import zoo
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.serve.engine import ServingEngine
from icafusion_tpu_torch.train.trainer import Trainer
from icafusion_tpu_torch.utils import profiling

torch.set_num_threads(1)

CANVAS = (64, 96)
SIZE, B, ACCUM = 64, 2, 2


def _model():
    return build_model(zoo.tiny_icafusion_config(),
                       generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def engine():
    return ServingEngine(_model(), CANVAS, 4, conf_thres=0.001, max_det=100,
                         dtype="float32", device="cpu")


def _pairs(n=3):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (n, *CANVAS, 3), np.uint8)
            for _ in range(2)]


def _trainer():
    return Trainer(model=_model(), hyp=load_hyp_config(), epochs=3,
                   steps_per_epoch=1, batch_size=B, imgsz=SIZE,
                   warmup_min_steps=2, accum_steps=ACCUM, device="cpu")


def _batch():
    g = torch.Generator().manual_seed(1)
    n = B * ACCUM
    rgb, ir = (torch.rand(n, 3, SIZE, SIZE, generator=g) for _ in range(2))
    targets = torch.zeros(n, 4, 5)
    targets[:, 0] = torch.tensor([0, 0.5, 0.5, 0.4, 0.4])
    targets[:, 1] = torch.tensor([1, 0.25, 0.3, 0.2, 0.3])
    mask = torch.zeros(n, 4, dtype=torch.bool)
    mask[:, :2] = True
    return rgb, ir, targets, mask


def _state(tr):
    return {**{f"p.{k}": v.detach() for k, v in tr.params.items()},
            **{f"m.{k}": v for k, v in tr.opt.momentum.items()},
            **{f"e.{k}": v for k, v in tr.ema.tree.items()}}


def _spans(fn, prefix):
    """fn() under torch.profiler (CPU): its result and the spans whose
    name starts with ``prefix``, as sorted (start, end, name) of one
    thread."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name().startswith(prefix)]
    assert len({e.start_thread_id() for e in evs}) == 1
    return out, sorted((e.start_ns(), e.end_ns(), e.name()) for e in evs)


def _nesting(spans):
    """Each span as (name, names of the spans it lies in, outermost
    first), in order; raises where two spans overlap without nesting."""
    out, stack = [], []
    for s, t, name in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        assert not stack or t <= stack[-1][1], (name, stack[-1])
        out.append((name, tuple(x[2] for x in stack)))
        stack.append((s, t, name))
    return out


def test_span_without_a_profiler_is_one_null_context(monkeypatch, engine):
    """No profiler: every span is the same shared object, and neither a
    serving call nor a train step enters record_function."""
    def entered(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", entered)
    assert profiling.span("serve.upload") is profiling.span("train.step")
    with profiling.span("serve.nms") as x:
        assert x is None
    engine.predict_arrays(*_pairs())
    tr = _trainer()
    tr.make_train_step()(*_batch())


def test_serving_call_spans(engine):
    """One predict_arrays of 3 pairs on a batch of 4: the upload (with its
    padding), the forward, NMS and the fetch with its four copies."""
    pairs = _pairs()
    want = engine.predict_arrays(*pairs)
    got, spans = _spans(lambda: engine.predict_arrays(*pairs), "serve.")
    assert _nesting(spans) == [
        ("serve.upload", ()), ("serve.forward", ()), ("serve.nms", ()),
        ("serve.fetch", ())] + [("serve.d2h", ("serve.fetch",))] * 4
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_train_step_spans():
    """One step at accum_steps=2: train.step around two microbatches'
    forward, loss and backward, then the optimizer and EMA; the losses and
    the state after the step equal to a step with no profiler."""
    base, on = _trainer(), _trainer()
    want = base.make_train_step()(*_batch())
    got, spans = _spans(lambda: on.make_train_step()(*_batch()), "train.")
    inner = ("train.step",)
    assert _nesting(spans) == [("train.step", ())] + [
        ("train.forward", inner), ("train.loss", inner),
        ("train.backward", inner)] * ACCUM + [
        ("train.optimizer", inner), ("train.ema", inner)]
    for k in ("loss", "lbox", "lobj", "lcls"):
        assert torch.equal(got[k], want[k]), k
    a, b = _state(on), _state(base)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
