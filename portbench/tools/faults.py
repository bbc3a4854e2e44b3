"""Faults planted under the timed path, to show that ``correct`` catches
them: each takes ``patch(obj, name, value)`` (pytest's
``monkeypatch.setattr``, or ``Patch`` below) and returns a function for the
driver's state after set-up, or None.

- ``altered_answers``: an answer altered where it is produced (the
  engine's copy of the detections back to the host);
- ``half_batch``: half of each batch answered from the other half's
  inputs;
- ``stale_answers``: each call answered with the call before's answer;
- ``float_engine``: an int8 configuration served unquantized;
- ``train_half_batch``: each microbatch's loss taken over its first half
  of rows alone, the mean over the rest;
- ``train_unchanged``: a train step that leaves the parameters and the
  EMA as they were.
"""

from __future__ import annotations


class Patch:
    """setattr that remembers, for ``undo``."""

    def __init__(self):
        self.saved = []

    def __call__(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved = []


def altered_answers(patch):
    import icafusion_tpu_torch.serve.engine as eng
    real = eng.detections_to_numpy

    def shifted(dets):
        out = real(dets)
        for a in out:
            a[:, :4] += 2.0
        return out

    patch(eng, "detections_to_numpy", shifted)
    return None


def half_batch(patch):
    def plant(state):
        def pre(m, args):
            x, y = (a.clone() for a in args[:2])
            h = x.shape[0] // 2
            if h:
                x[h:2 * h], y[h:2 * h] = x[:h], y[:h]
            else:                   # a lone image: answered from nothing
                x.zero_(), y.zero_()
            return (x, y)

        state.server.model.register_forward_pre_hook(pre)
    return plant


def stale_answers(patch):
    from icafusion_tpu_torch.serve.engine import ServingEngine
    real = ServingEngine._finalize
    last = {}

    def finalize(self, dets, n, orig_hw=None):
        out = real(self, dets, n, orig_hw)
        prev = last.get("out", out)
        last["out"] = out
        return [prev[i % len(prev)] for i in range(n)]

    patch(ServingEngine, "_finalize", finalize)
    return None


def float_engine(patch):
    from portbench.core import serving as S
    real = S.build_engine
    patch(S, "build_engine",
          lambda *a, **k: real(*a, **{**k, "int8": False}))
    return None


def train_half_batch(patch):
    from icafusion_tpu_torch.train.trainer import Trainer
    real = Trainer._forward_loss

    def half(self, rgb, ir, targets, mask):
        h = max(rgb.shape[0] // 2, 1)
        return real(self, rgb[:h], ir[:h], targets[:h], mask[:h])

    patch(Trainer, "_forward_loss", half)
    return None


def train_unchanged(patch):
    import icafusion_tpu_torch.train.trainer as tr
    from icafusion_tpu_torch.train.optim import YoloSGD

    def update(self, params, grads, state, paths):
        state.step += 1
        return state

    patch(YoloSGD, "update", update)
    patch(tr, "ema_update", lambda state, variables, decay=0.9999: state)
    return None


FAULTS = {f.__name__: f for f in (altered_answers, half_batch,
                                  stale_answers, float_engine,
                                  train_half_batch, train_unchanged)}
