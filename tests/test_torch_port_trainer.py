"""icafusion_tpu_torch's Trainer against the JAX package's Trainer on the
CPU: the same tiny model (the JAX Trainer's own init, carried into the port)
and the same batch, float32, dropout off on both sides (flax.linen.Dropout
is replaced by the identity inside these tests only; the port's p is 0).

Tolerances. JAX's float32 BatchNorm takes the variance as E[x^2] - E[x]^2;
against a float64 run of the same forward its train-mode output is 4 to 6
times farther off than the port's (measured layer by layer on this model),
and BatchNorm over the 8 values a channel holds at P5 (2 images of 64 px)
magnifies such rounding: on the CPU, a one-ulp change of the input alone
moves the port's momentum by 1.6e-4 after three steps. Measured port
against JAX here: losses 3e-5 relative, first gradients 3e-4 of their
tensor's scale, weights, statistics and EMA 1e-4, momentum 7.7e-3. The
gates below leave 3 to 10 times that."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu_torch.utils.convert import flax_tree
from torch_port_common import nchw, tiny_trainers, train_batch

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
GRAD_RTOL = 2e-3          # of the tensor's largest gradient (+ a tenth of
                          # the largest of all, for tensors near zero)
STATE_ATOL = 1e-3         # weights, BatchNorm statistics, EMA
MOMENTUM_ATOL = 5e-2      # |momentum| reaches 0.4 here


def _run(B, steps, accum=1):
    """Both trainers through ``steps`` steps of one batch: (JAX states
    after each step, port trainer, JAX metrics, port metrics, port momentum
    after the first step in flax layout)."""
    jtr, state, jstep, tr, _ = tiny_trainers(B, accum)
    step = tr.make_train_step()
    data = train_batch(B * accum)
    tdata = [nchw(data[0]), nchw(data[1]), torch.from_numpy(data[2]),
             torch.from_numpy(data[3])]
    states, jm, tm = [], [], []
    for i in range(steps):
        state, met = jstep(state, *(jnp.asarray(a) for a in data))
        states.append(jax.device_get(state))
        jm.append({k: float(v) for k, v in met.items()})
        tm.append({k: float(v) for k, v in step(*tdata).items()})
        if i == 0:
            first = flax_tree(tr.model, tr.opt.momentum)
    return states, tr, jm, tm, first


def _max_diff(want_tree, got_tree):
    flat = dict(jax.tree_util.tree_flatten_with_path(got_tree)[0])
    return max(float(np.abs(np.asarray(w) - flat[p]).max())
               for p, w in jax.tree_util.tree_flatten_with_path(want_tree)[0])


@pytest.fixture(scope="module")
def three_steps():
    return _run(2, 3)


def test_first_step_gradients_match_jax(three_steps):
    """The momentum after the first step is the gradient (plus the weight
    decay of the kernels, on equal weights): tensor by tensor against
    JAX's."""
    states, tr, _, _, first = three_steps
    flat = dict(jax.tree_util.tree_flatten_with_path(first)[0])
    leaves = jax.tree_util.tree_flatten_with_path(
        states[0].opt.momentum)[0]
    top = max(float(np.abs(np.asarray(w)).max()) for _, w in leaves)
    for p, w in leaves:
        w = np.asarray(w)
        scale = np.abs(w).max() + top / 10
        assert np.abs(flat[p] - w).max() <= GRAD_RTOL * scale, \
            jax.tree_util.keystr(p)


def test_three_steps_match_jax_trainer(three_steps):
    """Loss, items and lr of each step; then weights, BatchNorm statistics,
    momentum and the EMA tree."""
    states, tr, jm, tm, _ = three_steps
    state = states[-1]
    for a, b in zip(tm, jm):
        for k in ("loss", "lbox", "lobj", "lcls"):
            assert a[k] == pytest.approx(b[k], rel=LOSS_RTOL), k
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6)
    assert tm[1]["lr"] > 0               # past step 0 the kernels move too
    sd = tr.model.state_dict()
    assert _max_diff(state.params, flax_tree(tr.model, sd)) <= STATE_ATOL
    assert _max_diff(state.batch_stats,
                     flax_tree(tr.model, sd, "batch_stats")) <= STATE_ATOL
    assert _max_diff(state.opt.momentum,
                     flax_tree(tr.model, tr.opt.momentum)) <= MOMENTUM_ATOL
    assert _max_diff(state.ema.tree["params"],
                     flax_tree(tr.model, tr.ema.tree)) <= STATE_ATOL
    assert _max_diff(state.ema.tree["batch_stats"], flax_tree(
        tr.model, tr.ema.tree, "batch_stats")) <= STATE_ATOL
    assert tr.opt.step == int(state.opt.step) == 3
    assert tr.ema.updates == int(state.ema.updates) == 3


def test_accum_steps_2_matches_jax_trainer():
    """Two microbatches of 2 summed before each optimizer step, the
    BatchNorm statistics updated in sequence: two steps against JAX."""
    states, tr, jm, tm, _ = _run(2, 2, accum=2)
    for a, b in zip(tm, jm):
        for k in ("loss", "lbox", "lobj", "lcls"):
            assert a[k] == pytest.approx(b[k], rel=LOSS_RTOL), k
    sd = tr.model.state_dict()
    assert _max_diff(states[-1].params,
                     flax_tree(tr.model, sd)) <= STATE_ATOL
    assert _max_diff(states[-1].batch_stats,
                     flax_tree(tr.model, sd, "batch_stats")) <= STATE_ATOL
    assert tr.optimizer.total_batch_size == 4
