"""Stream-merged training in the port (utils/stream_merge: merge_train_state,
grad_mask, unmerge_train_state; Trainer.make_train_step(grad_mask=); fit's
merge_streams) against the JAX package's merged train step, on the CPU:
the tiny model at 64 px, batch 2, float32, dropout off on both sides, from
the JAX model's own init, as tests/test_stream_merge.py::
test_train_equivalence runs it.

Tolerances are JAX's own there: each loss within 1e-4 and the unmerged
parameters after three steps within 1e-4; the zero blocks exactly 0."""

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp

from icafusion_tpu.config import load_hyp_config as jax_hyp
from icafusion_tpu.models import zoo as jax_zoo
from icafusion_tpu.models.assembler import build_model as jax_build
from icafusion_tpu.train.trainer import Trainer as JaxTrainer
from icafusion_tpu.utils import stream_merge as jsm
from icafusion_tpu_torch.config import load_hyp_config
from icafusion_tpu_torch.models import zoo
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.train.trainer import Trainer
from icafusion_tpu_torch.utils import stream_merge as sm
from icafusion_tpu_torch.utils.convert import flax_tree, load_jax_variables
from torch_port_common import NoDropout, nchw, no_dropout, train_batch

torch.set_num_threads(1)

B, PX, STEPS = 2, 64, 3
KW = dict(epochs=3, steps_per_epoch=5, batch_size=B, imgsz=PX,
          warmup_min_steps=0)


@pytest.fixture(scope="module")
def start():
    """(JAX init variables, the numpy batch, its torch twin)."""
    jcfg = jax_zoo.tiny_icafusion_config()
    data = train_batch(B)
    init = jax.jit(jax_build(jcfg).init, static_argnames=("train", "decode"))
    v = init({"params": jax.random.PRNGKey(0)}, jnp.asarray(data[0][:1]),
             jnp.asarray(data[1][:1]), train=False, decode=False)
    v = jax.tree.map(np.asarray, {"params": v["params"],
                                  "batch_stats": v["batch_stats"]})
    tdata = [nchw(data[0]), nchw(data[1]), torch.from_numpy(data[2]),
             torch.from_numpy(data[3])]
    return v, data, tdata


def _port_trainer(v, pairs):
    """A port Trainer from v, merged at ``pairs`` (0: not), dropout off."""
    tr = Trainer(model=no_dropout(load_jax_variables(
        build_model(zoo.tiny_icafusion_config()), v)), hyp=load_hyp_config(),
        device="cpu", **KW)
    if pairs:
        tr = sm.merge_train_state(tr.model.cfg, tr, pairs)
        no_dropout(tr.model)
    return tr


def _port_run(tr, pairs, tdata):
    mask = sm.grad_mask(tr.model.cfg, tr.params, pairs) if pairs else None
    step = tr.make_train_step(grad_mask=mask)
    return [float(step(*tdata)["loss"]) for _ in range(STEPS)], mask


def _zero_blocks_exact(tr, mask):
    """Every merged tensor of the parameters, the momentum and the EMA is
    exactly 0 off the block diagonal."""
    for tree in (tr.params, tr.opt.momentum, tr.ema.tree):
        for k, m in mask.items():
            t = tree[k].detach()
            assert torch.equal(t * (1 - m), torch.zeros_like(t)), k
            if t.dim() == 4:
                assert (t[m.bool()] != 0).any(), k


def _max_diff(want, got):
    flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    return max(float(np.abs(np.asarray(w) - flat[p]).max())
               for p, w in jax.tree_util.tree_flatten_with_path(want)[0])


@pytest.mark.parametrize("pairs", [3, 9])
def test_train_equivalence(start, pairs):
    """Three masked merged steps, port against the JAX merged step: each
    loss within 1e-4; the zero blocks exactly 0 (JAX's too); the
    parameters and BatchNorm statistics, unmerged, within 1e-4 of JAX's
    unmerged ones. pairs = 9 merges the whole backbone, SPPF included."""
    v, data, tdata = start
    jcfg = jax_zoo.tiny_icafusion_config()
    mv = jsm.merge_stream_variables(jcfg, v, pairs=pairs)
    mtr = JaxTrainer(model=jax_build(jcfg, merge_pairs=pairs),
                     hyp=jax_hyp(), **KW)
    mst = mtr.init_state(jax.random.PRNGKey(0), data[0][:1], data[1][:1],
                         variables=mv)
    batch = [jnp.asarray(a) for a in data]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn, "Dropout", NoDropout)
        mstep = jax.jit(mtr.make_train_step(
            grad_mask=jsm.grad_mask(jcfg, mv["params"], pairs))).lower(
            mst, *batch).compile()
    want = []
    for _ in range(STEPS):
        mst, met = mstep(mst, *batch)
        want.append(float(met["loss"]))

    tr = _port_trainer(v, pairs)
    got, mask = _port_run(tr, pairs, tdata)
    print("losses port", got, "JAX", want)
    for a, b in zip(got, want):
        assert abs(a - b) < 1e-4
    _zero_blocks_exact(tr, mask)
    k0 = np.asarray(mst.params["m0_9"]["conv"]["kernel"])  # (6, 6, 6, 32)
    assert np.all(k0[:, :, 3:, :16] == 0) and np.all(k0[:, :, :3, 16:] == 0)

    up = sm.unmerge_train_state(tr.model.cfg, tr, pairs)
    assert up.model.merge_pairs == 0 and up.opt.step == STEPS
    jun = jsm.unmerge_stream_variables(
        jcfg, {"params": jax.device_get(mst.params),
               "batch_stats": jax.device_get(mst.batch_stats)}, pairs)
    sd = up.model.state_dict()
    d_params = _max_diff(jun["params"], flax_tree(up.model, sd))
    d_stats = _max_diff(jun["batch_stats"],
                        flax_tree(up.model, sd, "batch_stats"))
    print(f"unmerged params {d_params:.3g}, BatchNorm statistics "
          f"{d_stats:.3g} from JAX's")
    assert d_params <= 1e-4 and d_stats <= 1e-4


def test_merged_trainer_equals_unmerged(start):
    """Within the port, as JAX's test holds its own two graphs: three
    masked merged steps at k = 9 against three unmerged steps from the
    same state (losses within 1e-4, the unmerged state within 1e-4, the
    optimizer step and EMA count equal), and the gradient mask is exactly
    the block support."""
    v, _, tdata = start
    ref = _port_trainer(v, 0)
    want, _ = _port_run(ref, 0, tdata)
    tr = _port_trainer(v, 9)
    got, mask = _port_run(tr, 9, tdata)
    for a, b in zip(got, want):
        assert abs(a - b) < 1e-4
    m0 = mask["m0_9.conv.weight"]                     # (32, 6, 6, 6)
    assert m0[:16, :3].eq(1).all() and m0[16:, 3:].eq(1).all()
    assert m0[:16, 3:].eq(0).all() and m0[16:, :3].eq(0).all()
    assert not any(k.startswith("m20") for k in mask)
    up = sm.unmerge_train_state(tr.model.cfg, tr, 9, device="cpu")
    for name, t in ref.model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(up.model.state_dict()[name].numpy(),
                                       t.numpy(), atol=1e-4, err_msg=name)
    for name, t in ref.ema.tree.items():
        np.testing.assert_allclose(up.ema.tree[name].numpy(), t.numpy(),
                                   atol=1e-4, err_msg=name)
    assert (up.opt.step, up.ema.updates) == (ref.opt.step, ref.ema.updates)
    with pytest.raises(KeyError, match="grad_mask names no parameter"):
        ref.make_train_step(grad_mask=mask)
