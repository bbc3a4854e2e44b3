"""Checkpoints cross between icafusion_tpu_torch and the JAX package both
ways: the port's msgpack writer emits flax's bytes, the JAX package
restores a port train state, the port resumes a JAX train state and its
next step equals JAX's, and a stripped checkpoint of either loads in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from icafusion_tpu.config import load_hyp_config as jax_hyp
from icafusion_tpu.models import build_model as jax_build
from icafusion_tpu.models.zoo import tiny_icafusion_config as jax_tiny
from icafusion_tpu.train.trainer import Trainer as JaxTrainer
from icafusion_tpu.utils import checkpoint as jax_checkpoint
from icafusion_tpu_torch.config import load_hyp_config
from icafusion_tpu_torch.models.assembler import build_model, init_weights
from icafusion_tpu_torch.models.zoo import (icafusion_config,
                                            tiny_icafusion_config)
from icafusion_tpu_torch.train.trainer import Trainer
from icafusion_tpu_torch.utils import checkpoint
from icafusion_tpu_torch.utils.convert import (flax_tree, load_jax_variables,
                                               to_jax_variables)
from torch_port_common import nchw, tiny_trainers, train_batch

torch.set_num_threads(1)

LOSS_RTOL, STATE_ATOL = 1e-4, 1e-3   # as test_torch_port_trainer.py


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def test_writer_emits_flax_bytes():
    rng = np.random.default_rng(0)
    tree = {"params": {"m0": {"conv": {"kernel": rng.normal(
                size=(3, 3, 2, 4)).astype(np.float32)}},
                       "big": np.ones(70_000, np.float16)},
            "opt_step": 70_000, "neg": -3, "rng": np.array([0, 9], np.uint32),
            "meta": {"epoch": 4, "best_fitness": 0.25, "name": "x" * 40,
                     "flag": True}, "scalar": np.float32(1.5),
            "empty": {}, "zero_d": np.zeros((), np.float32)}
    data = checkpoint.msgpack_serialize(tree)
    assert data == serialization.msgpack_serialize(tree)
    _assert_trees_equal(checkpoint.msgpack_restore(data),
                        serialization.msgpack_restore(data))


def test_to_jax_variables_inverts_load_jax_variables():
    model = init_weights(build_model(icafusion_config("n")),
                         torch.Generator().manual_seed(1))
    v = to_jax_variables(model)
    again = to_jax_variables(load_jax_variables(
        build_model(icafusion_config("n")), v))
    _assert_trees_equal(v, again)
    assert v["params"]["m0"]["conv"]["kernel"].shape == (6, 6, 3, 16)
    assert v["params"]["m20"]["crosstransformer0"]["crossatt"]["q_vis"][
        "kernel"].shape == (64, 64)


@pytest.mark.parametrize("adam", [False, True])
def test_jax_restores_a_port_train_state(tmp_path, adam):
    """The port writes last.ckpt after two steps; the JAX package's
    load_checkpoint and restore_train_state take it into a fresh JAX state
    of the same model, every tree equal to the port's."""
    model = init_weights(build_model(tiny_icafusion_config()),
                         torch.Generator().manual_seed(2))
    tr = Trainer(model, load_hyp_config(), epochs=3, steps_per_epoch=1,
                 batch_size=2, imgsz=64, warmup_min_steps=2, adam=adam,
                 device="cpu")
    step = tr.make_train_step()
    rgb, ir, t, m = train_batch(2)
    for _ in range(2):
        step(nchw(rgb), nchw(ir), torch.from_numpy(t), torch.from_numpy(m))
    path = tmp_path / "last.ckpt"
    checkpoint.save_checkpoint(path, tr, epoch=1, best_fitness=0.5,
                               background=True)
    checkpoint.wait_pending_saves()
    jtr = JaxTrainer(model=jax_build(jax_tiny()), hyp=jax_hyp(), epochs=3,
                     steps_per_epoch=1, batch_size=2, imgsz=64, adam=adam)
    # the state's shapes and dtypes are all restore_train_state reads
    state = jax.eval_shape(lambda: jtr.init_state(jax.random.PRNGKey(0),
                                                  rgb[:1], ir[:1]))
    ckpt = jax_checkpoint.load_checkpoint(path)
    restored = jax_checkpoint.restore_train_state(ckpt, state)
    assert ckpt["meta"] == {"epoch": 1, "best_fitness": 0.5}
    sd = tr.model.state_dict()
    _assert_trees_equal(jax.device_get(restored.params),
                        flax_tree(tr.model, sd))
    _assert_trees_equal(jax.device_get(restored.batch_stats),
                        flax_tree(tr.model, sd, "batch_stats"))
    mom = (tr.opt.momentum if not adam else
           {k: tr.opt.momentum[k] for k in ("m", "v")})
    want_mom = (flax_tree(tr.model, mom) if not adam else
                {k: flax_tree(tr.model, v) for k, v in mom.items()})
    _assert_trees_equal(jax.device_get(restored.opt.momentum), want_mom)
    _assert_trees_equal(jax.device_get(restored.ema.tree)["params"],
                        flax_tree(tr.model, tr.ema.tree))
    assert int(restored.opt.step) == tr.opt.step == 2
    assert int(restored.ema.updates) == tr.ema.updates == 2


def test_port_resumes_a_jax_train_state_to_the_same_next_step(tmp_path):
    """JAX takes one step and writes its checkpoint; the port restores it
    into a Trainer of other weights; then both take the next step."""
    jtr, state, jstep, tr, _ = tiny_trainers(2)
    data = train_batch(2)
    state, _ = jstep(state, *(jnp.asarray(a) for a in data))
    path = tmp_path / "jax.ckpt"
    jax_checkpoint.save_checkpoint(path, state, epoch=0, best_fitness=0.1)
    init_weights(tr.model, torch.Generator().manual_seed(3))
    checkpoint.restore_train_state(checkpoint.load_checkpoint(path), tr)
    assert tr.opt.step == 1 and tr.ema.updates == 1
    state, want = jstep(state, *(jnp.asarray(a) for a in data))
    got = tr.make_train_step()(nchw(data[0]), nchw(data[1]),
                               torch.from_numpy(data[2]),
                               torch.from_numpy(data[3]))
    for k in ("loss", "lbox", "lobj", "lcls"):
        assert float(got[k]) == pytest.approx(float(want[k]),
                                              rel=LOSS_RTOL), k
    assert float(got["lr"]) == pytest.approx(float(want["lr"]), rel=1e-6)
    got_p = _leaves(flax_tree(tr.model, tr.model.state_dict()))
    for k, w in _leaves(jax.device_get(state.params)).items():
        assert np.abs(got_p[k] - w).max() <= STATE_ATOL, k


def test_stripped_checkpoints_load_in_both(tmp_path):
    """strip_checkpoint of the port and of the JAX package, each read by
    both packages' load_inference_variables: the EMA tree in float16."""
    model = init_weights(build_model(tiny_icafusion_config()),
                         torch.Generator().manual_seed(4))
    tr = Trainer(model, load_hyp_config(), epochs=1, steps_per_epoch=1,
                 batch_size=2, imgsz=64, device="cpu")
    full = tmp_path / "best.ckpt"
    checkpoint.save_checkpoint(full, tr, epoch=0, best_fitness=0.3)
    ours, theirs = tmp_path / "ours.ckpt", tmp_path / "theirs.ckpt"
    checkpoint.strip_checkpoint(full, ours)
    jax_checkpoint.strip_checkpoint(full, theirs)
    assert ours.read_bytes() == theirs.read_bytes()
    want = {"params": flax_tree(tr.model, tr.ema.tree),
            "batch_stats": flax_tree(tr.model, tr.ema.tree, "batch_stats")}
    want = jax.tree.map(lambda a: a.astype(np.float16).astype(np.float32),
                        want)
    for loader in (checkpoint.load_inference_variables,
                   jax_checkpoint.load_inference_variables):
        _assert_trees_equal(loader(str(ours)), want)
    load_jax_variables(build_model(tiny_icafusion_config()),
                       checkpoint.load_inference_variables(ours))
