"""The training pieces of icafusion_tpu_torch against the JAX package's:
schedules, parameter groups and freezing, the SGD and Adam updates, EMA,
BatchNorm in train mode, the max-pool gradient on ties, the fusion block in
train mode, dropout and init_weights."""

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
from jax.tree_util import DictKey

from icafusion_tpu.config import load_hyp_config as jax_hyp
from icafusion_tpu.models import build_model as jax_build
from icafusion_tpu.models.zoo import icafusion_config as jax_icafusion
from icafusion_tpu.models.zoo import tiny_icafusion_config as jax_tiny
from icafusion_tpu.nn import fusion as jax_fusion
from icafusion_tpu.nn import layers as jax_layers
from icafusion_tpu.train import ema as jax_ema
from icafusion_tpu.train import optim as jax_optim
from icafusion_tpu_torch.config import load_hyp_config
from icafusion_tpu_torch.models.assembler import build_model, init_weights
from icafusion_tpu_torch.models.zoo import (icafusion_config,
                                            tiny_icafusion_config)
from icafusion_tpu_torch.nn import fusion, layers
from icafusion_tpu_torch.train import ema, optim
from icafusion_tpu_torch.utils.convert import flax_paths, load_jax_variables
from torch_port_common import nchw, nhwc, random_variables

torch.set_num_threads(1)


class _NoDropout:
    """Stands in for flax.linen.Dropout inside a test: identity."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, x, *args, **kwargs):
        return x


def _dictkeys(path):
    return tuple(DictKey(k) for k in path)


@pytest.mark.parametrize("linear_lr", [False, True])
def test_schedules_match_jax(linear_lr):
    kw = dict(epochs=60, steps_per_epoch=100, total_batch_size=16,
              warmup_min_steps=1000, linear_lr=linear_lr)
    want = jax_optim.YoloSGD(hyp=jax_hyp(), **kw)
    got = optim.YoloSGD(hyp=load_hyp_config(), **kw)
    assert got.warmup_steps == want.warmup_steps == 1000
    assert got.weight_decay == pytest.approx(want.weight_decay, rel=1e-12)
    for step in (0, 1, 7, 500, 999, 1000, 1001, 2950, 3000, 5999, 6000):
        (wl, wm) = want.schedules(jnp.asarray(step, jnp.int32))
        gl, gm = got.schedules(step)
        np.testing.assert_allclose(gl, [float(x) for x in wl], rtol=1e-6,
                                   atol=1e-12, err_msg=str(step))
        assert gm == pytest.approx(float(wm), rel=1e-6)


@pytest.mark.parametrize("scale", ["tiny", "l"])
def test_param_groups_match_jax_on_flax_paths(scale):
    """Every parameter's flax path (from the port's conversion table) is a
    path of the JAX model, and its group is the JAX group of that path."""
    if scale == "tiny":
        port, jm = (build_model(tiny_icafusion_config()),
                    jax_build(jax_tiny()))
    else:
        port, jm = build_model(icafusion_config("l")), jax_build(
            jax_icafusion("l"))
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, x))
    jax_paths = {tuple(k.key for k in p): jax_optim.param_group(p)
                 for p, _ in jax.tree_util.tree_flatten_with_path(
                     shapes["params"])[0]}
    ours = {p: optim.param_group(p) for c, p in flax_paths(port).values()
            if c == "params"}
    assert set(ours) == set(jax_paths)
    assert ours == jax_paths
    assert {n: g for n, g in ours.items() if n[-1] == "scale"} and \
        {g for n, g in ours.items() if n[-1] == "scale"} == {0, 1}


def test_freeze_matches_jax_and_keeps_its_overmatch():
    """Substring and leading-slash freezing as in the JAX package, including
    '/m2' freezing '/m23/...' too (ROADMAP Queue C)."""
    paths = [("m0", "conv", "kernel"), ("m2", "cv1", "conv", "kernel"),
             ("m23", "cv3", "bn", "scale"), ("m12", "m0", "cv1", "conv",
                                             "kernel"),
             ("m1", "bn", "bias")]
    for freeze in (("m0",), ("/m0/",), ("/m2",), ("/m2/",), ("bn",),
                   ("m23/cv3",), ()):
        for p in paths:
            assert optim._is_frozen(p, freeze) == jax_optim._is_frozen(
                _dictkeys(p), freeze), (p, freeze)
    assert optim._is_frozen(("m23", "cv3", "bn", "scale"), ("/m2",))
    assert not optim._is_frozen(("m23", "cv3", "bn", "scale"), ("/m2/",))


def _random_tree(seed):
    """Port name -> (flax path, array) over every group and the unrouted
    and frozen kinds."""
    rng = np.random.default_rng(seed)
    spec = [(("m0", "conv", "kernel"), (3, 3, 4, 8)),
            (("m0", "bn", "scale"), (8,)), (("m0", "bn", "bias"), (8,)),
            (("m20", "crosstransformer0", "coefficients"), (8,)),
            (("m20", "crosstransformer0", "mlp_ln", "scale"), (16,)),
            (("m20", "pos_emb_vis"), (1, 4, 16)),
            (("m20", "vis_coefficient", "w1"), (1,)),
            (("m23", "cv1", "conv", "kernel"), (1, 1, 8, 8)),
            (("m24", "m0", "bias"), (24,))]
    return {".".join(p): (p, rng.normal(0, 1, s).astype(np.float32))
            for p, s in spec}


def _nest(items):
    out = {}
    for p, a in items:
        d = out
        for k in p[:-1]:
            d = d.setdefault(k, {})
        d[p[-1]] = a
    return out


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("freeze", [(), ("/m23/",)])
def test_optimizer_updates_match_jax(adam, freeze):
    """Seven steps through warmup (warmup_min_steps 4, one epoch of 3
    steps) on a random tree with random gradients: the port's in-place
    foreach updates against the JAX update, rtol 1e-6."""
    kw = dict(epochs=4, steps_per_epoch=3, total_batch_size=16,
              warmup_min_steps=4, freeze=freeze)
    cls_j, cls_t = ((jax_optim.YoloAdam, optim.YoloAdam) if adam
                    else (jax_optim.YoloSGD, optim.YoloSGD))
    jopt, topt = cls_j(hyp=jax_hyp(), **kw), cls_t(hyp=load_hyp_config(),
                                                   **kw)
    tree = _random_tree(0)
    paths = {n: p for n, (p, _) in tree.items()}
    params = {n: torch.from_numpy(a.copy()) for n, (_, a) in tree.items()}
    jparams = jax.tree.map(jnp.asarray, _nest(tree.values()))
    jstate, tstate = jopt.init(jparams), topt.init(params)
    update = jax.jit(jopt.update)
    rng = np.random.default_rng(1)
    for _ in range(7):
        grads = {n: rng.normal(0, 1, a.shape).astype(np.float32)
                 for n, (_, a) in tree.items()}
        jparams, jstate = update(
            jax.tree.map(jnp.asarray, _nest((paths[n], g)
                                            for n, g in grads.items())),
            jstate, jparams)
        topt.update(params, {n: torch.from_numpy(g)
                             for n, g in grads.items()}, tstate, paths)
    assert tstate.step == int(jstate.step) == 7
    for n, p in params.items():
        want = jparams
        for k in paths[n]:
            want = want[k]
        np.testing.assert_allclose(p.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
        if freeze and optim._is_frozen(paths[n], freeze):
            np.testing.assert_array_equal(p.numpy(), tree[n][1])


def test_ema_matches_jax():
    rng = np.random.default_rng(2)
    names = ("a", "b")
    vals = [{n: rng.normal(0, 1, (5, 3)).astype(np.float32) for n in names}
            for _ in range(6)]
    js = jax_ema.ema_init(jax.tree.map(jnp.asarray, vals[0]))
    ts = ema.ema_init({n: torch.from_numpy(v) for n, v in vals[0].items()})
    for v in vals[1:]:
        js = jax_ema.ema_update(js, jax.tree.map(jnp.asarray, v))
        ema.ema_update(ts, {n: torch.from_numpy(x) for n, x in v.items()})
    assert ts.updates == int(js.updates) == 5
    for n in names:
        np.testing.assert_allclose(ts.tree[n].numpy(),
                                   np.asarray(js.tree[n]), rtol=1e-6,
                                   atol=1e-7)


def test_batchnorm_train_forward_and_running_stats_match_flax():
    """Conv + BatchNorm + SiLU in train mode: the output and the updated
    statistics against flax. The running variance takes the biased batch
    variance, as flax's does: at P5 of 2 x 64 px (8 values a channel)
    torch's unbiased one would be 8/7 of it."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 2, 2, 16)).astype(np.float32)
    jm = jax_layers.Conv(16, 24, 3, 1)
    v = random_variables(jm, jnp.asarray(x))
    want, mut = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    mod = load_jax_variables(layers.Conv(16, 24, 3, 1), v).train()
    got = mod(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    bs = mut["batch_stats"]["bn"]
    np.testing.assert_allclose(mod.bn.running_mean.numpy(),
                               np.asarray(bs["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mod.bn.running_var.numpy(),
                               np.asarray(bs["var"]), rtol=1e-5, atol=1e-6)
    conv = torch.nn.functional.conv2d(nchw(x), mod.conv.weight,
                                      padding=1).double()
    biased = conv.var((0, 2, 3), unbiased=False).detach().numpy()
    old = v["batch_stats"]["bn"]["var"].astype(np.float64)
    np.testing.assert_allclose(mod.bn.running_var.numpy(),
                               0.97 * old + 0.03 * biased, rtol=1e-5)


def test_sppf_pool_gradient_on_ties_matches_jax_vjp():
    """Chained 5x5 pools on integer data (systematic ties): the gradient
    equals the JAX package's first-winner custom VJP exactly."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 4, (2, 12, 9, 8)).astype(np.float32)
    ws = [rng.integers(-3, 4, x.shape).astype(np.float32) for _ in range(4)]
    pool = jax_layers._max_pool_same

    def f(a):
        ys = [a, pool(a, 5)]
        ys += [pool(ys[-1], 5)]
        ys += [pool(ys[-1], 5)]
        return sum((y * jnp.asarray(w)).sum() for y, w in zip(ys, ws))

    want = np.asarray(jax.grad(f)(jnp.asarray(x)))
    xt = nchw(x).requires_grad_()
    ys = [xt]
    for _ in range(3):
        ys.append(torch.nn.functional.max_pool2d(ys[-1], 5, 1, 2))
    sum((y * nchw(w)).sum() for y, w in zip(ys, ws)).backward()
    np.testing.assert_array_equal(nhwc(xt.grad), want)


def test_sppf_module_gradient_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 3, (2, 6, 6, 8)).astype(np.float32)
    jm = jax_layers.SPPF(8, 16)
    v = random_variables(jm, jnp.asarray(x))
    g = rng.normal(0, 1, (2, 6, 6, 16)).astype(np.float32)
    want = jax.grad(lambda a: (jm.apply(v, a, train=True,
                                        mutable=["batch_stats"])[0]
                               * g).sum())(jnp.asarray(x))
    mod = load_jax_variables(layers.SPPF(8, 16), v).train()
    xt = nchw(x).requires_grad_()
    (mod(xt) * nchw(g)).sum().backward()
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("hw,grid", [((8, 8), (4, 4)), ((10, 10), (4, 4)),
                                     ((2, 2), (2, 2))])
def test_fusion_block_train_forward_matches_jax(monkeypatch, hw, grid):
    """TransformerFusionBlock in train mode, dropout off on both sides:
    the einsum attention, the nearest up-resize (10 from 4 is not a whole
    ratio) and the batch-statistics BatchNorm of its 1x1 conv."""
    monkeypatch.setattr(flax_nn, "Dropout", _NoDropout)
    rng = np.random.default_rng(6)
    xs = [rng.normal(size=(2, *hw, 32)).astype(np.float32) for _ in range(2)]
    jm = jax_fusion.TransformerFusionBlock(32, *grid)
    v = random_variables(jm, [jnp.asarray(a) for a in xs])
    want, _ = jm.apply(v, [jnp.asarray(a) for a in xs], train=True,
                       mutable=["batch_stats"])
    mod = load_jax_variables(fusion.TransformerFusionBlock(32, *grid), v)
    for m in mod.modules():
        if isinstance(m, fusion.Dropout):
            m.p = 0.0
    got = mod.train()([nchw(a) for a in xs])
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_nearest_indices_match_torch_nearest():
    for n_in, n_out in ((4, 10), (16, 40), (20, 80), (2, 2), (5, 3)):
        x = torch.arange(n_in, dtype=torch.float32)[None, None, :, None]
        want = torch.nn.functional.interpolate(x, size=(n_out, 1),
                                               mode="nearest")
        np.testing.assert_array_equal(
            fusion.nearest_indices(n_in, n_out), want.flatten().long())


def test_dropout_semantics_match_flax():
    """A share p zeroed, the rest scaled by 1 / (1 - p) (flax's nn.Dropout);
    identity in eval mode; the mask follows the generator."""
    d = fusion.Dropout(0.3).train()
    d.generator = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = d(x)
    kept = y != 0
    assert abs(1 - kept.float().mean().item() - 0.3) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    d.generator = torch.Generator().manual_seed(0)
    assert torch.equal(d(x), y)
    assert torch.equal(d.eval()(x), x)
    want = flax_nn.Dropout(0.3, deterministic=False).apply(
        {}, jnp.ones(200_000), rngs={"dropout": jax.random.PRNGKey(0)})
    w = np.asarray(want)
    assert abs((w == 0).mean() - 0.3) < 0.005
    np.testing.assert_allclose(w[w != 0], 1 / 0.7, rtol=1e-6)


def test_init_weights_statistics_match_jax_init():
    """init_weights draws from the JAX initialisers' distributions: per
    tensor, the same constants where they are constant, and mean and
    standard deviation within sampling error elsewhere (bit equality is
    impossible across generators)."""
    x = jnp.zeros((1, 64, 64, 3))
    jv = jax.jit(jax_build(jax_tiny()).init)(jax.random.PRNGKey(0), x, x)
    want = {}
    for coll in ("params", "batch_stats"):
        for p, a in jax.tree_util.tree_flatten_with_path(jv[coll])[0]:
            want[(coll, tuple(k.key for k in p))] = np.asarray(a)
    model = init_weights(build_model(tiny_icafusion_config()),
                         torch.Generator().manual_seed(0))
    sd = model.state_dict()
    for name, key in flax_paths(model).items():
        w, g = want[key], sd[name].numpy()
        assert w.size == g.size, name
        if w.std() == 0:
            np.testing.assert_array_equal(g.ravel(), np.full(g.size,
                                                             w.ravel()[0]))
            continue
        assert g.std() > 0, name
        n = w.size
        tol = 5 * w.std() / np.sqrt(n)
        assert abs(g.mean() - w.mean()) < 2 * tol, name
        if n >= 64:
            assert abs(g.std() / w.std() - 1) < 6 / np.sqrt(n) + 0.02, name
