"""The long tail of the YAML registry in icafusion_tpu_torch against the JAX
package: each of the 17 modules no shipped config uses (DWConv,
BottleneckCSP, C3TR, SPP, Contract, Expand, MaxPool2d, BatchNorm2d,
CrossConv, GhostConv, GhostBottleneck, MixConv2d, SE_Block,
Channel_Attention, Spatial_Attention, CBAM, Classify), repeated rows, and
the kitchen-sink graph that holds them all (the JAX package's
tests/test_onnx_export.py graph, whose copy phase 13c of chip_smoke.py
serves: smoke/reference.kitchen_sink_yaml), with the same numpy inputs and
flax variables through both.

MixConv2d sizes its convs from a jnp.linspace, which flax cannot trace; the
JAX side runs under jax.ensure_compile_time_eval so that it stays concrete
inside eval_shape and jit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.config import load_model_config as jax_load_model_config
from icafusion_tpu.models import assembler as jax_assembler
from icafusion_tpu.models.zoo import COCO_ANCHORS
from icafusion_tpu_torch.config import load_model_config
from icafusion_tpu_torch.models import assembler
from icafusion_tpu_torch.nn import layers
from icafusion_tpu_torch.smoke.reference import kitchen_sink_yaml
from icafusion_tpu_torch.utils.convert import (flax_tree, load_jax_variables,
                                               to_jax_variables)
from torch_port_common import nchw, nhwc, random_variables

torch.set_num_threads(1)

# fp32 throughout; the frameworks sum convolutions and reductions in
# different orders
RTOL = ATOL = 1e-4

# (registry name, resolved args as the assembler hands them, input channels)
LEGACY_CASES = [
    ("DWConv", (32, 64, 3, 2), 32),
    ("BottleneckCSP", (32, 32, 2), 32),
    ("BottleneckCSP", (32, 48, 1, False), 32),
    ("C3TR", (32, 32, 1), 32),
    ("SPP", (32, 48, [5, 9, 13]), 32),
    ("Contract", (2,), 8),
    ("Expand", (2,), 32),
    ("MaxPool2d", (2, 2), 8),
    ("MaxPool2d", (3, 1), 8),
    ("BatchNorm2d", (16,), 16),
    ("CrossConv", (32, 32, 3, 2), 32),
    ("CrossConv", (32, 32, 3, 1, 1, 1.0, True), 32),
    ("GhostConv", (32, 32, 3, 2), 32),
    ("GhostBottleneck", (32, 48, 3, 2), 32),
    ("GhostBottleneck", (32, 32, 3, 1), 32),
    ("MixConv2d", (32, 32, [1, 3], 1), 32),
    ("MixConv2d", (30, 30, [1, 3, 5], 1), 30),
    ("SE_Block", (32, 8), 32),
    ("Channel_Attention", (32, 8), 32),
    ("Spatial_Attention", (7,), 16),
    ("CBAM", (32,), 32),
    ("Classify", (32, 10), 32),
    ("Classify", (32, 10, 3, 1, 2), 32),
]


def _jax_module(name, args):
    return jax_assembler.MODULE_BUILDERS[name](tuple(args), jnp.float32, None)


def _variables(jmod, x):
    with jax.ensure_compile_time_eval():
        return random_variables(jmod, jnp.asarray(x), train=False)


def _as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_close(got, want, rtol=RTOL, atol=ATOL, of_max=0.0):
    """Leaf by leaf; of_max adds that share of the leaf's largest |value|
    to atol."""
    g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert g.keys() == w.keys()
    for k in w:
        want_k = np.asarray(w[k])
        np.testing.assert_allclose(
            np.asarray(g[k]), want_k, rtol=rtol,
            atol=atol + of_max * float(np.abs(want_k).max()), err_msg=str(k))


def test_registry_has_every_jax_name():
    assert set(assembler.MODULE_BUILDERS) - {"Detect"} == set(
        jax_assembler.MODULE_BUILDERS)
    assert assembler._CONV_LIKE == jax_assembler._CONV_LIKE
    assert assembler._ABSORB_N == jax_assembler._ABSORB_N


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name,args,c1", LEGACY_CASES,
                         ids=[f"{n}{a}" for n, a, _ in LEGACY_CASES])
def test_legacy_module_matches_flax(name, args, c1, train):
    """Output, and in train mode the BatchNorm statistics it leaves, equal
    flax's; the variables load strictly and to_jax_variables gives them
    back unchanged."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 16, c1)).astype(np.float32)
    jmod = _jax_module(name, args)
    v = _variables(jmod, x)
    with jax.ensure_compile_time_eval():
        if train:
            want, upd = jmod.apply(v, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
        else:
            want, upd = jmod.apply(v, jnp.asarray(x), train=False), {}
    mod = load_jax_variables(assembler.MODULE_BUILDERS[name](tuple(args)), v)
    back = to_jax_variables(mod)
    _assert_trees_close(back, _as_numpy(v), rtol=0, atol=0)
    mod.train(train)
    with torch.no_grad():
        got = mod(nchw(x))
    got = got.numpy() if got.ndim == 2 else nhwc(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    if upd:
        _assert_trees_close(to_jax_variables(mod)["batch_stats"],
                            _as_numpy(upd["batch_stats"]))


def test_grouped_conv_is_never_fused(monkeypatch):
    """A grouped 64 -> 64 3x3 Conv (a DWConv, GhostConv's 5x5 depthwise
    half) runs cuDNN's grouped conv in eval mode, never the fused 64-channel
    kernel; the ungrouped one does."""
    calls = []
    real = layers.conv3x3_bn_silu
    monkeypatch.setattr(layers, "conv3x3_bn_silu",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.randn(1, 64, 8, 8)
    for mod in (layers.Conv(64, 64, 3, 1, g=64), layers.DWConv(64, 64, 3, 1),
                layers.Conv(64, 64, 3, 1, g=2)):
        assert not mod.fused
        with torch.no_grad():
            mod.eval()(x)
    assert not calls
    with torch.no_grad():
        layers.Conv(64, 64, 3, 1).eval()(x)
    assert calls == [1]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("module,args,n", [
    ("Conv", (32, 32, 3, 1), 2),
    ("GhostBottleneck", (32, 32, 3, 1), 3),
    ("MixConv2d", (32, 32, [1, 3], 1), 2)])
def test_repeat_matches_flax(module, args, n, train):
    """A repeated row that does not take n itself: n copies r0.. in turn."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    jmod = jax_assembler._Repeat(module, tuple(args), n)
    v = _variables(jmod, x)
    assert set(v["params"]) == {f"r{j}" for j in range(n)}
    with jax.ensure_compile_time_eval():
        want = jmod.apply(v, jnp.asarray(x), train=train,
                          mutable=["batch_stats"] if train else False)
    want = want[0] if train else want
    mod = load_jax_variables(assembler.Repeat(module, tuple(args), n), v)
    with torch.no_grad():
        got = nhwc(mod.train(train)(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_seeded_weights_depend_on_the_seed_alone():
    """build_model(generator=) and init_weights draw every parameter of the
    legacy modules from the generator, C3TR's attention heads included:
    the same seed gives the same weights whatever the global RNG did, and
    init_weights' flax-default layers have lecun normal's spread (std
    sqrt(1 / fan_in), within 10 %) and zero biases."""
    cfg = load_model_config(kitchen_sink_yaml())
    sds = []
    for seed, noise in ((0, 1), (0, 2), (1, 1)):
        torch.manual_seed(noise)
        sds.append(assembler.build_model(
            cfg, generator=torch.Generator().manual_seed(seed)).state_dict())
        torch.manual_seed(noise)
        sds.append(assembler.init_weights(
            assembler.build_model(cfg),
            torch.Generator().manual_seed(seed)).state_dict())
    key = "m9.m.tr0.ma.query.kernel"
    for a, b in ((sds[0], sds[2]), (sds[1], sds[3])):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(sds[0][key], sds[4][key])
    init = sds[1]
    for k, fan_in in ((key, 24), ("m9.m.tr0.ma.out.kernel", 24),
                      ("m9.m.tr0.q.weight", 24), ("m2.m1.weight", 32 * 9)):
        std = float(init[k].std())
        assert abs(std * np.sqrt(fan_in) - 1) < 0.1, (k, std)
    assert not init["m9.m.tr0.ma.query.bias"].any()
    assert not init["m9.m.linear.bias"].any()


def repeated_rows():
    """Rows repeated n > 1 times: absorbed by BottleneckCSP and C3TR,
    wrapped in a Repeat for Conv, GhostBottleneck and SPP; depth 0.67
    scales every n."""
    tower = lambda f: [
        [f, 1, "Focus", [16, 3]],                 # 32^2 c16
        [-1, 3, "Conv", [16, 3, 1]],
        [-1, 1, "DWConv", [32, 3, 2]],            # 16^2 c32
        [-1, 3, "BottleneckCSP", [32]],
        [-1, 1, "Conv", [64, 3, 2]],              # 8^2 c64
        [-1, 3, "C3TR", [64]],
        [-1, 3, "GhostBottleneck", [64, 3, 1]],
        [-1, 1, "Conv", [64, 3, 2]],              # 4^2 c64
        [-1, 3, "SPP", [64, [3, 5]]],
    ]
    rows = tower(-1) + tower(-4)
    rows += [
        [[6, 15], 1, "Add", [1]],                 # 18: P3/8
        [[8, 17], 1, "Add", [1]],                 # 19: P4/16
        [-1, 1, "MaxPool2d", [2, 2]],             # 20: P5/32
        [[18, 19, 20], 1, "Detect", ["nc", "anchors"]],
    ]
    return dict(nc=2, depth_multiple=0.67, width_multiple=1.0,
                anchors=list(COCO_ANCHORS), backbone=rows[:18],
                head=rows[18:], name="repeated")


def _resolved(layers_):
    return [(r.i, r.f, r.n, r.module, repr(r.args), r.c2) for r in layers_]


@pytest.mark.parametrize("graph", [kitchen_sink_yaml, repeated_rows],
                         ids=["kitchen_sink", "repeated_rows"])
def test_resolve_model_matches_jax(graph):
    """Channel rules (Contract, Expand, BatchNorm2d, the conv-like modules),
    absorbed and wrapped repeats: the resolved rows equal JAX's."""
    mine = assembler.resolve_model(load_model_config(graph()))
    theirs = jax_assembler.resolve_model(jax_load_model_config(graph()))
    assert _resolved(mine[0]) == _resolved(theirs[0])
    assert mine[1] == theirs[1]


def _grad_scale(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("graph", [kitchen_sink_yaml, repeated_rows],
                         ids=["kitchen_sink", "repeated_rows"])
def test_graph_forward_and_gradient_match_jax(graph):
    """End to end at 64 px: eval-mode decoded predictions, then one
    train-mode forward and the gradient of a fixed linear function of its
    raw maps with respect to every parameter, each against one jit of the
    JAX apply."""
    cfg = jax_load_model_config(graph())
    jm = jax_assembler.build_model(cfg)
    rng = np.random.default_rng(5)
    rgb, ir = (rng.random((2, 64, 64, 3), np.float32) for _ in range(2))
    x, y = jnp.asarray(rgb), jnp.asarray(ir)
    with jax.ensure_compile_time_eval():
        v = random_variables(jm, x, y, train=False)
    weights = None

    def run(params, stats):
        pred, _, _ = jm.apply({"params": params, "batch_stats": stats}, x, y,
                              train=False, decode=True)
        maps = jm.apply({"params": params, "batch_stats": stats}, x, y,
                        train=True, mutable=["batch_stats"])[0]
        return pred, maps

    def loss(params, stats):
        maps = jm.apply({"params": params, "batch_stats": stats}, x, y,
                        train=True, mutable=["batch_stats"])[0]
        return sum(jnp.sum(m * w) for m, w in zip(maps, weights))

    with jax.ensure_compile_time_eval():
        shapes = jax.eval_shape(run, v["params"], v["batch_stats"])[1]
        weights = [_grad_scale(s.shape, 6 + i) for i, s in enumerate(shapes)]
        pred, grads = jax.jit(lambda p, s: (run(p, s)[0],
                                            jax.grad(loss)(p, s)))(
            v["params"], v["batch_stats"])

    model = load_jax_variables(
        assembler.build_model(load_model_config(graph())), v)
    with torch.no_grad():
        got = model(nchw(rgb), nchw(ir))
    np.testing.assert_allclose(got.numpy(), np.asarray(pred), rtol=1e-3,
                               atol=1e-3)
    model.train()
    maps = model(nchw(rgb), nchw(ir))
    sum((m * torch.from_numpy(w)).sum() for m, w in zip(maps, weights)
        ).backward()
    g = flax_tree(model, {n: p.grad for n, p in model.named_parameters()})
    # gradients through train-mode BatchNorm and attention softmaxes: the
    # summation-order differences of the forward grow through the backward,
    # and entries that cancel to near zero keep the error of the large ones
    # (up to 6e-5 of a kernel's largest gradient, measured)
    _assert_trees_close(g, _as_numpy(grads), rtol=2e-3, atol=2e-3,
                        of_max=2e-4)
