"""icafusion_tpu_torch layers, config and weight loading against the JAX
package: the same numpy inputs and flax variables through both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.config import load_model_config as jax_load_model_config
from icafusion_tpu.models import assembler as jax_assembler
from icafusion_tpu.models import zoo as jax_zoo
from icafusion_tpu.nn import layers as jax_layers
from icafusion_tpu_torch.config import load_model_config
from icafusion_tpu_torch.models import assembler, zoo
from icafusion_tpu_torch.nn import layers
from icafusion_tpu_torch.utils.convert import load_jax_variables
from icafusion_tpu_torch.utils.general import check_img_size, make_divisible
from torch_port_common import nchw, nhwc, random_variables

torch.set_num_threads(1)

# (module, args): the configurations the serving path builds
LAYER_CASES = [
    ("Conv", (3, 16, 6, 2, 2)),      # stem
    ("Conv", (16, 32, 3, 2)),        # downsample
    ("Conv", (32, 24, 1, 1)),
    ("Bottleneck", (16, 16)),        # residual
    ("Bottleneck", (16, 24, False)),
    ("C3", (16, 32, 2)),
    ("C3", (32, 32, 1, False)),      # head C3, no shortcut
    ("SPPF", (32, 32, 5)),
    ("Focus", (3, 16, 3)),
]


@pytest.mark.parametrize("name,args", LAYER_CASES,
                         ids=[f"{n}{a}" for n, a in LAYER_CASES])
def test_layer_matches_flax(name, args):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 16, args[0])).astype(np.float32)
    jmod = getattr(jax_layers, name)(*args)
    v = random_variables(jmod, jnp.asarray(x), train=False)
    want = np.asarray(jmod.apply(v, jnp.asarray(x), train=False))
    mod = load_jax_variables(getattr(layers, name)(*args).eval(), v)
    with torch.no_grad():
        got = nhwc(mod(nchw(x)))
    # fp32; the two frameworks sum the convolutions in different orders
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_concat_and_upsample_match_flax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(2, 4, 6, 3)).astype(np.float32)
    b = rng.normal(size=(2, 4, 6, 5)).astype(np.float32)
    want = np.asarray(jax_layers.Concat(1)([jnp.asarray(a), jnp.asarray(b)]))
    got = nhwc(layers.Concat(1)([nchw(a), nchw(b)]))
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jax_layers.Upsample(None, 2, "nearest")(jnp.asarray(a)))
    got = nhwc(layers.Upsample(None, 2, "nearest")(nchw(a)))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        layers.Upsample(None, 1.5, "nearest")


def test_batchnorm_settings():
    bn = layers.Conv(3, 8).bn
    assert bn.eps == 1e-3 and bn.momentum == 0.03


def test_general_helpers():
    assert make_divisible(1024 * 0.25, 8) == 256
    assert make_divisible(100, 8) == 104
    assert check_img_size(640) == 640
    assert check_img_size(650, 32) == 672


def _resolved(layers_):
    return [(r.i, r.f, r.n, r.module, repr(r.args), r.c2) for r in layers_]


@pytest.mark.parametrize("which", ["tiny", "n", "l", "yaml"])
def test_resolve_model_matches_jax(which):
    if which == "tiny":
        cfgs = zoo.tiny_icafusion_config(), jax_zoo.tiny_icafusion_config()
    elif which == "yaml":
        cfgs = (load_model_config("yolov5l_Transfusion.yaml"),
                jax_load_model_config("yolov5l_Transfusion.yaml"))
    else:
        cfgs = (zoo.icafusion_config(which, nc=3, fusion="tfb"),
                jax_zoo.icafusion_config(which, nc=3, fusion="tfb"))
    mine, theirs = (m.resolve_model(c) for m, c in
                    zip((assembler, jax_assembler), cfgs))
    assert _resolved(mine[0]) == _resolved(theirs[0])
    assert mine[1] == theirs[1]


def test_unported_module_raises():
    """A module missing from the registry (the reference's Sum, which
    neither package registers) raises "not ported"; so does a fusion kind
    neither package has."""
    d = dict(nc=3, depth_multiple=1.0, width_multiple=1.0,
             anchors=list(zoo.COCO_ANCHORS),
             backbone=[[-1, 1, "Sum", [2]]], head=[])
    with pytest.raises(ValueError, match="not ported"):
        assembler.build_model(load_model_config(d))
    with pytest.raises(ValueError, match="unknown fusion kind"):
        zoo.icafusion_config("n", fusion="sum")


def test_load_jax_variables_is_strict():
    cfg = zoo.tiny_icafusion_config()
    jm = jax_assembler.build_model(jax_zoo.tiny_icafusion_config())
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    v = random_variables(jm, x, x, train=False)
    model = assembler.build_model(cfg)
    load_jax_variables(model, v)        # every tensor filled, no leaf unused
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["m0.conv.weight"].numpy(),
        v["params"]["m0"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["m18.crosstransformer0.crossatt.q_vis.weight"].numpy(),
        v["params"]["m18"]["crosstransformer0"]["crossatt"]["q_vis"]
        ["kernel"].T)
    np.testing.assert_array_equal(
        sd["m3.bn.running_var"].numpy(), v["batch_stats"]["m3"]["bn"]["var"])

    extra = jax.tree_util.tree_map(lambda a: a, v)
    extra["params"]["m0"]["conv"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="no port tensor"):
        load_jax_variables(assembler.build_model(cfg), extra)
    short = jax.tree_util.tree_map(lambda a: a, v)
    del short["batch_stats"]["m3"]
    with pytest.raises(KeyError, match="not filled"):
        load_jax_variables(assembler.build_model(cfg), short)
    with pytest.raises(KeyError, match="collections"):
        load_jax_variables(assembler.build_model(cfg), {**v, "calib": {}})


def test_model_is_inference_only():
    """The model is built for inference (eval mode, decoded output); since
    training is ported, train() switches it to Detect's raw maps per level
    and eval() back."""
    model = assembler.build_model(zoo.tiny_icafusion_config())
    assert not model.training
    x = torch.zeros(1, 3, 64, 64)
    with torch.no_grad():
        assert model(x, x).shape == (1, 3 * (64 + 16 + 4), 8)
        raw = model.train()(x, x)
        assert [tuple(r.shape) for r in raw] == [
            (1, 8, 8, 3, 8), (1, 4, 4, 3, 8), (1, 2, 2, 3, 8)]
        assert model.eval()(x, x).shape == (1, 252, 8)


def test_build_model_generator_is_deterministic():
    cfg = zoo.tiny_icafusion_config()
    a = assembler.build_model(cfg, generator=torch.Generator().manual_seed(3))
    b = assembler.build_model(cfg, generator=torch.Generator().manual_seed(3))
    for (k, ta), tb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(ta, tb), k
