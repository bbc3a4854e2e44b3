"""icafusion_tpu_torch's VGG16 and ResNet50 towers against the JAX
package: each block against flax in eval and train mode, narrow two-stream
VGG16 (with TransformerFusionBlocks) and ResNet50 (with NiNfusion) detectors
end to end, their weights both ways, and the optimizer's groups on their
names."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.config import load_model_config as jax_load_model_config
from icafusion_tpu.models import zoo as jax_zoo
from icafusion_tpu.models.assembler import build_model as jax_build_model
from icafusion_tpu.nn import backbones as jax_backbones
from icafusion_tpu.train.optim import param_group as jax_param_group
from icafusion_tpu_torch.config import load_model_config
from icafusion_tpu_torch.models.assembler import (ICAFusionModel, build_model,
                                                  init_weights)
from icafusion_tpu_torch.nn import backbones, layers
from icafusion_tpu_torch.train.optim import param_group
from icafusion_tpu_torch.utils.convert import (flax_paths, load_jax_variables,
                                               to_jax_variables)
from torch_port_common import nchw, nhwc, random_variables

torch.set_num_threads(1)

# (module, args, input (H, W, C)): VGG blocks of two and three convs, a
# bottleneck with and without its shortcut conv, a stride-2 bottleneck,
# the stem (odd size: the -inf padded pool) and a stage of two blocks
BLOCK_CASES = [
    ("VGGblock", (2, 3, 8), (10, 12, 3)),
    ("VGGblock", (3, 8, 16), (9, 8, 8)),
    ("ResNetblock", (32, 8, 1), (6, 6, 32)),        # identity shortcut
    ("ResNetblock", (16, 8, 1), (6, 6, 16)),        # width changes
    ("ResNetblock", (16, 8, 2), (7, 6, 16)),        # stride 2
    ("ResNetlayer", (3, 8, 1, True, 1), (13, 10, 3)),
    ("ResNetlayer", (16, 8, 2, False, 2), (8, 8, 16)),
]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name,args,hwc", BLOCK_CASES,
                         ids=[f"{n}{a}" for n, a, _ in BLOCK_CASES])
def test_block_matches_flax(name, args, hwc, train):
    """Output, and in train mode every updated BatchNorm statistic."""
    x = np.random.default_rng(1).normal(size=(2, *hwc)).astype(np.float32)
    jm = getattr(jax_backbones, name)(*args)
    v = random_variables(jm, jnp.asarray(x), train=False)
    mod = load_jax_variables(getattr(backbones, name)(*args), v).train(train)
    if train:
        want, mut = jm.apply(v, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    else:
        want, mut = jm.apply(v, jnp.asarray(x), train=False), {}
    with torch.no_grad():
        got = nhwc(mod(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    if mut:
        stats = to_jax_variables(mod)["batch_stats"]
        flat = jax.tree_util.tree_leaves_with_path(mut["batch_stats"])
        assert flat
        for path, arr in flat:
            leaf = stats
            for k in path:
                leaf = leaf[k.key]
            np.testing.assert_allclose(leaf, np.asarray(arr), rtol=1e-4,
                                       atol=1e-5)


def test_tower_convs_stay_off_the_fused_kernel():
    """The towers' 3x3 64 -> 64 convs end in ReLU (VGG's with a bias), so
    they are plain convs, never the port's SiLU ``Conv``."""
    for mod in (backbones.VGGblock(2, 64, 64),
                backbones.ResNetlayer(64, 64, 1, False, 3)):
        assert not any(isinstance(m, layers.Conv) for m in mod.modules())
        assert any(isinstance(m, torch.nn.Conv2d)
                   and m.weight.shape == (64, 64, 3, 3) for m in mod.modules())
    assert backbones.VGGblock(2, 64, 64).conv1.bias is not None


def _narrow(kind):
    """Narrow two-stream configs of the zoo's VGG16 and ResNet50 graphs
    (the JAX zoo's fusion rows and PANet head): VGG16 with
    TransformerFusionBlocks at grids 4x4, 4x4, 2x2, ResNet50 with
    NiNfusion."""
    if kind == "vgg16":
        tower = lambda f: [
            [f, 1, "VGGblock", [2, 3, 8]],
            [-1, 1, "VGGblock", [2, 8, 16]],
            [-1, 1, "VGGblock", [3, 16, 16]],      # P3/8
            [-1, 1, "VGGblock", [3, 16, 24]],      # P4/16
            [-1, 1, "VGGblock", [3, 24, 32]],      # P5/32
        ]
        fused = [[[2, 7], 1, "TransformerFusionBlock", [16, 4, 4]],
                 [[3, 8], 1, "TransformerFusionBlock", [24, 4, 4]],
                 [[4, 9], 1, "TransformerFusionBlock", [32, 2, 2]]]
        head = jax_zoo._panet_head(10, 11, 12, widths=(32, 16), p5_out=32)
    else:
        tower = lambda f: [
            [f, 1, "ResNetlayer", [3, 8, 1, "True", 1]],
            [-1, 1, "ResNetlayer", [8, 8, 1, "False", 1]],
            [-1, 1, "ResNetlayer", [32, 8, 2, "False", 2]],    # P3/8
            [-1, 1, "ResNetlayer", [32, 16, 2, "False", 1]],   # P4/16
            [-1, 1, "ResNetlayer", [64, 16, 2, "False", 1]],   # P5/32
        ]
        fused = jax_zoo._fusion_rows("nin", [(2, 7), (3, 8), (4, 9)],
                                     [32, 64, 64])
        head = jax_zoo._panet_head(10, 11, 12, widths=(32, 16))
    rows = tower(-1) + tower(-4) + fused + head
    d = dict(nc=3, depth_multiple=1.0, width_multiple=1.0,
             anchors=list(jax_zoo.COCO_ANCHORS), backbone=rows[:13],
             head=rows[13:], name=f"narrow_{kind}")
    return load_model_config(d), jax_load_model_config(d)


@pytest.mark.parametrize("kind,px", [("vgg16", 64), ("resnet50", 96)])
def test_decoded_predictions_match_jax(kind, px):
    """fp32 forward + Detect decode of the narrow detectors."""
    cfg, jcfg = _narrow(kind)
    model, jmodel = build_model(cfg), jax_build_model(jcfg)
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 1, (2, px, px, 3)).astype(np.float32)
    ir = rng.uniform(0, 1, (2, px, px, 3)).astype(np.float32)
    v = random_variables(jmodel, jnp.asarray(rgb), jnp.asarray(ir),
                         train=False)
    want = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, train=False, decode=True)[0])(v, jnp.asarray(rgb),
                                               jnp.asarray(ir)))
    load_jax_variables(model, v)
    with torch.no_grad():
        got = model(nchw(rgb), nchw(ir)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("kind", ["vgg16", "resnet50"])
def test_weights_round_trip_through_jax_variables(kind):
    """to_jax_variables gives the flax tree of the JAX model (the same
    paths and shapes), and load_jax_variables takes it back exactly."""
    cfg, jcfg = _narrow(kind)
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(1))
    tree = to_jax_variables(model)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jax_build_model(jcfg).init(
        jax.random.PRNGKey(0), x, x, train=False))
    for coll in ("params", "batch_stats"):
        want = jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes[coll])
        got = jax.tree_util.tree_map(lambda a: tuple(a.shape), tree[coll])
        assert got == want, coll
    back = load_jax_variables(build_model(cfg), tree)
    for (k, a), b in zip(model.state_dict().items(),
                         back.state_dict().values()):
        assert torch.equal(a, b), k


def test_param_groups_of_the_tower_names():
    """stem_bn, shortcut_bn and bn1..3 scales in group 0, VGG's conv biases
    and every BatchNorm bias in group 2, the kernels in group 1: the JAX
    package's groups on the same flax paths."""
    model = ICAFusionModel(_narrow("resnet50")[0])
    vgg = ICAFusionModel(_narrow("vgg16")[0])
    paths = [p for m in (model, vgg) for c, p in flax_paths(m).values()
             if c == "params"]
    seen = {}
    for p in paths:
        assert param_group(p) == jax_param_group(p), p
        seen.setdefault((p[-2], p[-1]), param_group(p))
    assert seen[("stem_bn", "scale")] == 0
    assert seen[("shortcut_bn", "scale")] == 0
    assert seen[("bn3", "scale")] == 0
    assert seen[("shortcut_bn", "bias")] == 2
    assert seen[("conv0", "bias")] == 2 and seen[("conv0", "kernel")] == 1
    assert seen[("shortcut_conv", "kernel")] == 1


def test_cast_keeps_batchnorm_in_float32():
    """bf16 inference: VGG's conv weights and biases and NiNfusion's conv
    take bf16, as flax's dtype= casts them; ResNet's BatchNorms stay fp32."""
    for kind in ("vgg16", "resnet50"):
        model = build_model(_narrow(kind)[0]).cast(torch.bfloat16)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                assert m.weight.dtype == m.bias.dtype == torch.float32
                assert m.running_var.dtype == torch.float32
        conv = model.m0.conv0 if kind == "vgg16" else model.m10.conv
        assert conv.weight.dtype == torch.bfloat16
        if kind == "vgg16":
            assert conv.bias.dtype == torch.bfloat16


def test_init_weights_draws_the_jax_initialisers():
    """Conv kernels and VGG's biases U(+-1/sqrt(fan_in)) (TORCH_CONV_INIT,
    torch_bias_init(c1 * 9)); BatchNorms at identity."""
    model = init_weights(build_model(_narrow("vgg16")[0]),
                         torch.Generator().manual_seed(0))
    conv = model.m1.conv1                  # 16 -> 16, fan_in 144
    bound = 1 / np.sqrt(16 * 9)
    # 2304 kernel draws reach 0.9 of the bound; 16 biases half of it
    for t, share in ((conv.weight, 0.9), (conv.bias, 0.5)):
        assert share * bound < t.abs().max() <= bound
    res = init_weights(build_model(_narrow("resnet50")[0]),
                       torch.Generator().manual_seed(0))
    bn = res.m2.blk0.shortcut_bn
    assert torch.equal(bn.weight, torch.ones_like(bn.weight))
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
