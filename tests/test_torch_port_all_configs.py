"""Every shipped model config in icafusion_tpu_torch against the JAX
package, and the dual cross-attention kernel's argument check at the head
widths those configs reach: resolve_model's layers and save-list, and the
variable tree (paths and shapes, from jax.eval_shape and a model built on
the meta device, so nothing is allocated); the plain attention against the
JAX Pallas kernel in interpret mode at the x-scale and ResNet50 P5 widths."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.config import load_model_config as jax_load_model_config
from icafusion_tpu.kernels.cross_attention import \
    dual_cross_attention as jax_dual_cross_attention
from icafusion_tpu.models import assembler as jax_assembler
from icafusion_tpu_torch.cli._common import mc_min_size
from icafusion_tpu_torch.config import load_model_config
from icafusion_tpu_torch.kernels.cross_attention import (NAMES, check_args,
                                                          dual_cross_attention)
from icafusion_tpu_torch.models import assembler
from icafusion_tpu_torch.utils.convert import flax_paths

torch.set_num_threads(1)

YAMLS = sorted(p.name for p in (Path(__file__).resolve().parents[1]
                                / "configs" / "models").glob("*.yaml"))


def _resolved(layers_):
    return [(r.i, r.f, r.n, r.module, repr(r.args), r.c2) for r in layers_]


def _flax_shape(shape, leaf):
    """A port tensor's shape in flax layout (utils/convert.to_flax_layout)."""
    if leaf == "kernel":
        return (tuple(shape[i] for i in (2, 3, 1, 0)) if len(shape) == 4
                else tuple(reversed(shape)))
    return tuple(shape)


def test_all_shipped_configs_are_listed():
    assert len(YAMLS) == 21


@pytest.mark.parametrize("name", YAMLS)
def test_shipped_config_matches_jax(name):
    """Equal resolved layers (args, channels, absolute ``from``) and
    save-lists; the same variables, path by path and shape by shape; and
    every TransformerFusionBlock's width is one the kernel takes, in both
    dtypes (dk up to 256: ResNet50's P5 block has d_model 2048)."""
    cfg, jcfg = load_model_config(name), jax_load_model_config(name)
    mine = assembler.resolve_model(cfg)
    theirs = jax_assembler.resolve_model(jcfg)
    assert _resolved(mine[0]) == _resolved(theirs[0])
    assert mine[1] == theirs[1]

    with torch.device("meta"):
        model = assembler.ICAFusionModel(cfg)
    sd = model.state_dict()
    got = {(c, p): _flax_shape(sd[n].shape, p[-1])
           for n, (c, p) in flax_paths(model).items()}
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jax_assembler.build_model(jcfg).init(
        jax.random.PRNGKey(0), x, x, train=False))
    want = {}
    for coll in ("params", "batch_stats"):
        for path, s in jax.tree_util.tree_leaves_with_path(
                shapes.get(coll, {})):
            want[(coll, tuple(k.key for k in path))] = tuple(s.shape)
    assert got == want

    widths = [r.args[0] for r in mine[0]
              if r.module == "TransformerFusionBlock"]
    for d in widths:
        for dtype in (torch.float32, torch.bfloat16):
            check_args(d, 8, dtype)
    if "Transfusion" not in name:
        assert not widths and mc_min_size(cfg) == 64


@pytest.mark.parametrize("D,dkp", [(1280, 192), (2048, 256), (512, 64),
                                   (192, 32), (320, 64), (640, 128),
                                   (384, 64), (768, 128), (64, 16)])
def test_attention_check_accepts_the_shipped_widths(D, dkp):
    """Every (D, h = 8) of the shipped configs: each dtype pads dk to its
    flash core's width, fp32 as bf16 but for dk 8, one k8 step of the
    tf32 core (bf16's k16 steps take 16). dk 160 (x-scale P5) and 256
    (ResNet50 P5) were refused before the kernel took heads wider than
    128."""
    assert check_args(D, 8, torch.float32) == (8 if D == 64 else dkp)
    assert check_args(D, 8, torch.bfloat16) == dkp


def test_attention_check_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="D / h <= 256"):
        check_args(2112, 8, torch.float32)        # dk 264
    with pytest.raises(ValueError, match="D % h"):
        check_args(100, 8, torch.float32)
    with pytest.raises(ValueError, match="D % 8"):
        check_args(36, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="D % 4"):
        check_args(42, 6, torch.float32)          # rows of 168 bytes
    with pytest.raises(TypeError):
        check_args(64, 8, torch.float16)
    assert check_args(36, 4, torch.float32) == 16


@pytest.mark.parametrize("D", [1280, 2048])
def test_attention_reference_matches_pallas_interpret_wide_heads(D):
    """The plain version against the JAX Pallas kernel in interpret mode at
    the x-scale (dk 160) and ResNet50 (dk 256) P5 widths, B 1, N 16."""
    rng = np.random.default_rng(D)
    vis, ir = (rng.normal(0, 1, (1, 16, D)).astype(np.float32)
               for _ in range(2))
    w = [rng.normal(0, D ** -0.5, (D, D)).astype(np.float32) for _ in NAMES]
    b = [rng.normal(0, 0.01, (D,)).astype(np.float32) for _ in NAMES]
    want = jax_dual_cross_attention(
        jnp.asarray(vis), jnp.asarray(ir), *map(jnp.asarray, w),
        *map(jnp.asarray, b), num_heads=8, interpret=True)
    got = dual_cross_attention(
        torch.from_numpy(vis), torch.from_numpy(ir),
        [torch.from_numpy(x.T.copy()) for x in w],
        [torch.from_numpy(x) for x in b], num_heads=8)
    for g, t in zip(got, want):
        # the tolerance of the JAX package's own Pallas test
        np.testing.assert_allclose(g.numpy(), np.asarray(t), rtol=2e-4,
                                   atol=2e-5)
