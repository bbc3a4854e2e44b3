"""ops/fuse.py: fold_conv_bn of the port against the JAX package's
ops/fuse.py on the same variables, on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.models import zoo as jax_zoo
from icafusion_tpu.models.assembler import build_model as jax_build_model
from icafusion_tpu.ops.fuse import fold_conv_bn as jax_fold_conv_bn
from icafusion_tpu_torch.models import zoo
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.nn.layers import BN_EPS
from icafusion_tpu_torch.ops.fuse import fold_conv_bn
from icafusion_tpu_torch.utils.convert import (load_jax_variables,
                                               to_jax_variables)
from test_torch_port_backbones import _narrow
from torch_port_common import nchw, random_variables

torch.set_num_threads(1)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("backbone", ["tiny", "resnet50"])
def test_fold_conv_bn_matches_jax(backbone):
    """The folded variables equal the JAX fold of the same variables (the
    same numpy fp32 arithmetic: exactly), the ResNet tower's conv1..3,
    stem and shortcut pairs included (the narrow ResNet50 detector of
    test_torch_port_backbones), and the port's forward is unchanged
    within fp32 rounding (rtol 1e-4, atol 1e-3 px, as the serving test)."""
    if backbone == "tiny":
        cfgs = zoo.tiny_icafusion_config(), jax_zoo.tiny_icafusion_config()
        px = 64
    else:
        cfgs, px = _narrow("resnet50"), 96
    jm = jax_build_model(cfgs[1])
    x = jnp.zeros((1, px, px, 3), jnp.float32)
    v = jax.tree.map(np.asarray, random_variables(jm, x, x, train=False))
    want = jax.tree.map(np.asarray, jax_fold_conv_bn(
        jax.tree.map(np.copy, v)))
    model = load_jax_variables(build_model(cfgs[0]), v)
    rng = np.random.default_rng(0)
    rgb, ir = (rng.uniform(0, 1, (1, px, px, 3)).astype(np.float32)
               for _ in range(2))
    with torch.no_grad():
        before = model(nchw(rgb), nchw(ir))
        got = to_jax_variables(fold_conv_bn(model))
        after = model(nchw(rgb), nchw(ir))
    folded = 0
    for coll in ("params", "batch_stats"):
        w = dict(_leaves(want[coll]))
        g = dict(_leaves(got[coll]))
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=str(k))
        folded += sum(k[-1] == "var" and np.allclose(
            w[k], np.float32(1) - np.float32(BN_EPS)) for k in w)
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    assert folded == n_bn > 0
    torch.testing.assert_close(after, before, rtol=1e-4, atol=1e-3)
