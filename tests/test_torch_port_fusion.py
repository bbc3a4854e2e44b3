"""icafusion_tpu_torch fusion modules and the dual cross-attention kernel's
plain version against the JAX package (its Pallas kernel in interpret
mode, its flax modules in eval mode)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.kernels.cross_attention import \
    dual_cross_attention as jax_dual_cross_attention
from icafusion_tpu.nn import fusion as jax_fusion
from icafusion_tpu_torch.kernels.cross_attention import (NAMES,
                                                          dual_cross_attention)
from icafusion_tpu_torch.nn import fusion
from icafusion_tpu_torch.utils.convert import load_jax_variables
from torch_port_common import nchw, nhwc, random_variables

torch.set_num_threads(1)


def _attention_inputs(B, N, D, seed=0):
    rng = np.random.default_rng(seed)
    vis = rng.normal(0, 1, (B, N, D)).astype(np.float32)
    ir = rng.normal(0, 1, (B, N, D)).astype(np.float32)
    w = [rng.normal(0, 0.05, (D, D)).astype(np.float32) for _ in NAMES]
    b = [rng.normal(0, 0.01, (D,)).astype(np.float32) for _ in NAMES]
    return vis, ir, w, b


@pytest.mark.parametrize("shape", [(2, 16, 64), (1, 100, 128)])
def test_attention_reference_matches_pallas_interpret(shape):
    B, N, D = shape
    vis, ir, w, b = _attention_inputs(B, N, D)
    want = jax_dual_cross_attention(
        jnp.asarray(vis), jnp.asarray(ir), *map(jnp.asarray, w),
        *map(jnp.asarray, b), num_heads=8, interpret=True)
    # the port keeps torch Linear layout (out, in): flax's (in, out) moved
    got = dual_cross_attention(
        torch.from_numpy(vis), torch.from_numpy(ir),
        [torch.from_numpy(x.T.copy()) for x in w],
        [torch.from_numpy(x) for x in b], num_heads=8)
    for g, t in zip(got, want):
        # the tolerance of the JAX package's own Pallas test
        np.testing.assert_allclose(g.numpy(), np.asarray(t), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("hw,grid", [((80, 80), (20, 20)), ((40, 40), (16, 16)),
                                     ((20, 20), (10, 10)), ((10, 12), (10, 10)),
                                     ((2, 2), (10, 10)), ((4, 6), (10, 10)),
                                     ((12, 8), (10, 10))])
@pytest.mark.parametrize("kind", ["avg", "max"])
def test_adaptive_pool2d_matches_jax(hw, grid, kind):
    """Floor mode where the map covers the grid, true adaptive pooling
    where it does not (small and rect maps)."""
    x = np.random.default_rng(3).normal(size=(2, *hw, 5)).astype(np.float32)
    want = np.asarray(jax_fusion.adaptive_pool2d(jnp.asarray(x), *grid, kind))
    got = nhwc(fusion.adaptive_pool2d(nchw(x), *grid, kind))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((20, 20), (80, 80)), ((16, 16), (40, 40)),
                                     ((10, 10), (4, 6)), ((4, 4), (2, 3))])
def test_resize_linear_matches_jax_image_resize(src, dst):
    """Upsampling (the 640 path, including 16 -> 40) and antialiased
    downsampling (maps smaller than the anchor grid)."""
    x = np.random.default_rng(4).normal(size=(2, *src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3), "linear"))
    got = nhwc(fusion.resize_linear(nchw(x), *dst))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _tokens(b, n, d, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, d)).astype(np.float32) for _ in range(2)]


def test_cross_attention_matches_flax():
    vis, ir = _tokens(2, 16, 64)
    jmod = jax_fusion.CrossAttention(64, 8)
    args = ([jnp.asarray(vis), jnp.asarray(ir)],)
    v = random_variables(jmod, *args, train=False)
    want = jmod.apply(v, *args, train=False)
    mod = load_jax_variables(fusion.CrossAttention(64, 8).eval(), v)
    with torch.no_grad():
        got = mod(torch.from_numpy(vis), torch.from_numpy(ir))
    assert mod.ln_vis.eps == 1e-6
    for g, t in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(t), rtol=1e-4,
                                   atol=1e-5)


def test_cross_transformer_block_matches_flax():
    vis, ir = _tokens(2, 16, 32)
    jmod = jax_fusion.CrossTransformerBlock(32, 8)
    args = ([jnp.asarray(vis), jnp.asarray(ir)],)
    v = random_variables(jmod, *args, train=False)
    want = jmod.apply(v, *args, train=False)
    mod = load_jax_variables(fusion.CrossTransformerBlock(32, 8).eval(), v)
    with torch.no_grad():
        got = mod(torch.from_numpy(vis), torch.from_numpy(ir))
    for g, t in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(t), rtol=1e-4,
                                   atol=1e-4)


def test_cross_transformer_loops_share_weights():
    """loops_num=2 applies the same weights twice (reference
    common.py:744-750). The flax block cannot be built with loops_num > 1
    (it creates its MLP submodules inside the loop), so this holds the port
    against one loop applied twice."""
    vis, ir = (torch.from_numpy(t) for t in _tokens(2, 16, 32))
    one = fusion.CrossTransformerBlock(32, 8, loops_num=1).eval()
    two = fusion.CrossTransformerBlock(32, 8, loops_num=2).eval()
    two.load_state_dict(one.state_dict())
    with torch.no_grad():
        want = one(*one(vis, ir))
        got = two(vis, ir)
    for g, t in zip(got, want):
        torch.testing.assert_close(g, t, rtol=0, atol=0)


@pytest.mark.parametrize("hw,grid", [((8, 8), (4, 4)), ((16, 12), (4, 4)),
                                     ((2, 3), (4, 4))])
def test_transformer_fusion_block_matches_flax(hw, grid):
    """Floor-mode pooling with a bilinear upsample back, and a map smaller
    than the anchor grid (adaptive pooling, antialiased downsample)."""
    rng = np.random.default_rng(6)
    vis, ir = (rng.normal(size=(2, *hw, 32)).astype(np.float32)
               for _ in range(2))
    jmod = jax_fusion.TransformerFusionBlock(32, *grid)
    args = ([jnp.asarray(vis), jnp.asarray(ir)],)
    v = random_variables(jmod, *args, train=False)
    want = np.asarray(jmod.apply(v, *args, train=False))
    mod = load_jax_variables(fusion.TransformerFusionBlock(32, *grid).eval(),
                             v)
    with torch.no_grad():
        got = nhwc(mod([nchw(vis), nchw(ir)]))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
