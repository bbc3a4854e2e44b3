"""The port's serving slice as a whole against the JAX package: decoded
predictions of the two-stream model, and ServingEngine.predict_arrays on a
ragged batch and a rect canvas, with the same flax variables."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.models import zoo as jax_zoo
from icafusion_tpu.models.assembler import build_model as jax_build_model
from icafusion_tpu.serve.engine import ServingEngine as JaxServingEngine
from icafusion_tpu_torch.models import zoo
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.serve.engine import ServingEngine
from icafusion_tpu_torch.utils.convert import load_jax_variables
from torch_port_common import nchw, random_variables

torch.set_num_threads(1)


def _pair_models(which):
    if which == "tiny":
        cfgs = zoo.tiny_icafusion_config(), jax_zoo.tiny_icafusion_config()
    else:
        cfgs = (zoo.icafusion_config(which, nc=3, fusion="tfb"),
                jax_zoo.icafusion_config(which, nc=3, fusion="tfb"))
    return build_model(cfgs[0]), jax_build_model(cfgs[1])


@pytest.mark.parametrize("which,px", [("tiny", 64), ("n", 128)])
def test_decoded_predictions_match_jax(which, px):
    """fp32 forward + Detect decode in the (ny, nx, na) candidate order. At
    128 px the P5 map (4x4) is smaller than its 10x10 anchor grid, so the
    adaptive-pool and antialiased-resize branches run too."""
    model, jmodel = _pair_models(which)
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 1, (2, px, px, 3)).astype(np.float32)
    ir = rng.uniform(0, 1, (2, px, px, 3)).astype(np.float32)
    v = random_variables(jmodel, jnp.asarray(rgb), jnp.asarray(ir),
                         train=False)
    apply = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False,
                                                 decode=True)[0])
    want = np.asarray(apply(v, jnp.asarray(rgb), jnp.asarray(ir)))
    load_jax_variables(model, v)
    with torch.no_grad():
        got = model(nchw(rgb), nchw(ir)).numpy()
    assert got.shape == want.shape
    # fp32 through ~70 layers summed in different orders; boxes in pixels
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("canvas", [(64, 64), (64, 96)])
def test_serving_engine_matches_jax(canvas):
    """3 pairs into a batch of 4 (padding dropped), square and rect canvas."""
    model, jmodel = _pair_models("tiny")
    x = jnp.zeros((1, *canvas, 3), jnp.float32)
    v = random_variables(jmodel, x, x, train=False)
    load_jax_variables(model, v)
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (3, *canvas, 3), np.uint8)
    ir = rng.integers(0, 256, (3, *canvas, 3), np.uint8)
    kw = dict(img_size=canvas, batch_size=4, conf_thres=0.25, max_det=100)
    want = JaxServingEngine(model=jmodel, variables=v, n_devices=1,
                            dtype="float32", merge_streams=0,
                            **kw).predict_arrays(rgb, ir)
    engine = ServingEngine(model, dtype="float32", device="cpu", **kw)
    got = engine.predict_arrays(rgb, ir)
    assert len(got) == len(want) == 3
    assert sum(len(g) for g in got) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, :5], w[:, :5], rtol=1e-4, atol=1e-3)
    hw0 = [(32, 48), None, (128, 128)]
    native = engine.predict_arrays(rgb, ir, orig_hw=hw0)
    np.testing.assert_allclose(native[1], got[1])
    if len(native[0]):
        assert native[0][:, [0, 2]].max() <= 48 and native[0][:, [1, 3]].max() <= 32


def test_engine_defaults_to_the_card():
    model = build_model(zoo.tiny_icafusion_config())
    if torch.cuda.is_available():
        assert ServingEngine(model, 64, 1).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(model, 64, 1)


def test_engine_casts_like_jax():
    """bf16 serving keeps LayerNorm, BatchNorm and the attention projection
    biases in fp32, and leaves the caller's model untouched."""
    model = build_model(zoo.tiny_icafusion_config())
    engine = ServingEngine(model, 64, 1, dtype="bfloat16", device="cpu")
    m = engine.model
    assert m.m0.conv.weight.dtype == torch.bfloat16
    assert m.m0.bn.weight.dtype == m.m0.bn.running_var.dtype == torch.float32
    att = m.m18.crosstransformer0.crossatt
    assert att.q_vis.weight.dtype == torch.bfloat16
    assert att.q_vis.bias.dtype == att.ln_vis.weight.dtype == torch.float32
    assert model.m0.conv.weight.dtype == torch.float32
    out = engine.predict_arrays(np.zeros((1, 64, 64, 3), np.uint8),
                                np.zeros((1, 64, 64, 3), np.uint8))
    assert len(out) == 1 and out[0].shape[1] == 6
