"""The port's TTA (models/tta.py) and the raw maps of the eval forward
against the JAX package on the tiny model: scale_img, the three-pass
ensemble at 64 px, and a non-square (64 x 96) forward whose decoded
predictions and raw maps (the val loss's input) both agree."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.models import tta as jax_tta
from icafusion_tpu.models import zoo as jax_zoo
from icafusion_tpu.models.assembler import build_model as jax_build_model
from icafusion_tpu_torch.models import tta, zoo
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.utils.convert import load_jax_variables
from torch_port_common import nchw, nhwc, random_variables

torch.set_num_threads(1)


def _images(hw, seed=0, B=2):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (B, *hw, 3)).astype(np.float32),
            rng.uniform(0, 1, (B, *hw, 3)).astype(np.float32))


def _models(hw):
    """The tiny model in both packages with the same random variables."""
    jmodel = jax_build_model(jax_zoo.tiny_icafusion_config())
    x = jnp.zeros((1, *hw, 3), jnp.float32)
    v = random_variables(jmodel, x, x, train=False)
    return load_jax_variables(build_model(zoo.tiny_icafusion_config()),
                              v), jmodel, v


@pytest.mark.parametrize("ratio", [1.0, 0.83, 0.67, 0.5])
def test_scale_img_matches_jax(ratio):
    """The antialiased shrink and the 0.447 padding to multiples of 32,
    non-square: 64 x 96 -> int(h * ratio) x int(w * ratio), padded."""
    img, _ = _images((64, 96))
    want = np.asarray(jax_tta.scale_img(jnp.asarray(img), ratio))
    got = nhwc(tta.scale_img(nchw(img), ratio))
    assert got.shape == want.shape
    assert got.shape[1] % 32 == 0 and got.shape[2] % 32 == 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_tta_inference_matches_jax():
    """The three passes (scales 1, 0.83, 0.67; the second flipped), de-scaled
    and de-flipped, concatenated: 3 x (64 x 64) candidates at 64 px."""
    model, jmodel, v = _models((64, 64))
    rgb, ir = _images((64, 64), seed=1)
    run = jax.jit(lambda v, a, b: jax_tta.tta_inference(jmodel, v, a, b))
    want = np.asarray(run(v, jnp.asarray(rgb), jnp.asarray(ir)))
    with torch.no_grad():
        got = tta.tta_inference(model, nchw(rgb), nchw(ir)).numpy()
    assert got.shape == want.shape == (2, 3 * 252, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_raw_maps_of_a_non_square_forward_match_jax():
    """model(raw=True) at 64 x 96: the decoded predictions and the raw maps
    of the same forward, as the JAX apply(decode=True) returns them; the
    default call returns the decoded tensor alone."""
    model, jmodel, v = _models((64, 96))
    rgb, ir = _images((64, 96), seed=2)
    run = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False,
                                               decode=True))
    want_pred, _, want_maps = run(v, jnp.asarray(rgb), jnp.asarray(ir))
    with torch.no_grad():
        pred, maps = model(nchw(rgb), nchw(ir), raw=True)
        alone = model(nchw(rgb), nchw(ir))
    torch.testing.assert_close(alone, pred, rtol=0, atol=0)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred),
                               rtol=1e-4, atol=1e-3)
    assert len(maps) == len(want_maps) == 3
    for g, w in zip(maps, want_maps):
        assert tuple(g.shape) == w.shape      # (B, ny, nx, na, 5 + nc)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
