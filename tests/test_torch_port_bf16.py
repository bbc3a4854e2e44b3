"""The port's bfloat16 serving against the JAX package's bfloat16 serving,
on the CPU: decoded predictions and served detections with the same
weights and pairs.

The two frameworks round to bf16 at different places (the port's fused
64-channel conv, for one, rounds once after the SiLU where flax rounds
after the conv, the BatchNorm and the SiLU), so they agree only to bf16
precision. The tolerance is stated against the JAX package's own bf16
error: at the 99th percentile and at the maximum, for each of xy, wh,
objectness and class scores, the port's bf16 may be at most twice as far
from the JAX bf16 result as the JAX bf16 result is from the JAX fp32 one.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.models import zoo as jax_zoo
from icafusion_tpu.models.assembler import build_model as jax_build_model
from icafusion_tpu.serve.engine import ServingEngine as JaxServingEngine
from icafusion_tpu.utils.checkpoint import (load_inference_variables as
                                            jax_load_inference_variables)
from icafusion_tpu_torch.data.datasets import PairedDetectionDataset
from icafusion_tpu_torch.models import zoo
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.serve.engine import ServingEngine
from icafusion_tpu_torch.utils.checkpoint import load_inference_variables
from icafusion_tpu_torch.utils.convert import load_jax_variables
from torch_port_common import random_variables

torch.set_num_threads(1)

N320 = Path(__file__).resolve().parents[1] / "artifacts" / "trained_n320"
PARTS = {"xy": slice(0, 2), "wh": slice(2, 4), "obj": slice(4, 5),
         "cls": slice(5, None)}


def _case(which):
    """(port model, flax config, flax variables, rgb, ir uint8 NHWC)."""
    if which == "tiny":
        cfg, jcfg = zoo.tiny_icafusion_config(), jax_zoo.tiny_icafusion_config()
        rng = np.random.default_rng(5)
        rgb = rng.integers(0, 256, (2, 64, 64, 3), np.uint8)
        ir = rng.integers(0, 256, (2, 64, 64, 3), np.uint8)
        x = jnp.zeros((1, 64, 64, 3), jnp.float32)
        v = random_variables(jax_build_model(jcfg), x, x, train=False)
    else:   # the trained n320 weights on four of its val pairs
        cfg = zoo.icafusion_config("n", nc=3)
        jcfg = jax_zoo.icafusion_config("n", nc=3)
        v = jax_load_inference_variables(str(N320 / "stripped.ckpt"))
        ds = PairedDetectionDataset(str(N320 / "data" / "visible" / "val"),
                                    str(N320 / "data" / "infrared" / "val"),
                                    320, nc=3)
        rgb, ir = (np.stack(a) for a in zip(*(ds.val_sample(i)[:2]
                                              for i in range(4))))
    return build_model(cfg), jcfg, v, rgb, ir


@pytest.fixture(scope="module", params=["tiny", "n320"])
def case(request):
    return _case(request.param)


def _jax_decoded(jcfg, v, rgb, ir, dtype):
    model = jax_build_model(jcfg, dtype=dtype)
    f = jax.jit(lambda v, a, b: model.apply(
        v, a.astype(jnp.float32) / 255, b.astype(jnp.float32) / 255,
        train=False, decode=True)[0])
    return np.asarray(f(v, rgb, ir), np.float32)


def test_bf16_decoded_predictions_match_jax(case):
    model, jcfg, v, rgb, ir = case
    want16 = _jax_decoded(jcfg, v, rgb, ir, jnp.bfloat16)
    want32 = _jax_decoded(jcfg, v, rgb, ir, jnp.float32)
    load_jax_variables(model, v)
    engine = ServingEngine(model, rgb.shape[1:3], len(rgb), dtype="bfloat16",
                           device="cpu")
    with torch.inference_mode():
        x, y = ((torch.from_numpy(a).permute(0, 3, 1, 2).float() / 255)
                .to(torch.bfloat16) for a in (rgb, ir))
        got = engine.model(x, y).float().numpy()
    assert got.shape == want16.shape
    for name, sl in PARTS.items():
        ours = np.abs(got[..., sl] - want16[..., sl])
        theirs = np.abs(want16[..., sl] - want32[..., sl])
        for q in (0.99, 1.0):
            assert np.quantile(ours, q) <= 2 * np.quantile(theirs, q), (
                name, q, np.quantile(ours, q), np.quantile(theirs, q))


def _matched(a, r):
    """Share of the rows of a with a row of r of the same class at
    IoU > 0.5."""
    if not len(a):
        return 1.0
    if not len(r):
        return 0.0
    lt = np.maximum(a[:, None, :2], r[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], r[None, :, 2:4])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    iou = inter / (area(a)[:, None] + area(r)[None, :] - inter + 1e-9)
    return float(((iou > 0.5) & (a[:, None, 5] == r[None, :, 5])).any(1)
                 .mean())


def test_bf16_detections_match_jax():
    """The trained model served at conf 0.25 by both bf16 engines: every
    detection of either has one of the same class at IoU > 0.5 in the
    other, and the counts agree."""
    model, jcfg, v, rgb, ir = _case("n320")
    load_jax_variables(model, v)
    kw = dict(img_size=320, batch_size=4, conf_thres=0.25, max_det=100)
    want = JaxServingEngine(model=jax_build_model(jcfg, dtype=jnp.bfloat16),
                            variables=v, n_devices=1, dtype="bfloat16",
                            merge_streams=0, **kw).predict_arrays(rgb, ir)
    got = ServingEngine(model, dtype="bfloat16", device="cpu",
                        **kw).predict_arrays(rgb, ir)
    assert sum(len(g) for g in got) >= 4
    for g, w in zip(got, want):
        assert len(g) == len(w)
        assert _matched(g, w) == 1.0 and _matched(w, g) == 1.0
