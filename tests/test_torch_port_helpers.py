"""The last public helpers of the port against the JAX package's, on
seeded arrays: ops/boxes (xyxy2xywh, clip_coords, scale_coords, wh_iou),
ModelConfig.is_two_stream, ICAFusionModel's detect_layer, strides and
anchors_grid_units, nn/layers.Sum against flax, utils/general's one_cycle,
linear_lr, init_seeds, colorstr and get_latest_run, and the package
re-exports (every name of the JAX package's __init__ files but the
JAX-only ones)."""

import importlib
import os
import random
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.models import zoo as jax_zoo
from icafusion_tpu.models.assembler import build_model as jax_build
from icafusion_tpu.nn import layers as jax_layers
from icafusion_tpu.ops import boxes as jb
from icafusion_tpu.utils import general as jg
from icafusion_tpu_torch.models import zoo
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.nn import layers
from icafusion_tpu_torch.ops import boxes as pb
from icafusion_tpu_torch.utils import general as pg

# names of the JAX package's __init__ files that have no port counterpart
# (ROADMAP, Deliberate differences)
JAX_ONLY = {"parallel": {"batch_sharding", "replicate_tree"}}


def _boxes(n, seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-20, 120, (n, 2))
    wh = rng.uniform(1, 60, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_boxes_match_jax():
    b = _boxes(64, 0)
    t = torch.from_numpy(b)
    np.testing.assert_allclose(pb.xyxy2xywh(t).numpy(),
                               np.asarray(jb.xyxy2xywh(jnp.asarray(b))),
                               rtol=1e-6)
    np.testing.assert_array_equal(
        pb.clip_coords(t, (80, 100)).numpy(),
        np.asarray(jb.clip_coords(jnp.asarray(b), (80, 100))))
    for ratio_pad in (None, (0.5, (3.0, 7.0))):
        np.testing.assert_allclose(
            pb.scale_coords((64, 96), t, (128, 160), ratio_pad).numpy(),
            np.asarray(jb.scale_coords((64, 96), jnp.asarray(b), (128, 160),
                                       ratio_pad)), rtol=1e-6, atol=1e-5)
    wh1, wh2 = (np.random.default_rng(s).uniform(1, 50, (n, 2)).astype(
        np.float32) for s, n in ((1, 9), (2, 7)))
    got = pb.wh_iou(torch.from_numpy(wh1), torch.from_numpy(wh2)).numpy()
    assert got.shape == (9, 7)
    np.testing.assert_allclose(got, np.asarray(jb.wh_iou(
        jnp.asarray(wh1), jnp.asarray(wh2))), rtol=1e-6)
    back = pb.xywh2xyxy(pb.xyxy2xywh(t))
    np.testing.assert_allclose(back.numpy(), b, atol=1e-4)


def test_config_and_model_helpers_match_jax():
    for cfg, jcfg in ((zoo.tiny_icafusion_config(),
                       jax_zoo.tiny_icafusion_config()),
                      (zoo.icafusion_config("l", nc=3),
                       jax_zoo.icafusion_config("l", nc=3))):
        assert cfg.is_two_stream and jcfg.is_two_stream
        jm = jax_build(jcfg)
        with torch.device("meta"):
            m = build_model(cfg)
        assert m.detect_layer().i == jm.detect_layer().i
        assert m.detect_layer().f == jm.detect_layer().f
        assert m.strides() == tuple(jm.strides())
        np.testing.assert_array_equal(m.anchors_grid_units(),
                                      jm.anchors_grid_units())
    import dataclasses
    cfg = zoo.tiny_icafusion_config()
    one = dataclasses.replace(cfg, layers=tuple(
        dataclasses.replace(l, f=-1) if l.f == -4 else l
        for l in cfg.layers))
    assert not one.is_two_stream


@pytest.mark.parametrize("weight", [False, True])
def test_sum_matches_flax(weight):
    """Sum of three maps, plain and weighted (the flax parameter w, drawn
    and carried across); not a YAML module in either package."""
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(2, 5, 6, 4)).astype(np.float32) for _ in range(3)]
    jm = jax_layers.Sum(n=3, weight=weight)
    v = jm.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs])
    m = layers.Sum(3, weight=weight)
    if weight:
        np.testing.assert_array_equal(m.w.detach().numpy(),
                                      np.asarray(v["params"]["w"]))
        w = rng.normal(size=(2,)).astype(np.float32)
        v = {"params": {"w": jnp.asarray(w)}}
        with torch.no_grad():
            m.w.copy_(torch.from_numpy(w))
        assert [n for n, _ in m.named_parameters()] == ["w"]
    else:
        assert not list(m.parameters())
    want = np.asarray(jm.apply(v, [jnp.asarray(x) for x in xs]))
    got = m([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               want, rtol=1e-6, atol=1e-6)
    from icafusion_tpu_torch.models.assembler import MODULE_BUILDERS
    assert "Sum" not in MODULE_BUILDERS


def test_general_helpers_match_jax(tmp_path):
    for y1, y2, steps in ((0.0, 1.0, 100), (1.0, 0.1, 30)):
        f, jf = pg.one_cycle(y1, y2, steps), jg.one_cycle(y1, y2, steps)
        assert [f(x) for x in range(0, steps + 1, 5)] == [
            jf(x) for x in range(0, steps + 1, 5)]
    f, jf = pg.linear_lr(0.1, 30), jg.linear_lr(0.1, 30)
    assert [f(x) for x in range(30)] == [jf(x) for x in range(30)]
    g = pg.init_seeds(4)
    a = (random.random(), np.random.rand(), torch.rand(1).item(),
         g.random())
    jgen = jg.init_seeds(4)
    b = (random.random(), np.random.rand(), jgen.random())
    assert (a[0], a[1], a[3]) == b
    pg.init_seeds(4)
    random.random(), np.random.rand()
    assert torch.rand(1).item() == a[2]
    for args in (("hi",), ("red", "bold", "x"), ("bright_green", "y")):
        assert pg.colorstr(*args) == jg.colorstr(*args)
    assert pg.get_latest_run(str(tmp_path)) == jg.get_latest_run(
        str(tmp_path)) == ""
    for i, name in enumerate(("a/last.ckpt", "b/c/last.ckpt",
                              "d/last.msgpack")):
        p = tmp_path / name
        p.parent.mkdir(parents=True)
        p.write_bytes(b"x")
        os.utime(p, (time.time() + i, time.time() + i))
        time.sleep(0.01)
    assert pg.get_latest_run(str(tmp_path)) == jg.get_latest_run(
        str(tmp_path))
    assert pg.get_latest_run(str(tmp_path)).endswith("last.msgpack")


@pytest.mark.parametrize("pkg", ["", "ops", "models", "eval", "serve",
                                 "train", "data", "utils", "parallel",
                                 "kernels", "nn"])
def test_package_reexports_match_jax(pkg):
    """Each __init__ of the port names what the JAX package's names, but
    the JAX-only names (the Deliberate differences), and every name is
    importable from it."""
    suffix = f".{pkg}" if pkg else ""
    ours = importlib.import_module("icafusion_tpu_torch" + suffix)
    theirs = importlib.import_module("icafusion_tpu" + suffix)
    want = set(theirs.__all__) - JAX_ONLY.get(pkg, set())
    assert want <= set(ours.__all__)
    assert all(getattr(ours, n) is not None for n in ours.__all__)
