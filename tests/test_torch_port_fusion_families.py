"""icafusion_tpu_torch's other fusion families against the JAX package:
Add, Add2, NiNfusion and DMAF as modules, and the n-scale NiNfusion and Add
detectors and the tiny DMAF detector end to end, with the same numpy inputs
and flax variables through both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.models import zoo as jax_zoo
from icafusion_tpu.models.assembler import build_model as jax_build_model
from icafusion_tpu.nn import fusion as jax_fusion
from icafusion_tpu_torch.models import zoo
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.nn import fusion
from icafusion_tpu_torch.utils.convert import load_jax_variables
from torch_port_common import nchw, nhwc, random_variables

torch.set_num_threads(1)


def _maps(n=2, c=24, hw=(6, 10), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, *hw, c)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("train", [False, True])
def test_add_matches_flax(train):
    xs = _maps()
    want = jax_fusion.Add(24).apply({}, [jnp.asarray(a) for a in xs],
                                    train=train)
    mod = fusion.Add().train(train)
    got = nhwc(mod([nchw(a) for a in xs]))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("index", [0, 1])
@pytest.mark.parametrize("train", [False, True])
def test_add2_matches_flax(index, train):
    x, a, b = _maps(3, seed=1)
    want = jax_fusion.Add2(24, index).apply(
        {}, [jnp.asarray(x), (jnp.asarray(a), jnp.asarray(b))], train=train)
    got = fusion.Add2(index).train(train)([nchw(x), (nchw(a), nchw(b))])
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("train", [False, True])
def test_ninfusion_matches_flax(train):
    """concat(16 + 16) -> 1x1 conv to 16 without bias -> SiLU; the conv
    under the flax name ``conv``."""
    xs = _maps(c=16, seed=2)
    jm = jax_fusion.NiNfusion(32, 16)
    args = [jnp.asarray(a) for a in xs]
    v = random_variables(jm, args)
    assert set(v["params"]) == {"conv"}
    want = jm.apply(v, args, train=train)
    mod = load_jax_variables(fusion.NiNfusion(32, 16), v).train(train)
    with torch.no_grad():
        got = nhwc(mod([nchw(a) for a in xs]))
    assert mod.conv.bias is None
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw", [(6, 10), (1, 1)])
@pytest.mark.parametrize("train", [False, True])
def test_dmaf_matches_flax(hw, train):
    """Both gated difference maps; the spatial mean is over H and W (NCHW
    dims 2, 3 against NHWC 1, 2), never over channels."""
    xs = _maps(hw=hw, seed=3)
    want = jax_fusion.DMAF(24).apply({}, [jnp.asarray(a) for a in xs],
                                     train=train)
    got = fusion.DMAF().train(train)([nchw(a) for a in xs])
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def _cfgs(which):
    if which == "tiny_dmaf":
        return (zoo.tiny_icafusion_config(fusion="dmaf"),
                jax_zoo.tiny_icafusion_config(fusion="dmaf"))
    scale, kind = which.split("_")
    return (zoo.icafusion_config(scale, nc=3, fusion=kind),
            jax_zoo.icafusion_config(scale, nc=3, fusion=kind))


@pytest.mark.parametrize("which,px", [("n_nin", 128), ("n_add", 96),
                                      ("tiny_dmaf", 64)])
def test_decoded_predictions_match_jax(which, px):
    """fp32 forward + Detect decode of whole detectors. n-scale NiNfusion
    and Add: the graphs of yolov5n_NiNfusion.yaml and yolov5n_Add.yaml,
    whose P4 C3 has a 64-channel 3x3 Conv (the fused conv's plain version
    on the CPU); tiny DMAF: the DMAF, Add2, Add block at each level, with
    relative ``from`` entries made absolute."""
    cfg, jcfg = _cfgs(which)
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
    assert any(l.module in ("NiNfusion", "Add", "DMAF") for l in cfg.layers)
    # fp32 through some 70 layers summed in different orders; boxes in px
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_dmaf_rows_read_the_gates_by_absolute_index():
    """The DMAF block's relative ``from`` entries ([b, -2], [-2, -1])
    become absolute and join the save-list, as in the JAX package."""
    from icafusion_tpu_torch.models.assembler import resolve_model
    layers_, save = resolve_model(zoo.tiny_icafusion_config(fusion="dmaf"))
    dmaf = [r.i for r in layers_ if r.module == "DMAF"]
    assert dmaf == [18, 22, 26]
    for i in dmaf:
        assert layers_[i + 1].f == (layers_[i + 1].f[0], -1)
        assert layers_[i + 2].f == (layers_[i + 2].f[0], i)
        assert layers_[i + 3].f == (i + 1, -1)
        assert {i, i + 1} <= save


@pytest.mark.parametrize("fusion", ["nin", "add", "dmaf"])
def test_engine_evaluator_and_trainer_take_the_family(fusion, tmp_path):
    """No entry point assumes a TransformerFusionBlock: the engine serves a
    ragged batch, the Evaluator scores synthetic pairs, and a Trainer step
    moves the weights, on the CPU."""
    import copy

    from icafusion_tpu_torch.config import (load_data_config,
                                            load_hyp_config)
    from icafusion_tpu_torch.data.datasets import PairedDetectionDataset
    from icafusion_tpu_torch.data.loader import PairedLoader
    from icafusion_tpu_torch.data.synthetic import make_dataset
    from icafusion_tpu_torch.eval.evaluator import Evaluator
    from icafusion_tpu_torch.models.assembler import init_weights
    from icafusion_tpu_torch.serve.engine import ServingEngine
    from icafusion_tpu_torch.train.loss import pad_targets
    from icafusion_tpu_torch.train.trainer import Trainer

    model = init_weights(build_model(zoo.tiny_icafusion_config(fusion=fusion)),
                         torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    rgb, ir = (rng.integers(0, 256, (3, 64, 96, 3), np.uint8)
               for _ in range(2))
    out = ServingEngine(model, (64, 96), 4, conf_thres=0.001,
                        dtype="float32", device="cpu").predict_arrays(rgb, ir)
    assert len(out) == 3 and all(o.shape[1] == 6 for o in out)

    dc = load_data_config(make_dataset(tmp_path, 8, rng, hw=(64, 64)))
    root = tmp_path
    val = PairedDetectionDataset(str(root / dc.val_rgb),
                                 str(root / dc.val_ir), 64, nc=3)
    r = Evaluator(model, nc=3, device="cpu").run(
        PairedLoader(val, 2).val_batches(), 64)
    assert r["seen"] == len(val) and 0 <= r["map50"] <= 1

    tr = Trainer(copy.deepcopy(model), load_hyp_config(), epochs=1,
                 steps_per_epoch=1, batch_size=2, imgsz=64,
                 warmup_min_steps=1, device="cpu")
    labels = [np.array([[0, 0.5, 0.5, 0.4, 0.4]], np.float32)] * 2
    t, m = (torch.from_numpy(a) for a in pad_targets(labels, 4))
    x = torch.from_numpy(rng.random((2, 3, 64, 64), np.float32))
    step = tr.make_train_step()
    for _ in range(2):      # the first step of warmup moves biases only
        assert np.isfinite(float(step(x, x.flip(1), t, m)["loss"]))
    before = dict(model.named_parameters())
    moved = [k for k, p in tr.model.named_parameters()
             if not torch.equal(p.detach(), before[k].detach())]
    assert len(moved) > len(before) // 2
