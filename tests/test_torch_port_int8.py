"""int8 W8A8 serving of the port (utils/quantize.py, the int8 paths of
Conv and QLinear, kernels/conv_int8.py on the CPU, ServingEngine.quantize,
the server's and cli.val's --int8) against the JAX package's
utils/quantize.py and Conv._int8_conv, on the CPU."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp

from icafusion_tpu.models import zoo as jax_zoo
from icafusion_tpu.models.assembler import build_model as jax_build_model
from icafusion_tpu.nn import layers as jax_layers
from icafusion_tpu.nn.layers import Conv as JaxConv
from icafusion_tpu.utils import quantize as jq
from icafusion_tpu_torch.kernels.conv_int8 import (conv_int8_bn_act,
                                                   plan_for, quantize_input)
from icafusion_tpu_torch.models import zoo
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.nn.layers import Conv
from icafusion_tpu_torch.serve import http_server
from icafusion_tpu_torch.serve.engine import ServingEngine
from icafusion_tpu_torch.utils import quantize as q
from icafusion_tpu_torch.utils.checkpoint import msgpack_serialize
from icafusion_tpu_torch.utils.convert import (load_jax_variables,
                                               to_jax_variables)
from torch_port_common import nchw, nhwc, no_dropout, random_variables

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N320 = ROOT / "artifacts" / "trained_n320"
PX = 64


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, its variables, the port model holding them, rgb, ir,
    the JAX calib tree): the tiny model at 64 px, batch 2."""
    jm = jax_build_model(jax_zoo.tiny_icafusion_config())
    rng = np.random.default_rng(0)
    rgb, ir = (rng.uniform(0, 1, (2, PX, PX, 3)).astype(np.float32)
               for _ in range(2))
    v = random_variables(jm, jnp.asarray(rgb), jnp.asarray(ir), train=False)
    model = load_jax_variables(build_model(zoo.tiny_icafusion_config()), v)
    calib = jq.calibrate(jm, v, [(rgb, ir)])
    return jm, v, model, rgb, ir, calib


def test_calibrate_matches_jax(tiny):
    """The port's calib tree on the same weights and inputs has the JAX
    tree's 87 paths (every float Conv, flax-keyed); the stems' absmax,
    taken on the images themselves, are equal, and every entry is within
    rtol 1e-4: the float forwards feeding deeper convs differ by fp32
    summation order (2.3e-5 at most, measured)."""
    _, _, model, rgb, ir, calib = tiny
    got = dict(_leaves(q.calibrate(model, [(rgb[:1], ir[:1]),
                                           (rgb[1:], ir[1:])])))
    want = dict(_leaves(calib))
    assert len(want) == 87 and set(got) == set(want)
    assert all(k[-1] == "absmax" for k in got)
    for k in (("m0", "absmax"), ("m9", "absmax")):
        np.testing.assert_array_equal(got[k], want[k])
    for k, w in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == w.shape
        np.testing.assert_allclose(got[k], w, rtol=1e-4, err_msg=str(k))
    assert not any(m.record or m.absmax is not None
                   for m in model.modules() if isinstance(m, Conv))


QUANT_CASES = {
    "absmax": {},
    "mse": {"weight_clip": "mse"},
    "nested_skip": {"skip": ("m2/m0", "m15", "m19/conv1x1_out")},
    "detect_feeders": "detect",
    "min_ch": {"min_ch": 48},
    "fusion_dense": {"fusion_dense": True, "skip": ("m24/cv3",)},
}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quant_tree_matches_jax(tiny, case):
    """From one calib tree, quantize_model fills the JAX
    quantize_variables' quant collection: w8 exactly, s_w and s_in within
    rtol 1e-6, the same set of paths."""
    _, v, model, _, _, calib = tiny
    kw = QUANT_CASES[case]
    if kw == "detect":
        kw = {"skip": jq.detect_feeder_skip(jax_zoo.tiny_icafusion_config())}
        assert q.detect_feeder_skip(model.cfg) == kw["skip"] == (
            "m28/cv3", "m31/cv3", "m34/cv3")
    want = dict(_leaves(jax.tree.map(
        np.asarray, jq.quantize_variables(v, calib, **kw)["quant"])))
    m = load_jax_variables(build_model(zoo.tiny_icafusion_config()), v)
    got = dict(_leaves(q.quant_tree(q.quantize_model(m, calib, **kw))))
    assert set(got) == set(want) and len(got) > 0
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        if k[-1] == "w8":
            np.testing.assert_array_equal(got[k], w, err_msg=str(k))
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-6, err_msg=str(k))
    dense = [k for k in got if k[-2].endswith(("_fc1", "_fc2", "out_vis"))]
    assert bool(dense) == (case == "fusion_dense")


def test_quantize_model_refuses_a_bf16_model_and_an_empty_calib(tiny):
    _, v, _, _, _, calib = tiny
    m = load_jax_variables(build_model(zoo.tiny_icafusion_config()), v)
    with pytest.raises(ValueError, match="no quantizable"):
        q.quantize_model(m, {})
    with pytest.raises(ValueError, match="float32"):
        q.quantize_model(m.cast(torch.bfloat16), calib)


@pytest.mark.parametrize("c1,c2,k,s", [(3, 16, 6, 2), (16, 24, 1, 1),
                                       (16, 24, 3, 1), (24, 32, 3, 2)])
@pytest.mark.parametrize("act", [True, False])
def test_int8_conv_matches_jax(c1, c2, k, s, act):
    """One Conv with one quant collection: the stem (k6 s2 p2), a 1x1, a
    3x3 s1 and a 3x3 s2 on a ragged 13 x 18 map. The int32 accumulators
    equal the JAX int8 conv's (_int8_conv with s_w = 1: exact in fp32 below
    2^24); the module outputs agree within rtol 1e-5 (atol 1e-5 of the
    largest: BatchNorm folded against flax's unfolded arithmetic)."""
    p = 2 if k == 6 else None
    jconv = JaxConv(c1=c1, c2=c2, k=k, s=s, p=p, act=act)
    rng = np.random.default_rng(c1 + k)
    x = rng.normal(0, 1.5, (2, 13, 18, c1)).astype(np.float32)
    v = random_variables(jconv, jnp.asarray(x), train=False)
    _, mut = jconv.apply(v, jnp.asarray(x), train=False, mutable=["calib"])
    calib = jax.tree.map(np.asarray, mut["calib"])
    qv = jax.tree.map(np.asarray, jq.quantize_variables(v, calib))
    conv = load_jax_variables(Conv(c1, c2, k, s, p, act=act).eval(), qv)
    ones = {**qv, "quant": {**qv["quant"], "s_w": np.ones(c2, np.float32)}}
    pad = 2 if k == 6 else k // 2
    want_acc = np.asarray(jconv.apply(ones, jnp.asarray(x), (s, s),
                                      (pad, pad), method=JaxConv._int8_conv))
    with torch.no_grad():
        acc = conv_int8_bn_act(nchw(x), conv.w8, conv.s_in, conv.s_w, None,
                               conv.conv.stride, conv.conv.padding,
                               epilogue=False)
        out = conv(nchw(x))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(nhwc(acc), want_acc.astype(np.int32))
    assert np.abs(want_acc).max() > 1000
    want = np.asarray(jconv.apply(qv, jnp.asarray(x), train=False))
    np.testing.assert_allclose(nhwc(out), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    x8 = quantize_input(nchw(x), conv.s_in)
    assert x8.abs().max() == 127


@pytest.mark.parametrize("c1,c2", [(3, 32), (6, 64)])
@pytest.mark.parametrize("phase_packed", [False, True])
def test_stem_int8_conv_matches_jax(monkeypatch, c1, c2, phase_packed):
    """The stem (k6 s2 p2) at 64 px: the plain version's int32
    accumulators, which the card's "stem" path equals, equal the JAX int8
    conv's (_int8_conv with s_w = 1) under both of its lowerings (XLA's
    conv, and the phase-packed 2x2 rewrite of ICAF_STEM_PP), at Cin 3 and
    at the merged stem's Cin 6; the module outputs agree within rtol 1e-5
    (atol 1e-5 of the largest)."""
    monkeypatch.setattr(jax_layers, "STEM_PP_ENABLED", phase_packed)
    jconv = JaxConv(c1=c1, c2=c2, k=6, s=2, p=2)
    rng = np.random.default_rng(c1 + c2)
    x = rng.uniform(0, 1, (2, 64, 64, c1)).astype(np.float32)
    v = random_variables(jconv, jnp.asarray(x), train=False)
    _, mut = jconv.apply(v, jnp.asarray(x), train=False, mutable=["calib"])
    calib = jax.tree.map(np.asarray, mut["calib"])
    qv = jax.tree.map(np.asarray, jq.quantize_variables(v, calib))
    conv = load_jax_variables(Conv(c1, c2, 6, 2, 2).eval(), qv)
    ones = {**qv, "quant": {**qv["quant"], "s_w": np.ones(c2, np.float32)}}
    want_acc = np.asarray(jconv.apply(ones, jnp.asarray(x), (2, 2), (2, 2),
                                      method=JaxConv._int8_conv))
    with torch.no_grad():
        args = (nchw(x), conv.w8, conv.s_in, conv.s_w, None,
                conv.conv.stride, conv.conv.padding)
        acc = conv_int8_bn_act(*args, epilogue=False)
        out = conv(nchw(x))
    assert plan_for(*args[:2], *args[5:]).path == "stem"
    assert acc.shape == (2, c2, 32, 32)
    np.testing.assert_array_equal(nhwc(acc), want_acc.astype(np.int32))
    assert np.abs(want_acc).max() > 1000
    want = np.asarray(jconv.apply(qv, jnp.asarray(x), train=False))
    np.testing.assert_allclose(nhwc(out), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _conv_inputs_jax(jm, qv, rgb, ir):
    """{flax path: (input, output)} of every int8 JAX Conv in one eager
    forward (flax's method interceptor)."""
    seen = {}

    def icpt(next_fun, args, kwargs, ctx):
        out = next_fun(*args, **kwargs)
        m = ctx.module
        if (isinstance(m, JaxConv) and ctx.method_name == "__call__"
                and m.has_variable("quant", "w8")):
            seen[m.path] = (np.asarray(args[0]), np.asarray(out))
        return out

    with flax_nn.intercept_methods(icpt):
        jm.apply(qv, jnp.asarray(rgb), jnp.asarray(ir), train=False,
                 decode=True)
    return seen


def test_tiny_int8_forward_matches_jax(tiny):
    """The JAX quant tree (Detect-feeder skip, fusion Dense too) loaded
    into the port: (1) every int8 Conv fed the JAX module's own input
    gives its output (rtol 1e-5, atol 1e-5 of the largest); (2) the whole
    decoded forward, where one fp32 rounding difference upstream can flip
    an x8 at a .5 boundary and the random model amplifies it: the share of
    x8 values that differ is printed and held under 10 % (4 % measured),
    and the decoded predictions lie closer to JAX's int8 forward than
    JAX's int8 lies to its own float forward."""
    jm, v, _, rgb, ir, calib = tiny
    skip = jq.detect_feeder_skip(jax_zoo.tiny_icafusion_config())
    qv = jax.tree.map(np.asarray, jq.quantize_variables(
        v, calib, skip=skip, fusion_dense=True))
    model = load_jax_variables(build_model(zoo.tiny_icafusion_config()), qv)
    back = to_jax_variables(model)["quant"]
    for k, w in _leaves(qv["quant"]):
        np.testing.assert_array_equal(dict(_leaves(back))[k], w)
    seen = _conv_inputs_jax(jm, qv, rgb, ir)
    convs = {tuple(n.split(".")): m for n, m in model.named_modules()
             if isinstance(m, Conv) and m.w8 is not None}
    assert set(seen) == set(convs) and len(convs) == 84
    port_in = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, a, path=path: port_in.__setitem__(path, nhwc(a[0])))
        for path, m in convs.items()]
    with torch.no_grad():
        for path, (x, y) in seen.items():
            got = nhwc(convs[path](nchw(x)))
            np.testing.assert_allclose(got, y, rtol=1e-5,
                                       atol=1e-5 * np.abs(y).max(),
                                       err_msg=str(path))
        port_in.clear()
        got = model(nchw(rgb), nchw(ir)).numpy()
    for h in hooks:
        h.remove()
    differ = total = 0
    for path, (x, _) in seen.items():
        s = convs[path].s_in.numpy()
        x8 = lambda a: np.clip(np.round(a / s), -127, 127)
        differ += int((x8(x) != x8(port_in[path])).sum())
        total += x.size
    share = differ / total
    print(f"x8 values that differ from the JAX forward's: {share:.4f} of "
          f"{total}")
    assert share < 0.10
    fwd = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False,
                                           decode=True)[0])
    want = np.asarray(fwd(qv, jnp.asarray(rgb), jnp.asarray(ir)))
    want_float = np.asarray(fwd(v, jnp.asarray(rgb), jnp.asarray(ir)))
    assert got.shape == want.shape
    for sl in (slice(0, 2), slice(4, None)):      # xy; obj and classes
        err = np.abs(got[..., sl] - want[..., sl])
        quant = np.abs(want[..., sl] - want_float[..., sl])
        assert np.quantile(err, 0.99) < np.quantile(quant, 0.99)
        assert err.mean() < 0.5 * quant.mean()


def test_calib_artifact_crosses_packages(tiny, tmp_path):
    """A .calib written by JAX loads in the port and one written by the
    port loads in JAX, equal; another key gives None; calibrate_cached
    calls batches_fn on a miss only, and a hit returns the stored tree."""
    _, _, model, rgb, ir, calib = tiny
    key = q.calibration_key(extra={"canvas": [PX, PX]})
    assert key == jq.calibration_key(extra={"canvas": [PX, PX]})
    assert key["scheme"] == q.QUANT_SCHEME_VERSION == jq.QUANT_SCHEME_VERSION
    jq.save_calibration(tmp_path / "jax.calib", calib, key)
    q.save_calibration(tmp_path / "port.calib", calib, key)
    for got in (q.load_calibration(tmp_path / "jax.calib", key),
                jq.load_calibration(tmp_path / "port.calib", key)):
        got = dict(_leaves(got))
        for k, w in _leaves(calib):
            np.testing.assert_array_equal(got[k], w)
    other = {**key, "canvas": [PX, 2 * PX]}
    assert q.load_calibration(tmp_path / "jax.calib", other) is None
    assert jq.load_calibration(tmp_path / "port.calib", other) is None
    assert q.load_calibration(tmp_path / "none.calib", key) is None
    (tmp_path / "bad.calib").write_bytes(b"\x00not msgpack")
    assert q.load_calibration(tmp_path / "bad.calib", key) is None
    calls = []

    def batches():
        calls.append(1)
        return [(rgb, ir)]

    path = tmp_path / "cache.calib"
    first, hit = q.calibrate_cached(model, batches, path, key)
    assert not hit and calls == [1] and path.is_file()
    again, hit = q.calibrate_cached(model, batches, path, key)
    assert hit and calls == [1]
    for k, w in _leaves(first):
        np.testing.assert_array_equal(dict(_leaves(again))[k], w)


def test_train_mode_never_quantizes_and_cast_keeps_int8(tiny):
    """A quantized model in train mode computes what its float copy does;
    cast(bfloat16) keeps w8 int8 and s_in, s_w float32 (QLinear's too)."""
    _, v, _, rgb, ir, calib = tiny
    floats = load_jax_variables(build_model(zoo.tiny_icafusion_config()), v)
    quant = q.quantize_model(load_jax_variables(
        build_model(zoo.tiny_icafusion_config()), v), calib)
    assert q.is_quantized(quant) and not q.is_quantized(floats)
    for m in (floats, quant):
        no_dropout(m).train()
    with torch.no_grad():
        a = floats(nchw(rgb), nchw(ir))
        b = quant(nchw(rgb), nchw(ir))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    quant = q.quantize_model(load_jax_variables(
        build_model(zoo.tiny_icafusion_config()), v), calib,
        fusion_dense=True).cast(torch.bfloat16)
    n = 0
    for m in quant.modules():
        if getattr(m, "w8", None) is not None:
            assert m.w8.dtype == torch.int8 and m.s_w.dtype == torch.float32
            if isinstance(m, Conv):
                assert m.s_in.dtype == torch.float32
                assert m.conv.weight.dtype == torch.bfloat16
            n += 1
    assert n == 87 + 18     # every Conv, and 6 QLinear a fusion block


def _uint8_pairs(n, seed=0, hw=(PX, PX)):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (n, *hw, 3), np.uint8)
                 for _ in range(2))


def test_engine_quantize_on_the_cpu(tiny, tmp_path):
    """ServingEngine.quantize calibrates its own model from uint8 pairs,
    quantizes the float weights with the Detect-feeder skip (84 int8
    convs) and serves; the calib and quant trees equal the JAX engine's
    on the same pairs (w8 within one step, the scales within rtol 1e-4:
    each engine calibrates on its own fp32 forward); the cache is
    written on a miss and loaded on a hit; a second quantize raises."""
    from icafusion_tpu.serve.engine import ServingEngine as JaxEngine
    jm, v, model, _, _, _ = tiny
    pairs = [_uint8_pairs(2, 3)]
    kw = dict(img_size=PX, batch_size=2, conf_thres=0.25)
    eng = ServingEngine(model, dtype="float32", device="cpu", **kw)
    assert eng.quantize(pairs, cache=str(tmp_path / "e.calib"),
                        cache_key={"who": "test"}) is False
    assert (tmp_path / "e.calib").is_file()
    assert sum(isinstance(m, Conv) and m.w8 is not None
               for m in eng.model.modules()) == 84
    assert not q.is_quantized(model)
    with pytest.raises(RuntimeError, match="already quantized"):
        eng.quantize(pairs)
    jeng = JaxEngine(model=jm, variables=v, n_devices=1, dtype="float32",
                     merge_streams=0, **kw)
    assert jeng.quantize(pairs) is False
    want = dict(_leaves(jax.tree.map(np.asarray, jeng.variables["quant"])))
    got = dict(_leaves(q.quant_tree(eng.model)))
    assert set(got) == set(want)
    differ = total = 0
    for k, w in want.items():         # calibrated on two fp32 forwards
        if k[-1] == "w8":
            d = np.abs(got[k].astype(int) - w)
            assert d.max() <= 1, k
            differ, total = differ + int((d > 0).sum()), total + d.size
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-4, err_msg=str(k))
    assert differ <= 1e-3 * total, (differ, total)
    rgb, ir = _uint8_pairs(2, 4)
    dets = eng.predict_arrays(rgb, ir)
    assert len(dets) == 2
    for g in dets:
        assert g.shape[1] == 6 and np.isfinite(g).all()
    hit = ServingEngine(model, dtype="float32", device="cpu", **kw)
    assert hit.quantize((), cache=str(tmp_path / "e.calib"),
                        cache_key={"who": "test"}) is True
    for k, w in _leaves(q.quant_tree(eng.model)):
        np.testing.assert_array_equal(dict(_leaves(q.quant_tree(
            hit.model)))[k], w)


def test_http_server_int8_noise_calibration_then_cache_hit(tiny, tmp_path,
                                                          capsys):
    """--int8 without --calib-rgb/--calib-ir calibrates on noise (with the
    warning) and writes <weights>.calib; a second start loads it."""
    _, _, model, _, _, _ = tiny
    ckpt = tmp_path / "w.ckpt"
    ckpt.write_bytes(msgpack_serialize({**to_jax_variables(model),
                                        "meta": {"epoch": 0}}))
    args = http_server.parse_args([
        "--weights", str(ckpt), "--cfg", "zoo:tiny", "--img-size", "64x96",
        "--batch-size", "2", "--device", "cpu", "--int8"])
    engine, batcher = http_server.build(args)
    batcher.close()
    said = capsys.readouterr().out
    assert "noise calibration" in said and "calibrated fresh" in said
    assert (tmp_path / "w.ckpt.calib").is_file()
    assert q.is_quantized(engine.model)
    engine2, batcher2 = http_server.build(args)
    batcher2.close()
    assert "persisted calibration loaded" in capsys.readouterr().out
    rgb, ir = _uint8_pairs(2, 5, (64, 96))
    for a, b in zip(engine.predict_arrays(rgb, ir),
                    engine2.predict_arrays(rgb, ir)):
        np.testing.assert_array_equal(a, b)


def test_http_server_int8_real_pairs(tiny, tmp_path, capsys):
    """--calib-rgb/--calib-ir: up to 16 letterboxed pairs of the folders."""
    import cv2
    _, _, model, _, _, _ = tiny
    for d in ("rgb", "ir"):
        (tmp_path / d).mkdir()
    rgb, ir = _uint8_pairs(3, 6, (48, 80))
    for i in range(3):
        cv2.imwrite(str(tmp_path / "rgb" / f"{i}.png"), rgb[i])
        cv2.imwrite(str(tmp_path / "ir" / f"{i}.png"), ir[i])
    args = http_server.parse_args([
        "--weights", "unused.ckpt", "--cfg", "zoo:tiny", "--img-size", "64",
        "--batch-size", "2", "--device", "cpu", "--int8", "--calib-rgb",
        str(tmp_path / "rgb"), "--calib-ir", str(tmp_path / "ir")])
    calib = http_server.calibration_pairs(args)
    assert "3 real pairs" in capsys.readouterr().out
    assert len(calib) == 1 and calib[0][0].shape == (3, 64, 64, 3)
    eng = ServingEngine(model, 64, 2, dtype="float32", device="cpu")
    assert http_server.quantize_engine(eng, args) is False
    assert q.is_quantized(eng.model)


def test_cli_val_int8_trained_n320_matches_jax(tmp_path):
    """The port's and the JAX package's cli.val --int8 on trained n320 (77
    val pairs at 320, fp32, on the CPU), each on its own copy of the
    checkpoint: mAP@50 within 0.3 points of each other and of the JAX
    package's int8 record (TRAINED_PARITY.json); each persists
    <weights>.calib beside its copy."""
    import json

    from icafusion_tpu.cli import val as jax_val
    from icafusion_tpu_torch.cli import val
    data = tmp_path / "n320.yaml"
    d = N320 / "data"
    data.write_text(f"path: {d}\nval_rgb: visible/val\nval_ir: "
                    "infrared/val\nnc: 3\nnames: ['a', 'b', 'c']\n")
    outs = {}
    for who, main in (("port", val.main), ("jax", jax_val.main)):
        ckpt = tmp_path / who / "stripped.ckpt"
        ckpt.parent.mkdir()
        shutil.copy(N320 / "stripped.ckpt", ckpt)
        argv = ["--weights", str(ckpt), "--cfg", "yolov5n_Transfusion.yaml",
                "--data", str(data), "--img-size", "320", "--batch-size",
                "16", "--int8", "--save-dir", str(tmp_path / who / "run")]
        if who == "port":
            argv += ["--device", "cpu"]
        outs[who] = main(argv)
        assert (tmp_path / who / "stripped.ckpt.calib").is_file()
    record = json.loads((ROOT / "TRAINED_PARITY.json").read_text())
    rec = record["ours"]["int8"]["ref_scored"]["map50"]
    print(f"int8 mAP@50 port {outs['port']['map50']:.5f} JAX "
          f"{outs['jax']['map50']:.5f} record {rec:.5f}")
    assert outs["port"]["seen"] == outs["jax"]["seen"] == 77
    assert abs(outs["port"]["map50"] - outs["jax"]["map50"]) <= 0.003
    assert abs(outs["port"]["map50"] - rec) <= 0.003
