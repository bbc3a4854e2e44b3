"""Stream merging in the port (utils/stream_merge.py, ICAFusionModel's
merge_pairs, the CLI loader) against the JAX package's, on the CPU: the
cases of tests/test_stream_merge.py with the same seeded inputs and
variables on both sides. The VGG16 and ResNet50 towers and repeated rows
are in test_torch_port_stream_merge_models.py, merged training in
test_torch_port_stream_merge_train.py.

Variables. The forward and int8 cases run on the JAX model's own init
(PRNGKey(0)), as tests/test_stream_merge.py does, and hold the merged
forward to the JAX merged model and to the port's unmerged forward at
rtol = atol = 1e-5, JAX's gate there. The state transforms are checked,
exactly, on variables drawn from a numpy seed (torch_port_common:
BatchNorm statistics away from identity, so that a misplaced statistic
shows). On those drawn variables the forward is checked too, at rtol 1e-4
and atol 1e-5 of the largest output: there the port's unmerged forward
already lies 5.1e-5 (relative) from JAX's, and JAX's own merged forward
5.0e-5 from its unmerged one (measured), so 1e-5 holds on neither side."""

import dataclasses
import glob
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp

from icafusion_tpu.models import zoo as jax_zoo
from icafusion_tpu.models.assembler import ResolvedLayer as JaxResolved
from icafusion_tpu.models.assembler import build_model as jax_build
from icafusion_tpu.models.assembler import resolve_model as jax_resolve
from icafusion_tpu.nn.layers import Conv as JaxConv
from icafusion_tpu.utils import quantize as jq
from icafusion_tpu.utils import stream_merge as jsm
from icafusion_tpu_torch.config import load_model_config
from icafusion_tpu_torch.models import zoo
from icafusion_tpu_torch.models.assembler import (ResolvedLayer,
                                                  build_model, resolve_model)
from icafusion_tpu_torch.nn.layers import Conv
from icafusion_tpu_torch.utils import quantize as q
from icafusion_tpu_torch.utils import stream_merge as sm
from icafusion_tpu_torch.utils.convert import (load_jax_variables,
                                               to_jax_variables)
from torch_port_common import nchw, nhwc, random_variables

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PX = 64
TOL = dict(rtol=1e-5, atol=1e-5)


def _jfwd(jm, decode=True):
    return jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False,
                                            decode=decode))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_equal(a, b):
    a, b = dict(_leaves(a)), dict(_leaves(b))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def _inputs(n, px):
    rng = np.random.default_rng(0)
    return tuple(rng.uniform(0, 1, (n, px, px, 3)).astype(np.float32)
                 for _ in range(2))


def _jax_init(jcfg, rgb, ir):
    """{"params", "batch_stats"} of the JAX model's own init, numpy."""
    init = jax.jit(jax_build(jcfg).init, static_argnames=("train",
                                                          "decode"))
    v = init({"params": jax.random.PRNGKey(0)}, jnp.asarray(rgb),
             jnp.asarray(ir), train=False, decode=False)
    return jax.tree.map(np.asarray, {"params": v["params"],
                                     "batch_stats": v.get("batch_stats",
                                                          {})})


@pytest.fixture(scope="module")
def setup():
    """(port config, JAX config, the JAX init's variables, the port model
    holding them, rgb, ir): the tiny model at 64 px, batch 2."""
    cfg, jcfg = zoo.tiny_icafusion_config(), jax_zoo.tiny_icafusion_config()
    rgb, ir = _inputs(2, PX)
    v = _jax_init(jcfg, rgb, ir)
    return cfg, jcfg, v, load_jax_variables(build_model(cfg), v), rgb, ir


@pytest.fixture(scope="module")
def drawn(setup):
    """The same with variables drawn from a numpy seed."""
    cfg, jcfg, _, _, rgb, ir = setup
    v = random_variables(jax_build(jcfg), jnp.asarray(rgb), jnp.asarray(ir),
                         train=False, decode=False)
    return cfg, jcfg, v, load_jax_variables(build_model(cfg), v), rgb, ir


@pytest.mark.parametrize("k", [1, 3, 5, 9])
def test_merged_state_equals_jax_merged_variables(drawn, k):
    """merge_stream_state of the port's state equals the JAX merged
    variables loaded into the merged port model, tensor for tensor, and
    to_jax_variables writes the JAX merged variables back exactly."""
    cfg, jcfg, v, model, _, _ = drawn
    mv = jsm.merge_stream_variables(jcfg, v, pairs=k)
    want = load_jax_variables(build_model(cfg, merge_pairs=k), mv)
    got = sm.merge_stream_state(cfg, model.state_dict(), k)
    sd = want.state_dict()
    assert got.keys() == sd.keys()
    for name in sd:
        assert torch.equal(got[name], sd[name]), name
    _assert_trees_equal(to_jax_variables(want), mv)


@pytest.mark.parametrize("k", [1, 3, 5, 9])
def test_fp_parity(setup, drawn, k):
    """The merged forward (k = 5 saves the sliced layer 4 for the first
    fusion block; k = 9 merges the whole backbone, SPPF's interleaved
    4-segment concat included) against the JAX merged model and against
    the port's unmerged forward, NCHW and channels_last input alike; then
    on the drawn variables at their tolerance."""
    for (cfg, jcfg, v, model, rgb, ir), tol in ((setup, None),
                                                (drawn, 1e-4)):
        mv = jsm.merge_stream_variables(jcfg, v, pairs=k)
        want = np.asarray(_jfwd(jax_build(jcfg, merge_pairs=k))(
            mv, jnp.asarray(rgb), jnp.asarray(ir))[0])
        mm = sm.merged_model(model, k)
        assert mm.merge_pairs == k and not hasattr(mm, "m0")
        x, y = nchw(rgb), nchw(ir)
        with torch.no_grad():
            ref = model(x, y).numpy()
            got = mm(x, y).numpy()
            cl = mm(x.contiguous(memory_format=torch.channels_last),
                    y.contiguous(memory_format=torch.channels_last)).numpy()
        kw = TOL if tol is None else dict(
            rtol=tol, atol=1e-5 * np.abs(want).max())
        for a, b in ((got, want), (got, ref), (cl, ref)):
            np.testing.assert_allclose(a, b, **kw)


def _conv_io_jax(jm, qv, rgb, ir):
    """{flax path: (input, output)} of every int8 JAX Conv in one eager
    forward."""
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


def test_int8_composition(drawn):
    """Merge, then calibrate and quantize, on the drawn variables (their
    activations keep their scale through the towers). (1) The port's
    calibration of the merged model has JAX's paths, the merged stem's
    absmax equal and the rest within rtol 1e-4, as
    test_torch_port_int8.test_calibrate_matches_jax holds it; its
    quantize_model on JAX's merged calibration writes JAX's merged quant
    tree exactly; (2) every int8 Conv of the merged model fed the JAX
    module's input gives its output (1e-5 of the largest); (3)
    test_int8_composition's gate: the port's merged int8 forward within
    1e-4 of its unmerged int8 forward (the zero blocks add exact int32
    zeros)."""
    cfg, jcfg, v, model, rgb, ir = drawn
    skip = q.detect_feeder_skip(cfg)
    mv = jsm.merge_stream_variables(jcfg, v, pairs=3)
    jmm = jax_build(jcfg, merge_pairs=3)
    jcal = jq.calibrate(jmm, mv, [(rgb, ir)])
    qmv = jax.tree.map(np.asarray, jq.quantize_variables(dict(mv), jcal,
                                                          skip=skip))
    mm = sm.merged_model(model, 3)
    pcal = q.calibrate(mm, [(rgb, ir)])
    want = dict(_leaves(jcal))
    assert dict(_leaves(pcal)).keys() == want.keys()
    np.testing.assert_array_equal(pcal["m0_9"]["absmax"],
                                  want[("m0_9", "absmax")])
    for k, a in _leaves(pcal):
        np.testing.assert_allclose(a, want[k], rtol=1e-4, err_msg=str(k))
    q.quantize_model(mm, jax.tree.map(np.asarray, jcal), skip=skip)
    _assert_trees_equal(to_jax_variables(mm)["quant"], qmv["quant"])

    convs = {tuple(n.split(".")): m for n, m in mm.named_modules()
             if isinstance(m, Conv) and m.w8 is not None}
    seen = _conv_io_jax(jmm, qmv, rgb, ir)
    assert set(seen) == set(convs) and ("m0_9",) in convs
    with torch.no_grad():
        for path, (x, y) in seen.items():
            got = nhwc(convs[path](nchw(x)))
            np.testing.assert_allclose(got, y, rtol=1e-5,
                                       atol=1e-5 * np.abs(y).max(),
                                       err_msg=str(path))

    def int8(m):
        m = q.quantize_model(m, q.calibrate(m, [(rgb, ir)]), skip=skip)
        with torch.no_grad():
            return m(nchw(rgb), nchw(ir), raw=True)[1]

    ref = int8(load_jax_variables(build_model(cfg), v))
    got = int8(sm.merged_model(model, 3))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-4)


def _fake_pair(module, args, c2):
    return tuple(ResolvedLayer(i=i, f=f, n=1, module=module, args=args,
                               c2=c2) for i, f in ((0, -1), (1, -4)))


def _errors(port_fn, jax_fn):
    """(port message, JAX message) of the ValueError each raises."""
    out = []
    for fn in (port_fn, jax_fn):
        with pytest.raises(ValueError) as e:
            fn()
        out.append(str(e.value))
    return out


def _with_rows(cfg, rows):
    layers = list(cfg.layers)
    for idx, kw in rows.items():
        layers[idx] = dataclasses.replace(layers[idx], **kw)
    return dataclasses.replace(cfg, layers=tuple(layers))


def test_validation_errors_word_for_word(setup):
    """Each refusal of validate_merge and ir_stream_start in JAX's words:
    a count out of range, an unmergeable module, layers that differ, a
    chain broken inside the merged block and after it, the missing IR
    input, a grouped Conv and a C3 with explicit e."""
    cfg, jcfg, _, _, _, _ = setup
    res, jres = resolve_model(cfg)[0], jax_resolve(jcfg)[0]
    cases = [
        (lambda: sm.validate_merge(res, 99),
         lambda: jsm.validate_merge(jres, 99), "merge_pairs must be in"),
        (lambda: sm.ir_stream_start(res[:8]),
         lambda: jsm.ir_stream_start(jres[:8]), "no layer takes the -4"),
    ]
    for module, args in (("Focus", (3, 16, 1)),
                         ("Conv", (3, 16, 3, 1, None, 2))):
        fake = _fake_pair(module, args, 16)
        jfake = tuple(JaxResolved(**dataclasses.asdict(r)) for r in fake)
        cases.append((lambda f=fake: sm.validate_merge(f, 1),
                      lambda f=jfake: jsm.validate_merge(f, 1),
                      "not stream-mergeable" if module == "Focus"
                      else "grouped Conv"))
    a = ResolvedLayer(i=0, f=-1, n=1, module="Conv", args=(3, 16, 3), c2=16)
    b = ResolvedLayer(i=1, f=-4, n=1, module="Conv", args=(3, 32, 3), c2=32)
    cases.append((lambda: sm.validate_merge((a, b), 1),
                  lambda: jsm.validate_merge(tuple(
                      JaxResolved(**dataclasses.asdict(r)) for r in (a, b)),
                      1), "differ"))
    chain = _with_rows(cfg, {10: {"f": 9}})
    jchain = _with_rows(jcfg, {10: {"f": 9}})
    cases.append((lambda: sm.validate_merge(resolve_model(chain)[0], 2),
                  lambda: jsm.validate_merge(jax_resolve(jchain)[0], 2),
                  "plain chains"))
    cases.append((lambda: sm.validate_merge(resolve_model(chain)[0], 1),
                  lambda: jsm.validate_merge(jax_resolve(jchain)[0], 1),
                  "must chain on the previous layer"))
    rows = {i: {"args": cfg.layers[i].args + (True, 1, 0.25)}
            for i in (2, 11)}
    e_cfg, je_cfg = _with_rows(cfg, rows), _with_rows(jcfg, rows)
    cases.append((lambda: sm.validate_merge(resolve_model(e_cfg)[0], 3),
                  lambda: jsm.validate_merge(jax_resolve(je_cfg)[0], 3),
                  "explicit g/e"))
    for port_fn, jax_fn, words in cases:
        got, want = _errors(port_fn, jax_fn)
        assert got == want and words in got
    # the merged model refuses them at build time too
    with pytest.raises(ValueError, match="explicit g/e"):
        build_model(e_cfg, merge_pairs=3)
    with pytest.raises(ValueError, match="already stream-merged"):
        sm.merged_model(sm.merged_model(build_model(cfg), 1), 1)


@pytest.mark.parametrize("k", [3, 9])
def test_unmerge_roundtrip(drawn, k):
    """unmerge after merge gives the original state bit for bit, the
    BatchNorm counters included; a quantized state refuses to merge."""
    cfg, _, _, model, rgb, ir = drawn
    sd = model.state_dict()
    rt = sm.unmerge_stream_state(cfg, sm.merge_stream_state(cfg, sd, k), k)
    assert rt.keys() == sd.keys()
    for name in sd:
        assert torch.equal(rt[name], sd[name]), name
    back = sm.unmerged_model(sm.merged_model(model, k))
    for name, t in back.state_dict().items():
        assert torch.equal(t, sd[name]), name
    qm = q.quantize_model(build_model(cfg), q.calibrate(
        load_jax_variables(build_model(cfg), to_jax_variables(model)),
        [(rgb, ir)]))
    with pytest.raises(ValueError, match="merge before adding the 'quant'"):
        sm.merge_stream_state(cfg, qm.state_dict(), k)


def test_capture_conflict(setup):
    """capture=/overrides= of a merged layer raise JAX's ValueError; an
    unmerged layer is captured as before."""
    cfg, _, _, model, rgb, ir = setup
    mm = sm.merged_model(model, 3)
    x, y = nchw(rgb), nchw(ir)
    with torch.no_grad():
        for kw in ({"capture": (1,)}, {"overrides": {10: x}}):
            with pytest.raises(ValueError, match="capture/overrides"):
                mm(x, y, **kw)
        (_, cap) = mm(x, y, capture=(4,))
        (_, want) = model(x, y, capture=(4,))
    assert 4 in cap
    np.testing.assert_allclose(cap[4].numpy(), want[4].numpy(), **TOL)


def test_auto_merge_pairs_on_every_shipped_config():
    """auto_merge_pairs equals JAX's on every shipped YAML and zoo scale
    (yolov5l 3, s 5, n 7; VGG16 and ResNet50 2), while resolve_merge keeps
    "auto" at 0 in the port; a count or a numeric string is itself."""
    from icafusion_tpu.config import load_model_config as jax_load
    yamls = sorted(glob.glob(str(ROOT / "configs" / "models" / "*.yaml")))
    assert len(yamls) == 21
    for y in yamls:
        assert (sm.auto_merge_pairs(load_model_config(y))
                == jsm.auto_merge_pairs(jax_load(y))), y
    for scale, k in (("l", 3), ("s", 5), ("n", 7)):
        assert sm.auto_merge_pairs(zoo.icafusion_config(scale, nc=3)) == k
    for name in ("vgg16", "resnet50"):
        assert sm.auto_merge_pairs(getattr(
            zoo, f"{name}_icafusion_config")(nc=3)) == 2
    lcfg = zoo.icafusion_config("l", nc=3)
    assert jsm.resolve_merge("auto", jax_zoo.icafusion_config("l", nc=3)) == 3
    assert sm.resolve_merge("auto", lcfg) == 0
    assert sm.resolve_merge("2", lcfg) == 2 == sm.resolve_merge(2, lcfg)
    assert sm.resolve_merge(0, lcfg) == 0 == sm.resolve_merge(None, lcfg)
    with pytest.raises(ValueError, match="merge_pairs must be in"):
        sm.resolve_merge(11, lcfg)


def test_cli_loader_merged(setup, tmp_path):
    """load_model_for_inference(merge=2) on a .ckpt reads the standard
    weights and serves the merged graph: its decoded predictions against
    the JAX loader's at merge=2 (2e-5, JAX's gate). Engines at
    merge_streams=2 key their calibration by the count, so a .calib the
    JAX engine writes at 2 is a hit for the port's engine at 2, and the
    reverse, with the same absmax tree."""
    from icafusion_tpu.cli._common import (
        load_model_for_inference as jax_load)
    from icafusion_tpu_torch.cli._common import load_model_for_inference
    from icafusion_tpu_torch.serve.engine import ServingEngine
    from icafusion_tpu_torch.utils.checkpoint import msgpack_serialize
    _, _, v, model, rgb, ir = setup
    ckpt = tmp_path / "tiny.ckpt"
    ckpt.write_bytes(msgpack_serialize({**v, "meta": {"epoch": 0}}))
    _, mm = load_model_for_inference("zoo:tiny", str(ckpt), merge="2")
    assert mm.merge_pairs == 2
    _, jm, jv = jax_load("zoo:tiny", str(ckpt), merge=2)
    want = np.asarray(jm.apply(jv, jnp.asarray(rgb), jnp.asarray(ir),
                               train=False, decode=True)[0])
    with torch.no_grad():
        got = mm(nchw(rgb), nchw(ir)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    _, plain = load_model_for_inference("zoo:tiny", str(ckpt), merge="auto")
    assert plain.merge_pairs == 0
    from icafusion_tpu.serve.engine import ServingEngine as JaxEngine
    u8 = lambda a: (a * 255).astype(np.uint8)
    pairs = [(u8(rgb), u8(ir))]
    key = q.calibration_key(merge=2, extra={"canvas": [PX, PX], "set": "a"})

    def engines():
        return (ServingEngine(plain, PX, 2, dtype="float32", device="cpu",
                              merge_streams=2),
                JaxEngine(model=jax_build(setup[1]), variables=setup[2],
                          img_size=PX, batch_size=2, n_devices=1,
                          dtype="float32", merge_streams=2))

    for writer, path in ((1, tmp_path / "jax.calib"),
                         (0, tmp_path / "port.calib")):
        eng = engines()
        assert eng[0].merge_streams == 2 and eng[0].model.merge_pairs == 2
        assert eng[writer].quantize(pairs, cache=str(path),
                                    cache_key={"set": "a"}) is False
        assert eng[1 - writer].quantize(pairs, cache=str(path),
                                        cache_key={"set": "a"}) is True
        written = q.load_calibration(path, key)
        assert written is not None and "m0_9" in written
        _assert_trees_equal(written, jq.load_calibration(path, key))
