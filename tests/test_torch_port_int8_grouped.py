"""int8 of grouped convs in the port (utils/quantize.quantize_model, the
int8 Conv path and kernels/conv_int8.py's plain version with ``groups``)
against the JAX package's quantize_variables and Conv._int8_conv, on the
CPU: one per-tensor input scale, w8 (Cout, kh, kw, Cin / g) value for
value, int32 accumulators equal to XLA's grouped int8 conv, and the legacy
kitchen-sink graph (GhostConv's depthwise halves, GhostBottleneck's
DWConvs) quantized and run as the JAX package runs it.

MixConv2d sizes its convs from a jnp.linspace, so the kitchen sink's JAX
side runs under jax.ensure_compile_time_eval."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.config import load_model_config as jax_load_model_config
from icafusion_tpu.models.assembler import build_model as jax_build_model
from icafusion_tpu.nn.layers import Conv as JaxConv
from icafusion_tpu.utils import quantize as jq
from icafusion_tpu_torch.config import load_model_config
from icafusion_tpu_torch.kernels import conv_int8 as ci
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.nn.layers import Conv
from icafusion_tpu_torch.smoke.reference import kitchen_sink_yaml
from icafusion_tpu_torch.utils import quantize as q
from icafusion_tpu_torch.utils.convert import load_jax_variables
from test_torch_port_int8 import _conv_inputs_jax, _leaves
from torch_port_common import nchw, nhwc, random_variables

torch.set_num_threads(1)

PX = 64


@pytest.mark.parametrize("c1,c2,k,s,g", [(32, 32, 3, 1, 32),   # depthwise
                                         (32, 48, 3, 2, 2),
                                         (16, 16, 5, 1, 16),   # Ghost's
                                         (24, 48, 1, 1, 4)])
def test_grouped_int8_conv_matches_jax(c1, c2, k, s, g):
    """One grouped Conv with one quant collection: s_in is the JAX
    per-tensor scalar; w8 and s_w equal; the int32 accumulators of the
    plain version with ``groups`` equal the JAX int8 conv's (s_w = 1); the
    module outputs agree within rtol 1e-5 (atol 1e-5 of the largest)."""
    jconv = JaxConv(c1=c1, c2=c2, k=k, s=s, g=g)
    rng = np.random.default_rng(c1 + k + g)
    x = rng.normal(0, 1.5, (2, 13, 18, c1)).astype(np.float32)
    v = random_variables(jconv, jnp.asarray(x), train=False)
    _, mut = jconv.apply(v, jnp.asarray(x), train=False, mutable=["calib"])
    calib = jax.tree.map(np.asarray, mut["calib"])
    qv = jax.tree.map(np.asarray, jq.quantize_variables(v, calib))
    conv = load_jax_variables(Conv(c1, c2, k, s, g=g).eval(), v)
    q.quantize_model(conv, calib)
    assert conv.s_in.shape == () and qv["quant"]["s_in"].shape == ()
    np.testing.assert_array_equal(conv.s_in.numpy(), qv["quant"]["s_in"])
    np.testing.assert_array_equal(conv.s_w.numpy(), qv["quant"]["s_w"])
    np.testing.assert_array_equal(conv.w8.permute(1, 2, 3, 0).numpy(),
                                  qv["quant"]["w8"])
    assert tuple(conv.w8.shape) == (c2, k, k, c1 // g)
    ones = {**qv, "quant": {**qv["quant"], "s_w": np.ones(c2, np.float32)}}
    want_acc = np.asarray(jconv.apply(ones, jnp.asarray(x), (s, s),
                                      (k // 2, k // 2),
                                      method=JaxConv._int8_conv))
    with torch.no_grad():
        acc = ci.conv_int8_bn_act(nchw(x), conv.w8, conv.s_in, conv.s_w,
                                  None, conv.conv.stride, conv.conv.padding,
                                  epilogue=False, groups=g)
        out = conv(nchw(x))
    np.testing.assert_array_equal(nhwc(acc), want_acc.astype(np.int32))
    assert np.abs(want_acc).max() > 100
    want = np.asarray(jconv.apply(qv, jnp.asarray(x), train=False))
    np.testing.assert_allclose(nhwc(out), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_plan_sends_a_grouped_conv_to_the_grouped_path():
    """Every grouped conv at stride 1 or 2 with kw 1, 3, 5 or 7 takes the
    "grouped" path, in any layout (NCHW here); stride 3 and kw 2 keep the
    first design's direct path, which takes groups too."""
    pl = ci.plan(4, 64, 20, 20, 64, 3, 3, 1, 1, torch.bfloat16,
                 conv_groups=64)
    assert (pl.path, pl.reason) == ("grouped", "grouped")
    assert ci.plan(4, 64, 20, 20, 64, 3, 3, 1, 1, torch.bfloat16).path \
        == "tma"
    x = torch.zeros(1, 64, 8, 8)
    assert ci.plan_for(x, torch.zeros(64, 3, 3, 1, dtype=torch.int8), 1, 1,
                       groups=64).path == "grouped"
    for c1, c2, k, s, g in ((32, 32, 3, 1, 32), (32, 48, 3, 2, 2),
                            (16, 16, 5, 1, 16), (24, 48, 1, 1, 4)):
        assert ci.plan(2, c1, 13, 18, c2, k, k, s, k // 2,
                       conv_groups=g).path == "grouped"
    assert ci.plan(2, 32, 13, 18, 32, 3, 3, 3, 1,
                   conv_groups=32).path == "direct"
    assert ci.plan(2, 32, 13, 18, 32, 2, 2, 1, 0,
                   conv_groups=32).path == "direct"


@pytest.fixture(scope="module")
def kitchen_sink():
    """(JAX model, float variables, calib tree, rgb, ir) of the kitchen-sink
    graph at 64 px, batch 2."""
    jm = jax_build_model(jax_load_model_config(kitchen_sink_yaml()))
    rng = np.random.default_rng(3)
    rgb, ir = (rng.uniform(0, 1, (2, PX, PX, 3)).astype(np.float32)
               for _ in range(2))
    with jax.ensure_compile_time_eval():
        v = random_variables(jm, jnp.asarray(rgb), jnp.asarray(ir),
                             train=False)
        calib = jq.calibrate(jm, v, [(jnp.asarray(rgb), jnp.asarray(ir))])
    return jm, v, calib, rgb, ir


def _port(v):
    return load_jax_variables(build_model(load_model_config(
        kitchen_sink_yaml())), v)


def test_kitchen_sink_quantizes_as_jax(kitchen_sink):
    """quantize_model on the kitchen-sink graph fills exactly the convs
    quantize_variables quantizes (its grouped ones among them, each with a
    scalar s_in) with the same w8, s_w and s_in."""
    _, v, calib, _, _ = kitchen_sink
    skip = jq.detect_feeder_skip(jax_load_model_config(kitchen_sink_yaml()))
    assert skip == q.detect_feeder_skip(load_model_config(
        kitchen_sink_yaml()))
    want = dict(_leaves(jax.tree.map(np.asarray, jq.quantize_variables(
        v, calib, skip=skip)["quant"])))
    got = dict(_leaves(q.quant_tree(q.quantize_model(_port(v), calib,
                                                     skip=skip))))
    assert set(got) == set(want)
    grouped = [k[:-1] for k, w in want.items()
               if k[-1] == "s_in" and w.shape == ()]
    assert len(grouped) >= 8, grouped      # Ghost/DWConv halves, 2 streams
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=str(k))


def test_kitchen_sink_int8_forward_matches_jax(kitchen_sink):
    """The JAX quant tree loaded into the port: every int8 Conv fed the
    JAX module's own input gives its output (rtol 1e-5, atol 1e-5 of the
    largest), grouped ones included; the whole decoded int8 forward lies
    closer to JAX's int8 forward than JAX's int8 lies to its float one
    (the criterion of test_tiny_int8_forward_matches_jax)."""
    jm, v, calib, rgb, ir = kitchen_sink
    qv = jax.tree.map(np.asarray, jq.quantize_variables(v, calib))
    model = _port(qv)
    with jax.ensure_compile_time_eval():
        seen = _conv_inputs_jax(jm, qv, rgb, ir)
        fwd = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False,
                                               decode=True)[0])
        want = np.asarray(fwd(qv, jnp.asarray(rgb), jnp.asarray(ir)))
        want_float = np.asarray(fwd(v, jnp.asarray(rgb), jnp.asarray(ir)))
    convs = {tuple(n.split(".")): m for n, m in model.named_modules()
             if isinstance(m, Conv) and m.w8 is not None}
    assert set(seen) == set(convs)
    assert sum(m.conv.groups > 1 for m in convs.values()) >= 8
    with torch.no_grad():
        for path, (x, y) in seen.items():
            got = nhwc(convs[path](nchw(x)))
            np.testing.assert_allclose(got, y, rtol=1e-5,
                                       atol=1e-5 * np.abs(y).max(),
                                       err_msg=str(path))
        got = model(nchw(rgb), nchw(ir)).numpy()
    assert got.shape == want.shape
    for sl in (slice(0, 2), slice(4, None)):      # xy; obj and classes
        err = np.abs(got[..., sl] - want[..., sl])
        quant = np.abs(want[..., sl] - want_float[..., sl])
        assert np.quantile(err, 0.99) < np.quantile(quant, 0.99)
        assert err.mean() < 0.5 * quant.mean()
