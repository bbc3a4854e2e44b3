"""The port's fused 3x3 Conv + BatchNorm + SiLU (64 channels) against the
JAX package: the plain version against the Pallas kernel in interpret mode,
and the port's eval-mode Conv, which routes that shape through the fused
call, against the flax Conv."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.kernels.packed_conv import pack_weights, packed_conv3x3_silu
from icafusion_tpu.nn import layers as jax_layers
from icafusion_tpu_torch.kernels.packed_conv import (conv3x3_bn_silu,
                                                     conv3x3_bn_silu_reference)
from icafusion_tpu_torch.nn import layers
from icafusion_tpu_torch.utils.convert import load_jax_variables
from torch_port_common import nchw, nhwc, random_variables

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(2, 32, 20), (1, 16, 12)])
def test_reference_matches_pallas_interpret(shape):
    """The shapes and inputs of tests/test_pallas_kernels.py::
    test_packed_conv_interpret. The Pallas kernel stores the folded weights
    w * s in bf16, so the port's plain version gets those rounded weights
    divided by s, as the JAX test's reference does; rtol/atol 1e-4 as
    there."""
    B, H, W = shape
    C = 64
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = rng.standard_normal((3, 3, C, C)).astype(np.float32) * 0.1
    s = rng.standard_normal(C).astype(np.float32) * 0.5 + 1.0
    b = rng.standard_normal(C).astype(np.float32) * 0.1
    w6, bias2 = pack_weights(w, s, b)
    want = np.asarray(packed_conv3x3_silu(jnp.asarray(x), w6, bias2,
                                          interpret=True))
    wf = np.asarray((w * s).astype(jnp.bfloat16), np.float32) / s   # HWIO
    got = conv3x3_bn_silu(nchw(x), torch.from_numpy(wf.transpose(3, 2, 0, 1)
                                                    .copy()),
                          torch.from_numpy(s), torch.from_numpy(b))
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-4, atol=1e-4)


def test_reference_keeps_dtype_and_rounds_once():
    """bf16 in, bf16 out: the plain version computes in fp32 and rounds
    the activation once, so it equals the fp32 result cast to bf16."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 64, 5, 7)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 64, 3, 3))
                         .astype(np.float32) * 0.05)
    s = torch.ones(64)
    b = torch.zeros(64)
    xb, wb = x.bfloat16(), w.bfloat16()
    got = conv3x3_bn_silu_reference(xb, wb, s, b)
    assert got.dtype == torch.bfloat16
    want = conv3x3_bn_silu_reference(xb.float(), wb.float(), s, b).bfloat16()
    assert torch.equal(got, want)


@pytest.mark.parametrize("hw", [(16, 16), (7, 5)])
def test_conv_64_matches_flax(hw, monkeypatch):
    """Conv(64, 64, 3, 1) in eval mode, BatchNorm statistics away from
    identity, through the fused call (spied on); fp32 at the tolerance of
    tests/test_torch_port_layers.py."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, *hw, 64)).astype(np.float32)
    jmod = jax_layers.Conv(64, 64, 3, 1)
    v = random_variables(jmod, jnp.asarray(x), train=False)
    want = np.asarray(jax.jit(lambda v, x: jmod.apply(v, x, train=False))(
        v, jnp.asarray(x)))
    mod = load_jax_variables(layers.Conv(64, 64, 3, 1).eval(), v)
    calls = []
    monkeypatch.setattr(layers, "conv3x3_bn_silu",
                        lambda *a: calls.append(1) or conv3x3_bn_silu(*a))
    with torch.no_grad():
        got = nhwc(mod(nchw(x)))
    assert calls == [1]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("args,fused", [
    ((64, 64, 3, 1), True),
    ((64, 64, 3, 2), False),          # stride 2
    ((64, 64, 1, 1), False),          # 1x1
    ((64, 128, 3, 1), False),         # 64 -> 128
    ((64, 64, 3, 1, None, 1, False), False),   # no activation
    ((64, 64, 3, 1, None, 2), False),          # grouped
])
def test_only_the_64_channel_3x3_is_fused(args, fused, monkeypatch):
    """The route depends on the shape and the mode only: eval mode takes
    the fused call for the one shape, training mode never does. Either way
    the result is conv -> BatchNorm -> activation."""
    calls = []
    monkeypatch.setattr(layers, "conv3x3_bn_silu",
                        lambda *a: calls.append(1) or conv3x3_bn_silu(*a))
    mod = layers.Conv(*args)
    assert mod.fused is fused
    x = torch.randn(2, args[0], 6, 6, generator=torch.Generator()
                    .manual_seed(0))
    with torch.no_grad():
        mod.train()(x)                   # moves the running statistics
        assert calls == []
        mod.eval()
        want = mod.act(mod.bn(mod.conv(x)))
        got = mod(x)
    assert len(calls) == int(fused)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_other_devices():
    x = torch.zeros(1, 64, 4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv3x3_bn_silu(x, torch.zeros(64, 64, 3, 3), torch.ones(64),
                        torch.zeros(64))
