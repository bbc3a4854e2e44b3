"""Grad-CAM and ensembles in the port (models/gradcam.py, models/ensemble.py,
the model's capture/overrides/logits keywords) against the JAX package's,
and the gradient rules of the kernel wrappers: the float kernels'
autograd paths (their backward is the plain version's vjp) and the
refusals of the int8 conv and NMS under grad, on the CPU.

The tiny tfb model at 64 px, batch 2, flax variables from
tests/torch_port_common.random_variables."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.models import zoo as jax_zoo
from icafusion_tpu.models.assembler import build_model as jax_build_model
from icafusion_tpu.models.ensemble import ensemble_predict as jax_ensemble
from icafusion_tpu.models.gradcam import default_cam_layers as jax_cam_layers
from icafusion_tpu.models.gradcam import gradcam_saliency as jax_gradcam
from icafusion_tpu_torch.kernels import cross_attention, nms, packed_conv
from icafusion_tpu_torch.kernels.conv_int8 import conv_int8_bn_act
from icafusion_tpu_torch.models import zoo
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.models.ensemble import ensemble_predict
from icafusion_tpu_torch.models.gradcam import (default_cam_layers,
                                                gradcam_saliency)
from icafusion_tpu_torch.utils.convert import load_jax_variables
from torch_port_common import nchw, nhwc, random_variables

torch.set_num_threads(1)

PX = 64
BACKBONE = 4        # a C3 of the RGB tower, before the fusion blocks


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, variables, port model, rgb, ir) at 64 px, batch 2."""
    jm = jax_build_model(jax_zoo.tiny_icafusion_config(nc=3))
    rng = np.random.default_rng(11)
    rgb, ir = (rng.uniform(0, 1, (2, PX, PX, 3)).astype(np.float32)
               for _ in range(2))
    v = random_variables(jm, jnp.asarray(rgb), jnp.asarray(ir), train=False)
    model = load_jax_variables(build_model(zoo.tiny_icafusion_config(nc=3)),
                               v)
    return jm, v, model, rgb, ir


def test_capture_overrides_and_logits_match_jax(tiny):
    """capture returns (outputs, {layer: activation}); overrides replace a
    layer's output downstream; logits is Detect's raw class stream in the
    JAX order. Each against the JAX apply with the same keywords."""
    jm, v, model, rgb, ir = tiny
    x, y = jnp.asarray(rgb), jnp.asarray(ir)
    layers = (BACKBONE,) + default_cam_layers(model.cfg)
    (pred, logits, _), caps = jm.apply(v, x, y, train=False, decode=True,
                                       capture=layers)
    with torch.no_grad():
        (got_pred, got_logits), got_caps = model(nchw(rgb), nchw(ir),
                                                 logits=True, capture=layers)
    assert set(got_caps) == set(layers)
    for i in layers:
        np.testing.assert_allclose(nhwc(got_caps[i]), np.asarray(caps[i]),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(pred), rtol=1e-3,
                               atol=1e-3)
    assert got_logits.shape == logits.shape == (2, pred.shape[1], 3)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits),
                               rtol=1e-4, atol=1e-4)
    a = np.asarray(caps[BACKBONE]) * 0.5 + 0.25
    want = jm.apply(v, x, y, train=False, decode=True,
                    overrides={BACKBONE: jnp.asarray(a)})[0]
    with torch.no_grad():
        got = model(nchw(rgb), nchw(ir), overrides={BACKBONE: nchw(a)})
        plain = model(nchw(rgb), nchw(ir))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)
    assert not torch.allclose(got, plain, atol=1e-2)


def test_gradcam_saliency_matches_jax(tiny):
    """Saliency at Detect's first input and at a backbone layer (the
    gradient then crosses the fusion attention and the 64-channel convs),
    with the strongest class and with class_idx, upsampled to the input:
    within 1e-4 of the JAX saliency (one jit of all four)."""
    jm, v, model, rgb, ir = tiny
    assert default_cam_layers(model.cfg) == jax_cam_layers(jm.cfg)
    head = default_cam_layers(model.cfg)[0]
    cases = ((head, None, None), (BACKBONE, None, (PX, PX)),
             (head, 2, None), (BACKBONE, 1, None))
    want = jax.jit(lambda v, a, b: [
        jax_gradcam(jm, v, a, b, layer, class_idx=c, upsample_to=up)
        for layer, c, up in cases])(v, jnp.asarray(rgb), jnp.asarray(ir))
    lit = 0
    for (layer, c, up), w in zip(cases, want):
        got = gradcam_saliency(model, nchw(rgb), nchw(ir), layer,
                               class_idx=c, upsample_to=up)
        assert not got.requires_grad and got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=str((layer, c, up)))
        lit += int((got.amax(dim=(1, 2)) > 0.99).sum())
    assert lit >= 4, lit       # images whose map is not all zero (of 8)
    assert all(p.grad is None for p in model.parameters())


def test_ensemble_predict_matches_jax(tiny):
    """Two members (the fixture's weights and another draw): predictions
    and logits concatenated in member order, as the JAX ensemble."""
    jm, v, model, rgb, ir = tiny
    v2 = random_variables(jm, jnp.asarray(rgb), jnp.asarray(ir), seed=5,
                          train=False)
    other = load_jax_variables(build_model(zoo.tiny_icafusion_config(nc=3)),
                               v2)
    pred, logits = jax_ensemble([(jm, v), (jm, v2)], jnp.asarray(rgb),
                                jnp.asarray(ir))
    with torch.no_grad():
        got_pred, got_logits = ensemble_predict([model, other], nchw(rgb),
                                                nchw(ir))
        own = model(nchw(rgb), nchw(ir))
    n = own.shape[1]
    assert got_pred.shape == (2, 2 * n, 8) and torch.equal(got_pred[:, :n],
                                                           own)
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(pred),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits),
                               rtol=1e-4, atol=1e-4)


def _attention_args(requires_grad):
    g = torch.Generator().manual_seed(0)
    t = lambda *s, std=1.0: (torch.randn(*s, generator=g) * std
                             ).requires_grad_(requires_grad)
    return (t(2, 7, 32), t(2, 7, 32), [t(32, 32, std=0.2) for _ in range(6)],
            [t(32, std=0.1) for _ in range(6)])


def test_float_kernel_autograd_paths_give_the_plain_gradients(monkeypatch):
    """The autograd Functions the card's wrappers take under grad, run
    here with the plain version in the kernel's place: gradients for every
    input equal autograd's through the plain version, and the launch runs
    once a forward. (On the card: tests/test_torch_port_cuda.py.)"""
    calls = []

    def plain(fn):
        return lambda *a: calls.append(1) or fn(*a)

    monkeypatch.setattr(cross_attention, "launch", plain(
        cross_attention.dual_cross_attention_reference))
    monkeypatch.setattr(packed_conv, "launch", plain(
        packed_conv.conv3x3_bn_silu_reference))
    vis, ir, ws, bs = _attention_args(True)
    out = cross_attention.DualCrossAttention.apply(vis, ir, 4, *ws, *bs)
    want = cross_attention.dual_cross_attention_reference(vis, ir, ws, bs, 4)
    gv, gi = torch.randn(2, 7, 32), torch.randn(2, 7, 32)
    inputs = [vis, ir, *ws, *bs]
    got = torch.autograd.grad(out, inputs, (gv, gi))
    ref = torch.autograd.grad(want, inputs, (gv, gi))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 64, 9, 7, generator=g).requires_grad_()
    w = (torch.randn(64, 64, 3, 3, generator=g) * 0.05).requires_grad_()
    sc = torch.rand(64, generator=g).requires_grad_()
    bi = torch.randn(64, generator=g).requires_grad_()
    gy = torch.randn(2, 64, 9, 7, generator=g)
    got = torch.autograd.grad(packed_conv.Conv3x3BnSilu.apply(x, w, sc, bi),
                              (x, w, sc, bi), gy)
    ref = torch.autograd.grad(packed_conv.conv3x3_bn_silu_reference(
        x, w, sc, bi), (x, w, sc, bi), gy)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    x_only = torch.autograd.grad(packed_conv.Conv3x3BnSilu.apply(
        x, w.detach(), sc.detach(), bi.detach()), x, gy)[0]
    torch.testing.assert_close(x_only, ref[0], rtol=1e-5, atol=1e-5)
    assert len(calls) == 3


def test_int8_conv_and_nms_refuse_gradients():
    """The non-differentiable kernels raise under grad when an input
    requires it, on the CPU as on the card; under no_grad, or with no
    input requiring grad, they run."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 8, 6, 6, generator=g)
    w8 = torch.randint(-127, 128, (4, 3, 3, 8), generator=g,
                       dtype=torch.int8)
    s_in, s_w = torch.full((8,), 0.02), torch.full((4,), 0.01)
    bn = tuple(torch.ones(4) for _ in range(4)) + (1e-3,)
    leaf = x.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="conv_int8_bn_act"):
        conv_int8_bn_act(leaf, w8, s_in, s_w, bn, 1, 1)
    gamma = torch.nn.Parameter(torch.ones(4))
    with pytest.raises(RuntimeError, match="conv_int8_bn_act"):
        conv_int8_bn_act(x, w8, s_in, s_w, (gamma,) + bn[1:], 1, 1)
    with torch.no_grad():
        conv_int8_bn_act(leaf, w8, s_in, s_w, (gamma,) + bn[1:], 1, 1)
    conv_int8_bn_act(x, w8, s_in, s_w, bn, 1, 1)
    boxes = torch.rand(1, 5, 4, generator=g) * 10
    boxes[..., 2:] += boxes[..., :2]
    scores = torch.linspace(0.9, 0.1, 5)[None]
    with pytest.raises(RuntimeError, match="greedy_nms"):
        nms.greedy_nms(boxes.requires_grad_(), scores, 0.45, 3)
    with torch.inference_mode():
        keep, ok = nms.greedy_nms(boxes, scores, 0.45, 3)
    assert keep.shape == ok.shape == (1, 3)


def test_load_ensemble_matches_jax(tiny, tmp_path):
    """load_ensemble reads each (config, checkpoint) pair as the JAX
    package's does: two checkpoints of the fixture's weights and another
    draw, the ensemble's predictions against the JAX ensemble's."""
    from icafusion_tpu.models.ensemble import load_ensemble as jax_load
    from icafusion_tpu_torch.models.ensemble import load_ensemble
    from icafusion_tpu_torch.utils.checkpoint import msgpack_serialize
    jm, v, _, rgb, ir = tiny
    v2 = random_variables(jm, jnp.asarray(rgb), jnp.asarray(ir), seed=7,
                          train=False)
    paths = []
    for i, vv in enumerate((v, v2)):
        paths.append(str(tmp_path / f"m{i}.ckpt"))
        (tmp_path / f"m{i}.ckpt").write_bytes(msgpack_serialize(
            {**vv, "meta": {"epoch": 0}}))
    members = load_ensemble(["zoo:tiny"] * 2, paths, device="cpu")
    assert all(not m.training for m in members)
    pred, logits = jax_ensemble(jax_load(["zoo:tiny"] * 2, paths),
                                jnp.asarray(rgb), jnp.asarray(ir))
    with torch.no_grad():
        got_pred, got_logits = ensemble_predict(members, nchw(rgb), nchw(ir))
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(pred),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits),
                               rtol=1e-4, atol=1e-4)
