"""icafusion_tpu_torch's CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs a CUDA device and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from icafusion_tpu_torch.kernels.cross_attention import (
    dual_cross_attention, dual_cross_attention_reference)
from icafusion_tpu_torch.kernels.nms import greedy_nms, greedy_nms_reference
from icafusion_tpu_torch.kernels.packed_conv import (conv3x3_bn_silu,
                                                     conv3x3_bn_silu_reference)
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.nn.layers import Conv
from icafusion_tpu_torch.models.zoo import tiny_icafusion_config
from icafusion_tpu_torch.serve.engine import ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _attention_args(B, N, D, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *s, std=1.0: torch.from_numpy(
        rng.normal(0, std, s).astype(np.float32))
    return (t(B, N, D).to(dev, dtype), t(B, N, D).to(dev, dtype),
            [t(D, D, std=D ** -0.5).to(dev, dtype) for _ in range(6)],
            [t(D, std=0.1).to(dev) for _ in range(6)])


ATTENTION_TOL = {torch.float32: (2e-4, 2e-5), torch.bfloat16: (3e-2, 3e-2)}


@pytest.mark.parametrize("N,D", [(400, 256), (256, 512), (100, 1024), (7, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_reference(dev, N, D, dtype):
    """The serving path's three shapes and a ragged one (dk = 6). fp32: the
    JAX Pallas test's tolerance. bf16: the kernel rounds q/k/v and the
    probabilities to bf16 before their products, as the plain version (the
    JAX einsum path) does, but sums in another order and rounds the
    probabilities before their normalisation: a few bf16 ulps."""
    args = _attention_args(2, N, D, dtype, dev)
    before = dual_cross_attention.launches
    got = dual_cross_attention(*args)
    assert dual_cross_attention.launches == before + 1
    want = dual_cross_attention_reference(*args)
    rtol, atol = ATTENTION_TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("N", [1, 63, 65])
@pytest.mark.parametrize("D", [48, 256, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_at_ragged_lengths(dev, N, D, dtype):
    """One key, and one short of and one past a 64-token tile (the query and
    key tiles of both designs), at dk = 6, 32, 64 and 128; the tolerances of
    the test above."""
    args = _attention_args(3, N, D, dtype, dev, seed=N + D)
    got = dual_cross_attention(*args)
    want = dual_cross_attention_reference(*args)
    rtol, atol = ATTENTION_TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (3, N, D)
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol)


def test_attention_wrapper_rejects_what_the_kernel_does_not_take(dev):
    vis, ir, ws, bs = _attention_args(1, 16, 64, torch.float32, dev)
    with pytest.raises(TypeError):
        dual_cross_attention(vis.half(), ir.half(), [w.half() for w in ws], bs)
    with pytest.raises(ValueError):
        dual_cross_attention(vis, ir, [w.t() for w in ws], bs)
    with pytest.raises(ValueError):
        dual_cross_attention(vis, ir, ws, [b.bfloat16() for b in bs])


def _nms_inputs(B, K, dev, seed=0, pad=-1.0, degenerate=False):
    """Clustered class-offset boxes, descending scores with exact ties,
    `pad` after 80 % and in the whole last image; degenerate adds zero-area
    boxes and boxes with x2 < x1."""
    rng = np.random.default_rng(seed)
    ctr = np.repeat(rng.uniform(0, 600, (B, (K + 7) // 8, 2)), 8, axis=1)
    xy = ctr[:, :K] + rng.normal(0, 6, (B, K, 2))
    wh = rng.uniform(20, 80, (B, K, 2))
    if degenerate:
        wh[:, ::5] = 0.0
        wh[:, 1::7, 0] *= -1.0
    boxes = np.concatenate([xy, xy + wh], -1)
    boxes += 4096.0 * rng.integers(0, 3, (B, K, 1))
    scores = -np.sort(-np.round(rng.uniform(0, 1, (B, K)) * 64) / 64, axis=1)
    scores[:, int(0.8 * K):] = pad
    scores[-1] = pad
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    return f(boxes), f(scores)


def _nms_equal(boxes, scores, iou_thres, max_det):
    before = greedy_nms.launches
    keep, ok = greedy_nms(boxes, scores, iou_thres, max_det)
    assert greedy_nms.launches == before + 1
    rkeep, rok = greedy_nms_reference(boxes, scores, iou_thres, max_det)
    assert torch.equal(ok, rok)
    assert torch.equal(keep, rkeep)
    return keep, ok


@pytest.mark.parametrize("K", [1, 63, 65, 300, 1023, 1024, 4096, 8192, 8193,
                               20000])
def test_nms_kernel_equals_reference(dev, K):
    """keep and ok in every slot: K not a multiple of 32 or 64, the serving
    pool (1024), the Evaluator's (8192), and pools whose walk moves its
    register window (past 2048 candidates) and streams the mask through the
    ring (8193, 20000); with K = 1 every image is padding."""
    _nms_equal(*_nms_inputs(3, K, dev), 0.45, 300)


@pytest.mark.parametrize("pad", [0.0, -0.5, -2.0])
@pytest.mark.parametrize("K", [65, 1024, 8193])
def test_nms_kernel_padding_variants(dev, K, pad):
    """Padding above the removed value -1 is picked (ok False) and
    suppresses; padding below it is never picked."""
    _nms_equal(*_nms_inputs(3, K, dev, seed=K, pad=pad), 0.45, 300)


def test_nms_kernel_when_everything_is_removed(dev):
    """Identical boxes: the first pick removes all the others, live padding
    included, long before max_det; and an image whose positives are all
    removed while spread-out live padding (0.0) is left to pick."""
    K = 96
    boxes = torch.tensor([10.0, 10, 50, 50]).repeat(2, K, 1)
    far = torch.arange(40, K, dtype=torch.float32) * 100
    boxes[1, 40:, 0] = boxes[1, 40:, 2] = far
    boxes[1, 40:, 2] += 30
    scores = torch.zeros(2, K)
    scores[0, :50], scores[0, 50:] = 0.9, -0.5
    scores[1, :40], scores[1, 40:] = 0.8, 0.0
    keep, ok = _nms_equal(boxes.to(dev), scores.to(dev), 0.45, 80)
    assert ok[0].tolist() == [True] + [False] * 79
    assert keep[1, :57].tolist() == [0] + list(range(40, K))


@pytest.mark.parametrize("K,max_det", [(65, 300), (1024, 2000), (5, 1)])
def test_nms_kernel_max_det_past_k(dev, K, max_det):
    """max_det above K (the slots past the walk are (0, False)), and one
    step only."""
    _nms_equal(*_nms_inputs(2, K, dev, seed=K), 0.45, max_det)


@pytest.mark.parametrize("K", [64, 1023])
def test_nms_kernel_degenerate_boxes(dev, K):
    """Zero-area boxes and boxes with x2 < x1, whose IoU denominators are
    zero or negative."""
    _nms_equal(*_nms_inputs(3, K, dev, seed=K, degenerate=True), 0.45, 300)


def test_nms_kernel_at_the_evaluator_shape(dev):
    """B = 8, K = 8192: the Evaluator's batch and top_k."""
    _nms_equal(*_nms_inputs(8, 8192, dev, seed=8), 0.45, 300)


def test_nms_at_the_threshold(dev):
    """An IoU exactly at the threshold (1/3) is kept and one above it (0.6)
    suppressed, in the kernel as in the plain version."""
    boxes = torch.tensor([[[0.0, 0, 2, 1], [1, 0, 3, 1], [0.5, 0, 2.5, 1]]],
                         device=dev)
    scores = torch.tensor([[0.9, 0.8, 0.7]], device=dev)
    keep, ok = greedy_nms(boxes, scores, 1 / 3, 3)
    rkeep, rok = greedy_nms_reference(boxes, scores, 1 / 3, 3)
    assert torch.equal(ok, rok) and torch.equal(keep, rkeep)
    assert ok.tolist() == [[True, True, False]]
    assert keep[0, :2].tolist() == [0, 1]


def test_engine_on_the_card_matches_the_cpu(dev):
    """The tiny model served in fp32 on the card (kernels) and on the CPU
    (plain versions): decoded predictions close, one launch of each kernel
    path per request (three fusion blocks, one NMS)."""
    model = build_model(tiny_icafusion_config(),
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (3, 64, 96, 3), np.uint8)
    ir = rng.integers(0, 256, (3, 64, 96, 3), np.uint8)
    engines = {d: ServingEngine(model, (64, 96), 4, dtype="float32", device=d)
               for d in (dev, "cpu")}
    preds = []
    for d, eng in engines.items():
        x, y = (torch.from_numpy(a).to(d).permute(0, 3, 1, 2).float() / 255
                for a in (rgb, ir))
        with torch.inference_mode():
            preds.append(eng.model(x, y).cpu())
    torch.testing.assert_close(preds[0], preds[1], rtol=1e-3, atol=1e-3)
    a0, n0 = dual_cross_attention.launches, greedy_nms.launches
    out = engines[dev].predict_arrays(rgb, ir)
    assert (dual_cross_attention.launches - a0, greedy_nms.launches - n0) == (3, 1)
    assert len(out) == 3 and all(o.shape[1] == 6 for o in out)


def _conv_args(shape, dtype, layout, dev, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *s, std=1.0: torch.from_numpy(
        rng.normal(0, std, s).astype(np.float32))
    x = t(*shape).to(dev, dtype).contiguous(memory_format=layout)
    return (x, t(64, 64, 3, 3, std=1 / 24).to(dev, dtype),
            (1 + 0.3 * t(64)).to(dev), t(64, std=0.1).to(dev))


@pytest.mark.parametrize("shape", [
    (1, 64, 20, 20), (2, 64, 10, 13), (1, 64, 7, 5), (1, 64, 33, 17),
    (1, 64, 1, 1),        # the halo is all padding
    (3, 64, 161, 33),     # ragged tiles in both directions
    (1, 64, 8, 16),       # one tile, fewer tiles than SMs
    (4, 64, 160, 160)])   # the serving shape: several tiles per SM
@pytest.mark.parametrize("layout", [torch.channels_last,
                                    torch.contiguous_format])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernel_matches_reference(dev, shape, layout, dtype):
    """Ragged tiles in both layouts (4 x 16-pixel tiles in bf16
    channels_last, 16 x 16 otherwise). fp32: the JAX Pallas test's 1e-4;
    bf16: both sum exact products in fp32 and round once, so they differ by
    about one bf16 ulp."""
    args = _conv_args(shape, dtype, layout, dev)
    before = conv3x3_bn_silu.launches
    got = conv3x3_bn_silu(*args)
    assert conv3x3_bn_silu.launches == before + 1
    want = conv3x3_bn_silu_reference(*args)
    assert got.dtype == dtype and got.stride() == args[0].stride()
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_conv_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x, w, s, b = _conv_args((1, 64, 8, 8), torch.float32,
                            torch.contiguous_format, dev)
    with pytest.raises(TypeError):
        conv3x3_bn_silu(x.half(), w.half(), s, b)
    with pytest.raises(ValueError):
        conv3x3_bn_silu(x, w.bfloat16(), s, b)
    with pytest.raises(ValueError):
        conv3x3_bn_silu(x[:, :, :, :7], w, s, b)        # not dense
    with pytest.raises(ValueError):
        conv3x3_bn_silu(x[:, :32], w[:32, :32], s, b)
    with pytest.raises(ValueError):
        conv3x3_bn_silu(x, w, s.double(), b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_module_launches_the_kernel(dev, dtype):
    """An eval-mode Conv(64, 64, 3, 1) launches the kernel once a forward
    and gives conv -> BatchNorm -> SiLU; Conv(64, 64, 3, 2) does not."""
    gen = torch.Generator().manual_seed(0)
    mod = Conv(64, 64, 3, 1)
    with torch.no_grad():
        mod.bn.running_mean.normal_(0, 0.1, generator=gen)
        mod.bn.running_var.uniform_(0.5, 1.5, generator=gen)
        mod.bn.weight.normal_(1, 0.1, generator=gen)
    mod = mod.eval().to(dev)
    mod.conv.weight.data = mod.conv.weight.data.to(dtype)
    x = torch.randn(2, 64, 24, 40, generator=gen).to(dev, dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    before = conv3x3_bn_silu.launches
    with torch.no_grad():
        got = mod(x)
        want = mod.act(mod.bn(mod.conv(x)))
    assert conv3x3_bn_silu.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    strided = Conv(64, 64, 3, 2).eval().to(dev)
    with torch.no_grad():
        strided(x.float())
    assert conv3x3_bn_silu.launches == before + 1
