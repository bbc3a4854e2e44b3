"""icafusion_tpu_torch's CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs a CUDA device and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from icafusion_tpu_torch.kernels.conv_int8 import conv_int8_bn_act
from icafusion_tpu_torch.kernels.cross_attention import (
    dual_cross_attention, dual_cross_attention_reference)
from icafusion_tpu_torch.kernels.nms import greedy_nms, greedy_nms_reference
from icafusion_tpu_torch.kernels import _build, packed_conv
from icafusion_tpu_torch.kernels.packed_conv import (conv3x3_bn_silu,
                                                     conv3x3_bn_silu_reference)
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.nn.layers import Conv
from icafusion_tpu_torch.models.zoo import tiny_icafusion_config
from icafusion_tpu_torch.serve.engine import ServingEngine
from icafusion_tpu_torch.smoke import common as smoke_common
from icafusion_tpu_torch.smoke import int8 as smoke_int8
from icafusion_tpu_torch.smoke import parallel as smoke_parallel
from icafusion_tpu_torch.smoke import train as smoke_train

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


# (N, D) of the fusion levels of every shipped config not held above:
# n, s, m, x scales, VGG16 and ResNet50 at 640 (dk 8 to 256)
SHIPPED_ATTENTION = [(400, 64), (256, 128), (100, 256), (400, 128),
                     (256, 256), (100, 512), (400, 192), (256, 384),
                     (100, 768), (400, 320), (256, 640), (100, 1280),
                     (400, 512), (256, 1024), (100, 2048)]


@pytest.mark.parametrize("N,D", SHIPPED_ATTENTION)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_at_every_shipped_width(dev, N, D, dtype):
    """Heads of 8 to 256 values: above 128 (the x-scale P5 block, dk 160,
    and ResNet50's P4 and P5, dk 128 and 256) the kernel splits the value
    columns across blocks. The tolerances of the test above."""
    args = _attention_args(2, N, D, dtype, dev, seed=D)
    before = dual_cross_attention.launches
    got = dual_cross_attention(*args)
    assert dual_cross_attention.launches == before + 1
    want = dual_cross_attention_reference(*args)
    rtol, atol = ATTENTION_TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (2, N, D)
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol)


def test_resnet50_transfusion_serves_at_full_width(dev):
    """yolov5_ResNet50_Transfusion.yaml at 640, bf16, batch 1, seeded
    weights: three attention launches (the P5 block's dk is 256), one NMS
    and no fused conv (the towers' convs end in ReLU), finite detections."""
    from icafusion_tpu_torch.config import load_model_config
    model = build_model(load_model_config("yolov5_ResNet50_Transfusion.yaml"),
                        generator=torch.Generator().manual_seed(0))
    engine = ServingEngine(model, 640, 1, conf_thres=0.001, dtype="bfloat16",
                           device=dev)
    rng = np.random.default_rng(0)
    rgb, ir = (rng.integers(0, 256, (1, 640, 640, 3), np.uint8)
               for _ in range(2))
    counts = (dual_cross_attention.launches, greedy_nms.launches,
              conv3x3_bn_silu.launches)
    out = engine.predict_arrays(rgb, ir)
    assert (dual_cross_attention.launches - counts[0],
            greedy_nms.launches - counts[1],
            conv3x3_bn_silu.launches - counts[2]) == (3, 1, 0)
    assert len(out) == 1 and out[0].shape[1] == 6
    assert np.isfinite(out[0]).all()


def test_attention_wrapper_rejects_what_the_kernel_does_not_take(dev):
    vis, ir, ws, bs = _attention_args(1, 16, 64, torch.float32, dev)
    with pytest.raises(TypeError):
        dual_cross_attention(vis.half(), ir.half(), [w.half() for w in ws], bs)
    with pytest.raises(ValueError):
        dual_cross_attention(vis, ir, [w.t() for w in ws], bs)
    with pytest.raises(ValueError):
        dual_cross_attention(vis, ir, ws, [b.bfloat16() for b in bs])
    vis, ir, ws, bs = _attention_args(1, 16, 2112, torch.float32, dev)
    with pytest.raises(ValueError, match="D / h <= 256"):       # dk 264
        dual_cross_attention(vis, ir, ws, bs)


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
    (2, 64, 68, 84),      # rect val at 640 (544 x 672): 84 = 5 tiles + 4
    (2, 64, 56, 56),      # the third TTA pass at 640 (448 x 448)
    (4, 64, 160, 160)])   # the serving shape: several tiles per SM
@pytest.mark.parametrize("layout", [torch.channels_last,
                                    torch.contiguous_format])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernel_matches_reference(dev, shape, layout, dtype):
    """Ragged tiles in both layouts (4 x 16-pixel tiles in bf16, 8 x 16 in
    fp32; NCHW on both of its routes). fp32: the JAX Pallas test's 1e-4;
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


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "grad"])
@pytest.mark.parametrize("shape", smoke_common.CONV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_nchw_routes_match_reference(dev, shape, dtype, grad):
    """NCHW maps at every shape of chip_smoke.py's phase 3b, on their route
    (packed_conv.route: nchw_tma where a row is a multiple of 16 bytes,
    else nchw_ld; (1, 64, 1, 1) is dense in both layouts and takes nhwc):
    one launch, counted as NCHW, an NCHW output within phase 3b's gates of
    the plain version; under grad through Conv3x3BnSilu, x's gradient
    against autograd through the plain version (GRAD_TOL)."""
    args = _conv_args(shape, dtype, torch.contiguous_format, dev)
    if grad:
        args = [t.requires_grad_() for t in args]
    nchw = packed_conv.route(args[0]) != "nhwc"
    assert nchw == (shape[2:] != (1, 1))
    before = conv3x3_bn_silu.launches, conv3x3_bn_silu.nchw_launches
    got = conv3x3_bn_silu(*args)
    assert (conv3x3_bn_silu.launches, conv3x3_bn_silu.nchw_launches) == (
        before[0] + 1, before[1] + nchw)
    assert got.stride() == args[0].stride() and (got.grad_fn is not None) \
        == grad
    want = conv3x3_bn_silu_reference(*args)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if grad:
        g = torch.randn_like(got)
        a, = torch.autograd.grad(got, args[0], g)
        b, = torch.autograd.grad(want, args[0], g)
        tol = GRAD_TOL[dtype]
        torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                   atol=tol * float(b.float().abs().max()))


@pytest.mark.parametrize("W,route", [(40, "nchw_tma"), (42, "nchw_ld")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_nchw_aligned_and_unaligned_rows(dev, dtype, W, route):
    """Two NCHW maps a column apart in width: rows of 80 or 160 bytes (W =
    40) load by TMA, rows of 84 or 168 (W = 42) by the threads' own loads;
    both within the gate, ragged in both directions (H = 19)."""
    args = _conv_args((3, 64, 19, W), dtype, torch.contiguous_format, dev,
                      seed=W)
    assert packed_conv.route(args[0]) == route
    before = conv3x3_bn_silu.nchw_launches
    got = conv3x3_bn_silu(*args)
    assert conv3x3_bn_silu.nchw_launches == before + 1
    assert got.is_contiguous()
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(),
                               conv3x3_bn_silu_reference(*args).float(),
                               rtol=tol, atol=tol)


def test_conv_c_entry_refuses_another_route(dev):
    """icaf_conv3x3_bn_silu checks the route the wrapper passes against its
    own route_of and launches nothing where they differ."""
    x, w, s, b = _conv_args((1, 64, 8, 40), torch.bfloat16,
                            torch.contiguous_format, dev)
    out = torch.zeros_like(x)
    lib = _build.library()
    call = lambda nhwc, route: lib.icaf_conv3x3_bn_silu(
        x.data_ptr(), w.data_ptr(), s.data_ptr(), b.data_ptr(),
        out.data_ptr(), 1, 8, 40, 1, nhwc, route,
        _build.stream_handle(x.device))
    for nhwc, route in ((0, 0), (0, 2), (1, 1)):
        assert call(nhwc, route) != 0
    assert not out.any()
    assert call(0, packed_conv.ROUTES.index("nchw_tma")) == 0
    torch.testing.assert_close(out.float(),
                               conv3x3_bn_silu_reference(x, w, s, b).float(),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("N", [1, 63, 65])
@pytest.mark.parametrize("D", [48, 64, 2048])
def test_attention_tf32_kernel_at_its_edges(dev, N, D):
    """The fp32 kernel's 3xTF32 design at its edges: dk 6 (padded to 8)
    and dk 8, one k8 step each; dk 256, value columns split across two
    blocks and 32-key tiles; one key, and one short of and one past a
    64-query tile (and the 32-key tiles). One launch a call; the fp32
    gate."""
    args = _attention_args(2, N, D, torch.float32, dev, seed=7 * N + D)
    before = (dual_cross_attention.launches,
              dual_cross_attention.tf32_launches)
    got = dual_cross_attention(*args)
    assert (dual_cross_attention.launches,
            dual_cross_attention.tf32_launches) == tuple(
                n + 1 for n in before)
    want = dual_cross_attention_reference(*args)
    for g, w in zip(got, want):
        assert g.shape == (2, N, D)
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 64, 3, 5),     # under one 8 x 16 tile
                                   (1, 64, 8, 1),
                                   (2, 64, 17, 33),   # ragged both ways
                                   (3, 64, 9, 47)])
def test_conv_tf32_kernel_at_its_edges(dev, shape):
    """The fp32 channels_last kernel's 3xTF32 design: maps smaller than
    one 8 x 16-pixel tile and maps whose tiles are ragged in both
    directions; both 32-channel blocks of a tile. One launch a call, on the
    3xTF32 kernel; the fp32 gate."""
    args = _conv_args(shape, torch.float32, torch.channels_last, dev,
                      seed=shape[3])
    before = conv3x3_bn_silu.launches, conv3x3_bn_silu.tf32_launches
    got = conv3x3_bn_silu(*args)
    assert (conv3x3_bn_silu.launches,
            conv3x3_bn_silu.tf32_launches) == tuple(n + 1 for n in before)
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, conv3x3_bn_silu_reference(*args),
                               rtol=1e-4, atol=1e-4)


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


INT8_CARD_SHAPES = [
    (3, 16, 6, 2, 64, 80),        # the stem: K = 108, byte loads of w8
    (32, 48, 1, 1, 20, 13),       # 1x1, ragged M
    (64, 64, 3, 1, 17, 9),        # 3x3 s1
    (48, 200, 3, 2, 21, 30),      # 3x3 s2, Cout past one 128 tile
    (2560, 136, 1, 1, 5, 7)]      # Cin of yolov5x's SPPF: K of 40 steps


@pytest.mark.parametrize("shape", INT8_CARD_SHAPES)
@pytest.mark.parametrize("layout", [torch.channels_last,
                                    torch.contiguous_format])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_conv_kernel_matches_reference(dev, shape, layout, dtype):
    """The int32 accumulators equal the plain version's and the outputs lie
    within smoke_int8.INT8_TOL of the largest, with SiLU and identity."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = smoke_int8.int8_case(2, shape, dtype, gen, layout)
    before = conv_int8_bn_act.launches
    smoke_int8.int8_check(args)
    smoke_int8.int8_check(args, act=False)
    assert conv_int8_bn_act.launches == before + 4


# The tma path (kernels/conv_int8.py: plan): (B, (Cin, Cout, k, s, H, W))
INT8_TMA_CASES = [
    # every P5 class of yolov5l at B = 1 and 4 (split-K), yolov5x's SPPF
    *[(B, shape) for B in (1, 4) for shape in (
        (1024, 512, 1, 1, 20, 20), (512, 512, 1, 1, 20, 20),
        (512, 512, 3, 1, 20, 20), (2048, 1024, 1, 1, 20, 20),
        (1024, 1024, 1, 1, 20, 20), (512, 1024, 3, 2, 40, 40),
        (512, 512, 3, 2, 40, 40))],
    (1, (2560, 1280, 1, 1, 20, 20)), (4, (2560, 1280, 1, 1, 20, 20)),
    # ragged tiles against the map: 20 x 20 and 64 x 80
    (2, (128, 128, 3, 1, 20, 20)), (2, (128, 128, 3, 1, 64, 80)),
    (2, (256, 128, 1, 1, 64, 80)),
    # stride 2
    (2, (64, 128, 3, 2, 64, 80)), (1, (256, 512, 3, 2, 80, 80)),
    # the n, s, m and x widths: Cin 16, 32, 48, 80 (ragged channel chunks)
    (2, (16, 32, 3, 1, 40, 40)), (2, (32, 64, 3, 2, 80, 80)),
    (2, (48, 48, 1, 1, 40, 40)), (2, (80, 80, 3, 1, 40, 40)),
    (2, (48, 96, 3, 2, 40, 40)), (2, (80, 160, 1, 1, 20, 20))]


@pytest.mark.parametrize("case", INT8_TMA_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_tma_path_matches_reference(dev, case, dtype):
    """The tma path at split-K, ragged, stride-2 and narrow shapes: int32
    accumulators equal to the plain version's, outputs within
    smoke_int8.INT8_TOL, with SiLU and identity."""
    from icafusion_tpu_torch.kernels.conv_int8 import plan_for
    B, shape = case
    gen = torch.Generator(device="cuda").manual_seed(sum(shape) + B)
    args = smoke_int8.int8_case(B, shape, dtype, gen)
    assert plan_for(args[0], args[1], args[5], args[6]).path == "tma"
    smoke_int8.int8_check(args)
    smoke_int8.int8_check(args, act=False)


def test_int8_stem_and_nchw_take_the_direct_path(dev):
    """The stem (Cin 3) takes the "stem" path; NCHW maps of Cin 64 the
    direct one (the first design); both equal the plain version."""
    from icafusion_tpu_torch.kernels.conv_int8 import plan_for
    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape, layout, path in (
            ((3, 32, 6, 2, 64, 80), torch.channels_last, "stem"),
            ((64, 64, 3, 1, 20, 20), torch.contiguous_format, "direct"),
            ((64, 128, 1, 1, 20, 20), torch.contiguous_format, "direct")):
        for dtype in (torch.float32, torch.bfloat16):
            args = smoke_int8.int8_case(2, shape, dtype, gen, layout)
            assert plan_for(args[0], args[1], args[5],
                            args[6]).path == path
            smoke_int8.int8_check(args)


# The stem path: (B, (Cin, Cout, k, s, H, W)): the stems of n and x, the
# merged stem (Cin 6, K = 216), Focus's Cin 12 3x3, a 1x1 and a 7x7, odd
# maps (ragged tiles), Cin 40 (channels_last only) and Cout 136 (a second
# 64-channel pass)
INT8_STEM_CASES = [(2, (3, 16, 6, 2, 64, 80)), (1, (3, 80, 6, 2, 96, 64)),
                   (2, (6, 128, 6, 2, 64, 64)), (2, (12, 32, 3, 1, 33, 29)),
                   (3, (3, 24, 1, 1, 17, 23)), (2, (5, 40, 7, 2, 45, 51)),
                   (2, (3, 136, 3, 2, 37, 41)), (2, (40, 64, 3, 1, 19, 21))]


# both layouts where Cin < 16; NCHW with Cin 40 takes the direct path
@pytest.mark.parametrize("case,layout", [
    (case, layout) for case in INT8_STEM_CASES
    for layout in (torch.channels_last, torch.contiguous_format)
    if case[1][0] < 16 or layout == torch.channels_last])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_stem_path_matches_reference(dev, case, layout, dtype):
    """The stem path's int32 accumulators equal the plain version's and
    its outputs lie within smoke_int8.INT8_TOL, with SiLU and identity;
    one launch counted on the stem path a call."""
    from icafusion_tpu_torch.kernels.conv_int8 import plan_for
    B, shape = case
    gen = torch.Generator(device="cuda").manual_seed(sum(shape) + B)
    args = smoke_int8.int8_case(B, shape, dtype, gen, layout)
    assert plan_for(args[0], args[1], args[5], args[6]).path == "stem"
    before = conv_int8_bn_act.stem_launches
    smoke_int8.int8_check(args)
    smoke_int8.int8_check(args, act=False)
    assert conv_int8_bn_act.stem_launches == before + 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_stem_takes_the_engines_uint8_view(dev, dtype):
    """The engine's stem input: a permuted uint8 NHWC batch / 255, cast
    (pixels 3 elements apart, 6 or 12 bytes), at 64 x 96."""
    from icafusion_tpu_torch.kernels.conv_int8 import plan_for
    gen = torch.Generator(device="cuda").manual_seed(7)
    u8 = torch.randint(0, 256, (3, 64, 96, 3), device="cuda", generator=gen,
                       dtype=torch.uint8)
    x = (u8.permute(0, 3, 1, 2).float() / 255.0).to(dtype)
    assert x.stride() == (64 * 96 * 3, 1, 96 * 3, 3)
    args = list(smoke_int8.int8_case(3, (3, 32, 6, 2, 64, 96), dtype, gen))
    args[0] = x
    args[2] = (x.float().abs().amax(dim=(0, 2, 3)) / 127).clamp_min(1e-8)
    assert plan_for(x, args[1], args[5], args[6]).path == "stem"
    smoke_int8.int8_check(tuple(args))


@pytest.mark.parametrize("offset", [16, 24])
def test_int8_channels_last_view_with_a_channel_offset(dev, offset):
    """x = a channel slice of a wider channels_last map: the tma path reads
    it in place when the offset is 16-byte aligned (bf16 offset 16), the
    direct path otherwise (offset 24 = 48 bytes is aligned too; offset 4
    = 8 bytes is not)."""
    from icafusion_tpu_torch.kernels.conv_int8 import plan_for
    gen = torch.Generator(device="cuda").manual_seed(offset)
    args = list(smoke_int8.int8_case(2, (64, 96, 3, 1, 20, 24),
                                     torch.bfloat16, gen))
    full = torch.randn(2, 160, 20, 24, device="cuda", generator=gen).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    for off, path in ((offset, "tma"), (4, "direct")):
        x = full[:, off:off + 64]
        args[0] = x
        args[2] = (x.float().abs().amax(dim=(0, 2, 3)) / 127).clamp_min(1e-8)
        assert plan_for(x, args[1], args[5], args[6]).path == path
        smoke_int8.int8_check(tuple(args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_tma_path_takes_an_s_in_off_16_bytes(dev, dtype):
    """s_in a contiguous slice of a larger buffer, 4 bytes past a 16-byte
    boundary: the tma kernel reads the scales with scalar loads, so it
    stays on the tma path and gives the plain version's accumulators."""
    from icafusion_tpu_torch.kernels.conv_int8 import plan_for
    gen = torch.Generator(device="cuda").manual_seed(5)
    args = list(smoke_int8.int8_case(2, (64, 96, 3, 1, 20, 24), dtype, gen))
    buf = torch.zeros(65, device="cuda")
    buf[1:] = args[2]
    args[2] = buf[1:]
    assert args[2].is_contiguous() and args[2].data_ptr() % 16 == 4
    assert plan_for(args[0], args[1], args[5], args[6]).path == "tma"
    smoke_int8.int8_check(tuple(args))
    smoke_int8.int8_check(tuple(args), act=False)


def test_int8_split_k_counters_reset_between_calls(dev):
    """Back-to-back split-K calls on one stream (the tile counters reset
    themselves) give identical int32 sums, equal to the plain version's."""
    from icafusion_tpu_torch.kernels.conv_int8 import (
        conv_int8_bn_act, conv_int8_bn_act_reference, plan_for)
    gen = torch.Generator(device="cuda").manual_seed(3)
    args = smoke_int8.int8_case(1, (1024, 512, 1, 1, 20, 20),
                                torch.bfloat16, gen)
    assert plan_for(args[0], args[1], args[5], args[6]).splits > 1
    outs = [conv_int8_bn_act(*args, epilogue=False) for _ in range(3)]
    ref = conv_int8_bn_act_reference(*args, epilogue=False)
    torch.cuda.synchronize()
    for o in outs:
        assert torch.equal(o, ref)


def test_int8_wrapper_rejects_what_the_kernel_does_not_take(dev):
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, w8, s_in, s_w, bn, s, p = smoke_int8.int8_case(
        1, (16, 32, 3, 1, 8, 8), torch.float32, gen)
    with pytest.raises(TypeError):
        conv_int8_bn_act(x.half(), w8, s_in, s_w, bn, s, p)
    with pytest.raises(ValueError):
        conv_int8_bn_act(x, w8.float(), s_in, s_w, bn, s, p)
    with pytest.raises(ValueError):          # grouped: w8 has Cin / 2
        conv_int8_bn_act(x, w8[..., :8].contiguous(), s_in, s_w, bn, s, p)
    with pytest.raises(ValueError):
        conv_int8_bn_act(x, w8, s_in.double(), s_w, bn, s, p)
    with pytest.raises(ValueError):
        conv_int8_bn_act(x, w8, s_in, s_w, None, s, p)
    with pytest.raises(ValueError):
        conv_int8_bn_act(x, w8.cpu(), s_in, s_w, bn, s, p)


def test_int8_model_launches_the_kernel_per_quantized_conv(dev):
    """The tiny model quantized on the CPU with the Detect-feeder skip and
    moved to the card: one launch per int8 Conv a forward (84), none of
    the fused conv, finite decoded predictions."""
    from icafusion_tpu_torch.utils.quantize import (calibrate,
                                                    detect_feeder_skip,
                                                    quantize_model)
    model = build_model(tiny_icafusion_config(),
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    pair = [rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
            for _ in range(2)]
    quantize_model(model, calibrate(model, [pair]),
                   skip=detect_feeder_skip(model.cfg))
    model = model.to(dev)
    before = conv_int8_bn_act.launches
    with torch.inference_mode():
        x, y = (torch.from_numpy(a).to(dev).permute(0, 3, 1, 2)
                for a in pair)
        pred = model(x, y)
    assert conv_int8_bn_act.launches == before + 84
    assert torch.isfinite(pred).all()


@pytest.mark.parametrize("fmt", [torch.contiguous_format,
                                 torch.channels_last])
def test_pool_gradients_on_ties_are_first_winner(dev, fmt):
    """SPPF's 5x5/s1 pool and the fusion block's floor-mode pool (10x10/s2)
    on integer data: the card's autograd sends each window's gradient where
    the JAX package's VJP does (smoke_common.first_winner_pool_grad)."""
    F = torch.nn.functional
    gen = torch.Generator().manual_seed(0)
    for shape, k, s, p in (((2, 8, 20, 20), 5, 1, 2),
                           ((2, 8, 40, 40), 10, 2, 0)):
        x = torch.randint(0, 4, shape, generator=gen).float()
        xc = x.to(dev).contiguous(memory_format=fmt).requires_grad_()
        y = F.max_pool2d(xc, k, s, p)
        g = torch.randint(-3, 4, y.shape, generator=gen).float()
        (y * g.to(dev)).sum().backward()
        assert torch.equal(xc.grad.double().cpu(),
                           smoke_common.first_winner_pool_grad(x, g, k, s, p))


def test_train_steps_on_the_card_match_the_cpu(dev):
    """Three Trainer steps of the tiny model (64 px, batch 2, fp32, dropout
    off) on the card and on the CPU: chip_smoke.py's phase 6a, whose
    docstring and constants give the tolerances and why."""
    smoke_train.train_card_vs_cpu()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_batch_one(dev, dtype):
    """The MicroBatcher's smallest bucket: the attention at the three
    serving shapes, NMS over the serving pool and the conv on the 640
    square's 160 x 160 map in both layouts, each at B = 1, held to its
    plain version with the tolerances above."""
    rtol, atol = ATTENTION_TOL[dtype]
    for N, D in ((400, 256), (256, 512), (100, 1024)):
        args = _attention_args(1, N, D, dtype, dev, seed=N)
        for g, w in zip(dual_cross_attention(*args),
                        dual_cross_attention_reference(*args)):
            torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                       atol=atol)
    _nms_equal(*_nms_inputs(1, 1024, dev, seed=7, pad=-0.5), 0.45, 300)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for layout in (torch.channels_last, torch.contiguous_format):
        args = _conv_args((1, 64, 160, 160), dtype, layout, dev)
        torch.testing.assert_close(conv3x3_bn_silu(*args).float(),
                                   conv3x3_bn_silu_reference(*args).float(),
                                   rtol=tol, atol=tol)


def test_batcher_and_predict_paths_on_the_card_match_the_cpu(dev, tmp_path):
    """The tiny model in fp32: predict_paths (pipelined) over three JPEG
    pairs, and the MicroBatcher over six concurrent requests, on the card
    against the CPU engine. The decoded predictions agree to 1e-3 (the test
    above), so at least 90 % of each image's detections have a partner of
    the same class at IoU > 0.5 both ways (smoke_common.matched)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import cv2

    from icafusion_tpu_torch.serve.batcher import MicroBatcher
    model = build_model(tiny_icafusion_config(),
                        generator=torch.Generator().manual_seed(0))
    engines = {d: ServingEngine(model, (64, 96), 4, conf_thres=0.1,
                                dtype="float32", device=d)
               for d in (dev, "cpu")}
    rng = np.random.default_rng(1)
    paths = ([], [])
    for i, hw in enumerate([(120, 160), (64, 96), (90, 90)]):
        for tag, lst in zip(("rgb", "ir"), paths):
            p = tmp_path / f"{tag}{i}.jpg"
            cv2.imwrite(str(p), rng.integers(0, 256, (*hw, 3), np.uint8))
            lst.append(str(p))
    rgb = rng.integers(0, 256, (6, 64, 96, 3), np.uint8)
    ir = rng.integers(0, 256, (6, 64, 96, 3), np.uint8)
    want = engines["cpu"].predict_paths(*paths)
    got = engines[dev].predict_paths(*paths)
    want += [engines["cpu"].predict_arrays(rgb[i:i + 1], ir[i:i + 1])[0]
             for i in range(6)]
    with MicroBatcher(engines[dev], max_wait_ms=200.0) as mb:
        mb.warmup()
        barrier = threading.Barrier(6)

        def call(i):
            barrier.wait(timeout=60)
            return mb.submit(rgb[i], ir[i])

        with ThreadPoolExecutor(6) as ex:
            got += list(ex.map(call, range(6)))
        assert mb.stats()["requests"] == 6
    assert sum(len(g) for g in got) > 0
    for g, w in zip(got, want):
        assert smoke_common.matched(g, w) >= 0.9
        assert smoke_common.matched(w, g) >= 0.9


# ---- data parallel on the one card (parallel/mesh.py) ---------------------


def test_replica_engine_on_one_card_matches_one_replica(dev):
    """ServingEngine(n_devices=2) of yolov5l-Transfusion at 640 in bf16, both
    replicas on cuda:0 (smoke_parallel.two_replicas_on_one_card), one batch of
    4 against two one-replica batches of 2: the same detections (boxes
    within 1e-3 px), each kernel launched once per replica."""
    from icafusion_tpu_torch.models.zoo import icafusion_config
    model = build_model(icafusion_config("l", nc=3),
                        generator=torch.Generator().manual_seed(0))
    with smoke_parallel.two_replicas_on_one_card():
        two = ServingEngine(model, 640, 4, conf_thres=0.001, n_devices=2)
    one = ServingEngine(model, 640, 2, conf_thres=0.001)
    rng = np.random.default_rng(3)
    rgb, ir = (rng.integers(0, 256, (4, 640, 640, 3), np.uint8)
               for _ in range(2))
    two.predict_arrays(rgb, ir)
    a0, n0 = dual_cross_attention.launches, greedy_nms.launches
    got = two.predict_arrays(rgb, ir)
    assert (dual_cross_attention.launches - a0,
            greedy_nms.launches - n0) == (6, 2)
    want = one.predict_arrays(rgb[:2], ir[:2]) + one.predict_arrays(
        rgb[2:], ir[2:])
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, :5], w[:, :5], rtol=0, atol=1e-3)


def _bn_rank(x, g):
    """One gloo rank of the test below: its rows through BatchNorm2d on
    cuda:0, the gradient of sum(y * g); everything gathered on rank 0."""
    import torch.distributed as dist

    from icafusion_tpu_torch.nn.layers import BN_EPS, BN_MOMENTUM, BatchNorm2d
    from icafusion_tpu_torch.parallel import mesh
    lo, hi = mesh.process_batch_slice(len(x))
    bn = BatchNorm2d(x.shape[1], eps=BN_EPS, momentum=BN_MOMENTUM).cuda()
    xr = torch.from_numpy(x[lo:hi]).cuda().requires_grad_()
    y = bn.train()(xr)
    (y * torch.from_numpy(g[lo:hi]).cuda()).sum().backward()
    out = [None] * mesh.world()
    dist.all_gather_object(out, {k: v.detach().cpu().numpy() for k, v in (
        ("y", y), ("dx", xr.grad), ("var", bn.running_var))})
    return out


def test_batchnorm_over_two_gloo_ranks_on_one_card(dev):
    """Two gloo ranks sharing cuda:0 (NCCL refuses two ranks on one GPU),
    each with 4 of a global batch of 8 at the first C3's width and map of
    yolov5l 640 (128 channels at 160 x 160): BatchNorm's output, input
    gradient and running variance equal one process's on the 8, within
    fp32 summation noise (1e-4 of values of order 1)."""
    from icafusion_tpu_torch.nn.layers import BN_EPS, BN_MOMENTUM, BatchNorm2d
    from icafusion_tpu_torch.parallel import mesh
    rng = np.random.default_rng(4)
    x = (rng.normal(0, 2, (8, 128, 160, 160)) + 1).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    ranks = mesh.spawn(_bn_rank, 2, (x, g), backend="gloo", timeout=300)
    bn = BatchNorm2d(128, eps=BN_EPS, momentum=BN_MOMENTUM).to(dev).train()
    xt = torch.from_numpy(x).to(dev).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(g).to(dev)).sum().backward()
    for k, want in (("y", y), ("dx", xt.grad)):
        np.testing.assert_allclose(np.concatenate([r[k] for r in ranks]),
                                   want.detach().cpu().numpy(), atol=1e-4)
    np.testing.assert_array_equal(ranks[0]["var"], ranks[1]["var"])
    np.testing.assert_allclose(ranks[0]["var"], bn.running_var.cpu().numpy(),
                               rtol=1e-5)


# ---- reference weights and the legacy modules (chip_smoke.py phase 13) ----


def test_grouped_conv_launches_no_fused_conv(dev):
    """A grouped 64 -> 64 3x3 Conv (depthwise, and g = 2) and a DWConv run
    cuDNN on the card, never the fused 64-channel kernel, and equal the
    CPU; the ungrouped one launches it once."""
    from icafusion_tpu_torch.nn.layers import DWConv
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 20, 20, generator=gen)
    for conv in (Conv(64, 64, 3, 1, g=64), Conv(64, 64, 3, 1, g=2),
                 DWConv(64, 64, 3, 1), Conv(64, 64, 3, 1)):
        conv.eval()
        with torch.no_grad():
            want = conv(x)
            n = conv3x3_bn_silu.launches
            got = conv.to(dev)(x.to(dev)).cpu()
        assert conv3x3_bn_silu.launches - n == (conv.conv.groups == 1)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_pt_model_serves_as_the_weights_in_memory(dev, tmp_path):
    """The tiny model written as an fp16 reference .pt (EMA first, zeros
    under "model") and read by load_model_for_inference serves on the card
    exactly as the fp16-rounded weights in memory, with one attention
    launch per fusion block and one NMS a batch."""
    from icafusion_tpu_torch.cli._common import load_model_for_inference
    from icafusion_tpu_torch.smoke.reference import save_reference
    from icafusion_tpu_torch.utils.torch_convert import reverse_convert
    model = build_model(tiny_icafusion_config(),
                        generator=torch.Generator().manual_seed(0))
    pt = save_reference(reverse_convert(model), tmp_path / "tiny.pt",
                        fp16=True, decoy=True)
    _, from_pt = load_model_for_inference("zoo:tiny", str(pt))
    with torch.no_grad():
        for v in model.state_dict().values():
            if v.is_floating_point():
                v.copy_(v.half().float())
    rng = np.random.default_rng(5)
    rgb, ir = (rng.integers(0, 256, (4, 64, 96, 3), np.uint8)
               for _ in range(2))
    out = []
    for m in (model, from_pt):
        eng = ServingEngine(m, (64, 96), 4, conf_thres=0.01, dtype="bfloat16")
        a0, n0 = dual_cross_attention.launches, greedy_nms.launches
        out.append(eng.predict_arrays(rgb, ir))
        assert (dual_cross_attention.launches - a0,
                greedy_nms.launches - n0) == (3, 1)
    assert sum(len(d) for d in out[0]) > 0
    for a, b in zip(*out):
        assert np.array_equal(a, b)


def test_kitchen_sink_on_the_card_matches_the_cpu(dev):
    """The graph of the 17 legacy YAML modules (smoke/reference.py) at 64 px
    in fp32: decoded predictions on the card within 1e-3 of the CPU's, one
    NMS launch a batch, no fused conv and no attention."""
    from icafusion_tpu_torch.smoke.reference import kitchen_sink_config
    model = build_model(kitchen_sink_config(),
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(6)
    rgb, ir = (rng.integers(0, 256, (2, 64, 64, 3), np.uint8)
               for _ in range(2))
    pred = {}
    for d in (dev, "cpu"):
        eng = ServingEngine(model, 64, 2, dtype="float32", device=d)
        with torch.inference_mode():
            x, y = (torch.from_numpy(a).to(eng.device).permute(0, 3, 1, 2)
                    .float() / 255 for a in (rgb, ir))
            pred[str(d)] = eng.model(x, y).cpu()
        if d == dev:
            before = (dual_cross_attention.launches, greedy_nms.launches,
                      conv3x3_bn_silu.launches)
            eng.predict_arrays(rgb, ir)
            after = (dual_cross_attention.launches, greedy_nms.launches,
                     conv3x3_bn_silu.launches)
            assert tuple(b - a for a, b in zip(before, after)) == (0, 1, 0)
    torch.testing.assert_close(pred[str(dev)], pred["cpu"], rtol=1e-3,
                               atol=1e-3)


GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_autograd_matches_the_plain_gradients(dev, dtype):
    """Under grad the attention wrapper launches the kernel through its
    autograd Function (one launch a forward) and its backward is the
    plain version's vjp: the tokens', weights' and biases' gradients
    equal autograd's through the plain version (fp32 1e-4, bf16 3e-2 of
    each gradient's largest value); the forward within the kernel
    tolerances."""
    vis, ir, ws, bs = (
        t.requires_grad_() if torch.is_tensor(t) else
        [w.requires_grad_() for w in t]
        for t in _attention_args(2, 100, 256, dtype, dev, seed=21))
    inputs = [vis, ir, *ws, *bs]
    before = dual_cross_attention.launches
    out = dual_cross_attention(vis, ir, ws, bs)
    assert dual_cross_attention.launches == before + 1
    assert all(o.grad_fn is not None for o in out)
    want = dual_cross_attention_reference(vis, ir, ws, bs)
    g = [torch.randn_like(o) for o in out]
    got_g = torch.autograd.grad(out, inputs, g)
    want_g = torch.autograd.grad(want, inputs, g)
    rtol, atol = ATTENTION_TOL[dtype]
    for o, w in zip(out, want):
        torch.testing.assert_close(o.float(), w.float(), rtol=rtol, atol=atol)
    tol = GRAD_TOL[dtype]
    for a, b in zip(got_g, want_g):
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                   atol=tol * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_autograd_matches_the_plain_gradients(dev, dtype):
    """The fused conv under grad: x's, w's, scale's and bias's gradients
    from the plain version's vjp, equal to autograd's through it; an
    eval-mode Conv(64, 64, 3, 1) forward under grad keeps a grad_fn and
    gives the BatchNorm parameters gradients."""
    args = [t.requires_grad_() for t in _conv_args(
        (2, 64, 24, 40), dtype, torch.channels_last, dev)]
    before = conv3x3_bn_silu.launches
    out = conv3x3_bn_silu(*args)
    assert conv3x3_bn_silu.launches == before + 1 and out.grad_fn is not None
    want = conv3x3_bn_silu_reference(*args)
    g = torch.randn_like(out)
    tol = GRAD_TOL[dtype]
    for a, b in zip(torch.autograd.grad(out, args, g),
                    torch.autograd.grad(want, args, g)):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                   atol=tol * float(b.float().abs().max()))
    mod = Conv(64, 64, 3, 1).eval().to(dev)
    x = torch.randn(1, 64, 16, 16, device=dev, requires_grad=True)
    mod(x).sum().backward()
    assert x.grad is not None and mod.bn.weight.grad is not None
    assert conv3x3_bn_silu.launches == before + 2


def test_int8_conv_and_nms_raise_under_grad_on_the_card(dev):
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, w8, s_in, s_w, bn, s, p = smoke_int8.int8_case(
        1, (16, 32, 3, 1, 8, 8), torch.float32, gen)
    with pytest.raises(RuntimeError, match="conv_int8_bn_act"):
        conv_int8_bn_act(x.requires_grad_(), w8, s_in, s_w, bn, s, p)
    boxes, scores = _nms_inputs(1, 64, dev, seed=1, pad=-1.0)
    with pytest.raises(RuntimeError, match="greedy_nms"):
        greedy_nms(boxes.requires_grad_(), scores, 0.45, 10)


# (Cin, Cout, k, s, H, W, groups): depthwise 3x3 and 5x5 (GhostConv's), a
# stride-2 DWConv (GhostBottleneck's), g = 2 with Cout / g past one
# 128-channel tile, g = 4 on a 1x1 and a ragged map
INT8_GROUPED_CASES = [(64, 64, 3, 1, 20, 20, 64), (24, 24, 5, 1, 16, 16, 24),
                      (32, 32, 3, 2, 16, 16, 32), (64, 320, 3, 1, 9, 13, 2),
                      (48, 96, 1, 1, 7, 11, 4),
                      # the CPU tests' four classes, a channel multiplier
                      # of 2, 7x7 depthwise, 128 groups (two chunks)
                      (32, 32, 3, 1, 13, 18, 32), (32, 48, 3, 2, 13, 18, 2),
                      (16, 16, 5, 1, 13, 18, 16), (24, 48, 1, 1, 13, 18, 4),
                      (16, 32, 3, 1, 15, 10, 16), (8, 8, 7, 1, 21, 19, 8),
                      (128, 128, 3, 2, 23, 17, 128)]


@pytest.mark.parametrize("case", INT8_GROUPED_CASES)
@pytest.mark.parametrize("layout", [torch.channels_last,
                                    torch.contiguous_format])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_grouped_direct_path_matches_reference(dev, case, layout, dtype):
    """A grouped conv takes the "grouped" path: its int32
    accumulators equal the plain version's exactly (with a per-tensor
    s_in, as quantize_model gives a grouped conv), its outputs within
    smoke_int8.INT8_TOL of the largest."""
    from icafusion_tpu_torch.kernels.conv_int8 import (
        conv_int8_bn_act_reference, plan_for)
    *shape, g = case
    gen = torch.Generator(device="cuda").manual_seed(sum(case))
    x, w8, s_in, s_w, bn, s, p = smoke_int8.int8_case(2, tuple(shape), dtype,
                                                      gen, layout)
    w8 = w8[..., :shape[0] // g].contiguous()
    s_in = s_in.max().reshape(())
    args = (x, w8, s_in, s_w, bn, s, p)
    assert plan_for(x, w8, s, p, groups=g).path == "grouped"
    before = conv_int8_bn_act.grouped_launches
    acc = conv_int8_bn_act(*args, epilogue=False, groups=g)
    out = conv_int8_bn_act(*args, groups=g)
    assert conv_int8_bn_act.grouped_launches == before + 2
    ref_acc = conv_int8_bn_act_reference(*args, epilogue=False, groups=g)
    ref = conv_int8_bn_act_reference(*args, groups=g)
    torch.cuda.synchronize()
    assert torch.equal(acc, ref_acc)
    tol = smoke_int8.INT8_TOL[dtype] * float(ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= tol


def test_each_custom_op_matches_its_wrapper(dev):
    """torch.ops.icafusion.* on CUDA tensors launch the wrappers' kernels
    (each counted once) and give the wrappers' outputs bit for bit."""
    from icafusion_tpu_torch.kernels import ops
    vis, ir, ws, bs = _attention_args(2, 100, 256, torch.bfloat16, dev)
    n = dual_cross_attention.launches
    got = torch.ops.icafusion.dual_cross_attention(vis, ir, ws, bs, 8)
    want = dual_cross_attention(vis, ir, ws, bs)
    assert dual_cross_attention.launches == n + 2
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    args = _conv_args((2, 64, 20, 20), torch.bfloat16, torch.channels_last,
                      dev)
    got = torch.ops.icafusion.conv3x3_bn_silu(*args)
    assert torch.equal(got, conv3x3_bn_silu(*args))
    assert got.stride() == args[0].stride()
    gen = torch.Generator(device="cuda").manual_seed(2)
    x, w8, s_in, s_w, bn, s, p = smoke_int8.int8_case(
        2, (64, 96, 3, 1, 20, 24), torch.bfloat16, gen)
    n = conv_int8_bn_act.launches
    got = ops.conv_int8_bn_act(x, w8, s_in, s_w, bn, s, p, True, True, 1)
    want = conv_int8_bn_act(x, w8, s_in, s_w, bn, s, p)
    assert conv_int8_bn_act.launches == n + 2 and torch.equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last)
    boxes, scores = _nms_inputs(2, 1024, dev, seed=3, pad=-1.0)
    got = torch.ops.icafusion.greedy_nms(boxes, scores, 0.45, 300)
    want = greedy_nms(boxes, scores, 0.45, 300)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_pt2_of_the_tiny_model_on_the_card(dev, tmp_path):
    """cli.export's program of the tiny model on the card (with --nms):
    its graph holds the icafusion::* nodes, it reloads, and its run
    launches the kernels (3 attention, 3 fused convs, 1 NMS) and equals
    the eager forward bit for bit."""
    from icafusion_tpu_torch.cli.export import export_program, program_ops
    from icafusion_tpu_torch.ops.nms import non_max_suppression
    model = build_model(tiny_icafusion_config(),
                        generator=torch.Generator().manual_seed(0))
    model = model.eval().to(dev)
    program = export_program(model, 2, 64, nms=(0.25, 0.45))
    assert program_ops(program) == {"dual_cross_attention": 3,
                                    "conv3x3_bn_silu": 3, "greedy_nms": 1}
    torch.export.save(program, str(tmp_path / "tiny.pt2"))
    run = torch.export.load(str(tmp_path / "tiny.pt2")).module()
    g = torch.Generator(device="cuda").manual_seed(1)
    x, y = (torch.rand(2, 3, 64, 64, device=dev, generator=g)
            for _ in range(2))
    counts = (dual_cross_attention.launches, conv3x3_bn_silu.launches,
              greedy_nms.launches)
    with torch.inference_mode():
        got = run(x, y)
        after = (dual_cross_attention.launches, conv3x3_bn_silu.launches,
                 greedy_nms.launches)
        want = non_max_suppression(model(x, y), 0.25, 0.45, top_k=1024)
    assert tuple(b - a for a, b in zip(counts, after)) == (3, 3, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
