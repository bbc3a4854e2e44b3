"""The folded BatchNorm + activation epilogue (kernels/bn_act.py) and the
serving engine's fold (ops/fuse.py: fold_bn_act).

On the CPU: the plain epilogue against the BatchNorm and the activation it
replaces; folded engines (fp32, bf16, merged streams, int8) against the
same model with its activations unfolded; the state_dict, the caller's
model and train mode untouched; the count of folded convs on the flagship.
On the card (marked ``cuda``): the kernel against the plain version. This
file imports no JAX:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_port_bn_epilogue.py
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from icafusion_tpu_torch.kernels.bn_act import (bn_act_, bn_act_reference_,
                                                check_affine)
from icafusion_tpu_torch.models import zoo
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.nn.layers import (BatchNorm2d, Conv, FoldedIdentity,
                                           FoldedSiLU, bn_affine)
from icafusion_tpu_torch.ops.fuse import fold_bn_act
from icafusion_tpu_torch.serve.engine import ServingEngine

PX = 64
LAYOUTS = {"nhwc": torch.channels_last, "nchw": torch.contiguous_format}


def _bn(c, seed):
    """An eval BatchNorm with statistics and affine away from identity."""
    rng = np.random.default_rng(seed)
    bn = BatchNorm2d(c, eps=1e-3).eval()
    t = lambda v: torch.from_numpy(v.astype(np.float32))
    with torch.no_grad():
        bn.running_mean.copy_(t(rng.normal(0, 0.5, c)))
        bn.running_var.copy_(t(rng.uniform(0.5, 1.5, c)))
        bn.weight.copy_(t(rng.uniform(0.5, 1.5, c)))
        bn.bias.copy_(t(rng.normal(0, 0.3, c)))
    return bn


def _y(shape, dtype, layout, seed):
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.normal(0, 2, shape).astype(np.float32))
    return y.to(dtype).contiguous(memory_format=layout)


def _ulp_bf16(r):
    """One bf16 ulp at each value of r (8 significant bits)."""
    _, e = torch.frexp(r.float())
    return torch.ldexp(torch.ones_like(r, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_epilogue_matches_batchnorm_and_activation(dtype, silu, layout):
    """fp32: act(bn(y)) within 1e-6 relative (1e-6 absolute where the
    affine cancels: the fold adds mean * scale into the bias). bf16: within
    one bf16 ulp of act(bn(y)) taken in fp32 and rounded once, which is
    the epilogue's one rounding; y keeps its memory layout and storage."""
    bn = _bn(24, 0)
    y = _y((2, 24, 5, 7), dtype, LAYOUTS[layout], 1)
    act = F.silu if silu else (lambda v: v)
    want = act(bn(y.float()))
    scale, bias = bn_affine(bn)
    check_affine(scale, bias, 24, dtype)
    ptr, strides = y.data_ptr(), y.stride()
    with torch.inference_mode():
        got = bn_act_(y, scale, bias, silu)
    assert got is y and y.data_ptr() == ptr and y.stride() == strides
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:
        r = want.to(dtype).float()
        assert ((got.float() - r).abs() <= _ulp_bf16(r)).all()
        # the reference's rounding of the same fp32 values is exact
        assert torch.equal(got, bn_act_reference_(
            _y((2, 24, 5, 7), dtype, LAYOUTS[layout], 1), scale, bias, silu))


def test_check_affine_refuses_what_the_kernel_cannot_read():
    s = torch.ones(8)
    for dtype in (torch.float32, torch.bfloat16):
        check_affine(s, torch.zeros(8), 8, dtype)
    for bad in (torch.ones(7), torch.ones(8, dtype=torch.bfloat16),
                torch.ones(16)[::2]):
        with pytest.raises(ValueError, match="float32"):
            check_affine(s, bad, 8, torch.bfloat16)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="dtype"):
            check_affine(s, torch.zeros(8), 8, dtype)


def test_plain_epilogue_keeps_float64():
    """A float64 map is computed in float64, not rounded through float32."""
    y = _y((1, 3, 4, 4), torch.float64, torch.contiguous_format, 2)
    y += 1e-12                               # below float32's resolution
    scale = torch.tensor([1.0, 2.0, 0.5], dtype=torch.float64)
    bias = torch.tensor([0.0, 1e-12, -1.0], dtype=torch.float64)
    want = F.silu(y * scale[:, None, None] + bias[:, None, None])
    assert torch.equal(bn_act_reference_(y.clone(), scale, bias), want)


def test_fold_refuses_dtypes_the_kernel_cannot_take(tiny):
    """The fold checks the conv's dtype once, so that a call need not."""
    m = copy.deepcopy(tiny).cast(torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        fold_bn_act(m)


def _randomize_bn(model, seed):
    """BatchNorm statistics and affine away from identity, so that a fold
    that dropped or doubled a term shows."""
    rng = np.random.default_rng(seed)
    t = lambda v: torch.from_numpy(v.astype(np.float32))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(t(rng.normal(0, 0.2, c)))
                m.running_var.copy_(t(rng.uniform(0.5, 1.5, c)))
                m.weight.copy_(t(rng.uniform(0.7, 1.3, c)))
                m.bias.copy_(t(rng.normal(0, 0.2, c)))
    return model


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    model = build_model(zoo.tiny_icafusion_config(),
                        generator=torch.Generator().manual_seed(0))
    return _randomize_bn(model, 1)


def _pairs(n, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (n, PX, PX, 3), np.uint8)
                 for _ in range(2))


def _images(rgb, ir, dtype):
    return tuple((torch.from_numpy(a).permute(0, 3, 1, 2).float() / 255)
                 .to(dtype) for a in (rgb, ir))


def _unfolded(model):
    """A copy of an engine's model with every folded activation put back
    as the plain one: the Conv then runs its BatchNorm module again."""
    m = copy.deepcopy(model)
    for c in m.modules():
        if isinstance(c, Conv) and isinstance(c.act, (FoldedSiLU,
                                                      FoldedIdentity)):
            c.act = nn.SiLU() if c.act.silu else nn.Identity()
    return m


def _folded(model):
    return [m for m in model.modules() if isinstance(m, Conv)
            and isinstance(m.act, (FoldedSiLU, FoldedIdentity))]


@torch.inference_mode()
def _forward(model, x, y):
    return model(x, y).float()


@pytest.mark.parametrize("kind", ["plain", "merged", "int8"])
def test_fp32_engine_matches_its_unfolded_model(tiny, kind):
    """Every float Conv of an fp32 engine is folded (the merged engine's
    block-diagonal ones too), a quantized engine's only where it is not
    int8 (the Detect feeders). The decoded forward equals the unfolded one
    within 1e-5 of each output column's largest magnitude (random weights
    give boxes of up to a thousand pixels; the fold's rounding differs
    from the BatchNorm's by what the CPU's thread count moves them)."""
    eng = ServingEngine(tiny, PX, 2, dtype="float32", device="cpu",
                        merge_streams=2 if kind == "merged" else 0)
    if kind == "int8":
        eng.quantize([_pairs(2, 3)])
    convs = [m for m in eng.model.modules() if isinstance(m, Conv)]
    folded = _folded(eng.model)
    float_convs = [m for m in convs if m.w8 is None]
    assert folded == float_convs and folded
    if kind == "int8":
        assert len(folded) == len(tiny.detect_layer().f)   # its inputs
    x, y = _images(*_pairs(2, 4), torch.float32)
    got, want = _forward(eng.model, x, y), _forward(_unfolded(eng.model), x, y)
    assert ((got - want).abs() <= 1e-5 * want.abs().amax((0, 1))).all()


def test_bf16_engine_within_the_bf16_serving_tolerance(tiny):
    """The folded bf16 engine is no farther from the fp32 model than twice
    the unfolded bf16 model is, at the 99th percentile and the maximum (the
    bf16 serving tolerance of tests/test_torch_port_bf16.py)."""
    eng = ServingEngine(tiny, PX, 2, dtype="bfloat16", device="cpu")
    x, y = _images(*_pairs(2, 5), torch.float32)
    ref = _forward(tiny, x, y)
    xb, yb = x.bfloat16(), y.bfloat16()
    ours = (_forward(eng.model, xb, yb) - ref).abs().numpy()
    theirs = (_forward(_unfolded(eng.model), xb, yb) - ref).abs().numpy()
    for q in (0.99, 1.0):
        assert np.quantile(ours, q) <= 2 * np.quantile(theirs, q), q


def test_engine_state_dict_and_callers_model_unchanged(tiny):
    """The fold adds no state_dict key and changes no value (the buffers
    are non-persistent), and leaves the caller's model as it was."""
    before = {k: v.clone() for k, v in tiny.state_dict().items()}
    acts = [type(m.act) for m in tiny.modules() if isinstance(m, Conv)]
    eng = ServingEngine(tiny, PX, 2, dtype="bfloat16", device="cpu")
    want = copy.deepcopy(tiny).cast(torch.bfloat16).state_dict()
    got = eng.model.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert [type(m.act) for m in tiny.modules()
            if isinstance(m, Conv)] == acts
    assert FoldedSiLU not in acts
    for k, v in tiny.state_dict().items():
        assert torch.equal(v, before[k]), k
    eng.model.load_state_dict(want, strict=True)


def test_loaded_state_dict_refolds_and_a_second_fold_refreshes(tiny):
    """A state_dict loaded into an engine's model, with other BatchNorm
    statistics, reaches its eval forward: it then equals the unfolded
    model with those statistics. Changed in place, the statistics reach it
    once fold_bn_act runs again, which folds each Conv once."""
    eng = ServingEngine(tiny, PX, 2, dtype="float32", device="cpu")
    other = _randomize_bn(copy.deepcopy(tiny), 9)
    x, y = _images(*_pairs(2, 8), torch.float32)
    before = _forward(eng.model, x, y)
    eng.model.load_state_dict(other.state_dict(), strict=True)
    got, want = _forward(eng.model, x, y), _forward(other, x, y)
    assert not torch.allclose(got, before)
    assert ((got - want).abs() <= 1e-5 * want.abs().amax((0, 1))).all()
    _randomize_bn(eng.model, 1)                  # tiny's statistics again
    acts = [m.act for m in _folded(eng.model)]
    hooks = [len(m._load_state_dict_post_hooks) for m in _folded(eng.model)]
    assert fold_bn_act(eng.model) is eng.model
    assert [m.act for m in _folded(eng.model)] == acts
    assert [len(m._load_state_dict_post_hooks)
            for m in _folded(eng.model)] == hooks == [1] * len(acts)
    got, want = _forward(eng.model, x, y), _forward(tiny, x, y)
    assert ((got - want).abs() <= 1e-5 * want.abs().amax((0, 1))).all()


def test_train_mode_forward_and_backward_unchanged_by_the_fold(tiny):
    """A folded model put in train mode runs its BatchNorms on batch
    statistics and its plain activations: the same outputs, gradients and
    running statistics as the model never folded."""
    a = fold_bn_act(copy.deepcopy(tiny)).train()
    b = copy.deepcopy(tiny).train()
    x, y = _images(*_pairs(2, 6), torch.float32)
    outs = []
    for m in (a, b):
        torch.manual_seed(7)                       # the same dropout masks
        raw = m(x, y)
        sum((r.float() ** 2).mean() for r in raw).backward()
        outs.append(raw)
    for ra, rb in zip(*outs):
        assert torch.equal(ra, rb)
    for (k, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa.grad, pb.grad), k
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sb:
        assert torch.equal(sa[k], sb[k]), k


def test_folded_activation_is_plain_in_train_mode():
    scale, bias = torch.full((4,), 2.0), torch.ones(4)
    y = torch.randn(1, 4, 3, 3)
    silu, ident = FoldedSiLU(scale, bias), FoldedIdentity(scale, bias)
    assert isinstance(silu, nn.SiLU) and isinstance(ident, nn.Identity)
    assert torch.equal(silu(y), F.silu(y)) and torch.equal(ident(y), y)
    silu.eval(), ident.eval()
    torch.testing.assert_close(ident(y.clone()), 2 * y + 1)
    torch.testing.assert_close(silu(y.clone()), F.silu(2 * y + 1))
    assert "scale" not in silu.state_dict()


def test_flagship_folds_159_convs_beside_the_6_fused():
    """yolov5l-Transfusion, built on meta tensors: 165 Convs, each folded;
    6 take the fused 64-channel kernel, the other 159 the epilogue."""
    with torch.device("meta"):
        model = build_model(zoo.icafusion_config("l", nc=3, fusion="tfb"))
    fold_bn_act(model)
    convs = [m for m in model.modules() if isinstance(m, Conv)]
    folded = _folded(model)
    assert len(convs) == len(folded) == 165
    assert sum(m.fused for m in folded) == 6
    assert sum(not m.fused for m in folded) == 159


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def dev():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 24, 5, 7), (3, 64, 20, 20),
                                   (2, 5, 3, 3), (1, 3, 1, 1)])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(dev, dtype, silu, layout, shape):
    """Both layouts, the vector modes (C or H * W a multiple of the
    vector) and the per-element one with its scalar tail (odd W, C 5 or
    3), in place. The plain version rounds y * scale before it adds the
    bias, where the kernel's fmaf does not: where the two cancel they
    differ by half an fp32 ulp of y * scale (2e-6 absolute here). fp32:
    besides, expf against torch's silu, a few ulp; bf16: one bf16 ulp."""
    bn = _bn(shape[1], 2)
    scale, bias = (t.to(dev) for t in bn_affine(bn))
    y = _y(shape, dtype, LAYOUTS[layout], 3).to(dev)
    want = bn_act_reference_(y.clone(), scale, bias, silu)
    ptr, n0 = y.data_ptr(), bn_act_.launches
    with torch.inference_mode():
        got = bn_act_(y, scale, bias, silu)
    torch.cuda.synchronize()
    assert got is y and y.data_ptr() == ptr and bn_act_.launches == n0 + 1
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-6)
    else:
        r = want.float()
        assert ((got.float() - r).abs() <= _ulp_bf16(r) + 2e-6).all()


@pytest.mark.cuda
def test_kernel_refuses_grad_and_strided_maps(dev):
    scale, bias = torch.ones(8, device=dev), torch.zeros(8, device=dev)
    y = torch.randn(1, 8, 4, 4, device=dev, requires_grad=True)
    with pytest.raises(ValueError, match="requires grad"):
        bn_act_(y, scale, bias)
    with pytest.raises(ValueError, match="contiguous"):
        bn_act_(torch.randn(1, 8, 4, 8, device=dev)[..., ::2], scale, bias)
    with pytest.raises(TypeError, match="dtype"):
        bn_act_(torch.randn(1, 8, 4, 4, device=dev).half(), scale, bias)
    off = torch.randn(129, device=dev)[1:].view(1, 8, 4, 4)   # 4 bytes in
    with pytest.raises(RuntimeError, match="misaligned"):
        bn_act_(off, scale, bias)
    big = torch.empty((1, 8, 2 ** 14, 2 ** 14), dtype=torch.bfloat16,
                      device=dev)                     # 2^31 elements
    with pytest.raises(RuntimeError, match="invalid argument"):
        bn_act_(big, scale, bias)
