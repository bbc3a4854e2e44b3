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
from icafusion_tpu_torch.models.assembler import build_model
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


@pytest.mark.parametrize("N,D", [(400, 256), (256, 512), (100, 1024), (7, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_reference(dev, N, D, dtype):
    """The serving path's three shapes and a ragged one (dk = 6). fp32: the
    JAX Pallas test's tolerance. bf16: the plain version rounds q/k/v and the
    probabilities to bf16 (the JAX einsum path); the kernel keeps them in
    fp32 as the Pallas kernel does."""
    args = _attention_args(2, N, D, dtype, dev)
    before = dual_cross_attention.launches
    got = dual_cross_attention(*args)
    assert dual_cross_attention.launches == before + 1
    want = dual_cross_attention_reference(*args)
    rtol, atol = (2e-4, 2e-5) if dtype == torch.float32 else (3e-2, 3e-2)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol)


def test_attention_wrapper_rejects_what_the_kernel_does_not_take(dev):
    vis, ir, ws, bs = _attention_args(1, 16, 64, torch.float32, dev)
    with pytest.raises(TypeError):
        dual_cross_attention(vis.half(), ir.half(), [w.half() for w in ws], bs)
    with pytest.raises(ValueError):
        dual_cross_attention(vis, ir, [w.t() for w in ws], bs)
    with pytest.raises(ValueError):
        dual_cross_attention(vis, ir, ws, [b.bfloat16() for b in bs])


def _nms_inputs(B, K, dev, seed=0):
    """Clustered class-offset boxes, descending scores with exact ties,
    padding after 80 % and a last image that is all padding."""
    rng = np.random.default_rng(seed)
    ctr = np.repeat(rng.uniform(0, 600, (B, (K + 7) // 8, 2)), 8, axis=1)
    xy = ctr[:, :K] + rng.normal(0, 6, (B, K, 2))
    wh = rng.uniform(20, 80, (B, K, 2))
    boxes = np.concatenate([xy, xy + wh], -1)
    boxes += 4096.0 * rng.integers(0, 3, (B, K, 1))
    scores = -np.sort(-np.round(rng.uniform(0, 1, (B, K)) * 64) / 64, axis=1)
    scores[:, int(0.8 * K):] = -1.0
    scores[-1] = -1.0
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    return f(boxes), f(scores)


@pytest.mark.parametrize("K", [1, 300, 1024, 4096, 8192])
def test_nms_kernel_equals_reference(dev, K):
    """Every register-tile size of the kernel (1 to 16 candidates a thread);
    with K = 1 every image is padding."""
    boxes, scores = _nms_inputs(3, K, dev)
    before = greedy_nms.launches
    keep, ok = greedy_nms(boxes, scores, 0.45, 300)
    assert greedy_nms.launches == before + 1
    rkeep, rok = greedy_nms_reference(boxes, scores, 0.45, 300)
    assert torch.equal(ok, rok)
    assert torch.equal(keep, rkeep)


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
