"""icafusion_tpu_torch's YoloLoss, its BCE variants and bbox_iou against the
JAX package's (train/loss.py, ops/boxes.py), on the same numpy inputs,
float32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.config import load_hyp_config as jax_hyp
from icafusion_tpu.ops import boxes as jax_boxes
from icafusion_tpu.train import loss as jax_loss
from icafusion_tpu_torch.config import load_hyp_config
from icafusion_tpu_torch.ops.boxes import bbox_iou
from icafusion_tpu_torch.train import loss

torch.set_num_threads(1)

STRIDES = (8, 16, 32)
ANCHORS = (np.array([[[10, 13], [16, 30], [33, 23]],
                     [[30, 61], [62, 45], [59, 119]],
                     [[116, 90], [156, 198], [373, 326]]], np.float32)
           / np.array(STRIDES, np.float32)[:, None, None])


def _case(seed, B=2, nt=5, nc=3, imgsz=64, empty=False, same_cell=False):
    """Random raw maps and labels. same_cell: every image holds two boxes
    whose centres fall in one cell and whose shapes pass one anchor, so
    two candidates of different IoU write one objectness cell."""
    rng = np.random.default_rng(seed)
    preds = [rng.normal(0, 1, (B, imgsz // s, imgsz // s, 3, 5 + nc))
             .astype(np.float32) for s in STRIDES]
    labels = []
    for _ in range(B):
        if empty:
            labels.append(np.zeros((0, 5), np.float32))
            continue
        n = int(rng.integers(1, nt + 1))
        lab = np.concatenate([rng.integers(0, nc, (n, 1)),
                              rng.uniform(0.05, 0.95, (n, 2)),
                              rng.uniform(0.03, 0.6, (n, 2))], 1)
        if same_cell:
            twin = lab[:1].copy()
            twin[0, 1:3] += 0.004                 # same cell at every level
            twin[0, 3:5] *= 1.3
            lab = np.concatenate([lab, twin])
        labels.append(lab.astype(np.float32))
    return preds, labels


def _both(seed, nc=3, hyp_kw=None, **case_kw):
    hyp_kw = hyp_kw or {}
    preds, labels = _case(seed, nc=nc, **case_kw)
    targets, mask = loss.pad_targets(labels, 8)
    want_t, want_m = jax_loss.pad_targets(labels, 8)
    np.testing.assert_array_equal(targets, want_t)
    np.testing.assert_array_equal(mask, want_m)
    jl = jax_loss.YoloLoss(hyp=jax_hyp(**hyp_kw), nc=nc, anchors=ANCHORS)
    tl = loss.YoloLoss(hyp=load_hyp_config(**hyp_kw), nc=nc, anchors=ANCHORS)
    return preds, targets, mask, jl, tl


@pytest.mark.parametrize("case", ["targets", "no_targets", "focal",
                                  "same_cell", "one_class", "smoothing"])
def test_loss_matches_jax(case):
    kw = {"targets": {}, "no_targets": {"empty": True},
          "focal": {"hyp_kw": {"fl_gamma": 1.5}},
          "same_cell": {"same_cell": True}, "one_class": {"nc": 1},
          "smoothing": {"hyp_kw": {"label_smoothing": 0.1}}}[case]
    preds, targets, mask, jl, tl = _both(3, **kw)
    want, want_items = jax.jit(lambda *a: jl(*a))(
        [jnp.asarray(p) for p in preds], jnp.asarray(targets),
        jnp.asarray(mask))
    got, items = tl([torch.from_numpy(p) for p in preds],
                    torch.from_numpy(targets), torch.from_numpy(mask))
    np.testing.assert_allclose(items.numpy(), np.asarray(want_items),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    if case == "no_targets":
        assert float(items[0]) == 0.0 and float(items[2]) == 0.0


def test_objectness_scatter_max_keeps_the_best_candidate():
    """Two candidates on one cell: the cell's objectness target is the
    larger IoU, whatever the order they come in (scatter-max)."""
    preds, targets, mask, _, tl = _both(5, same_cell=True)
    p = torch.from_numpy(preds[0])
    _, ny, nx, na, no = p.shape
    c = tl._level_candidates(0, ny, nx, torch.from_numpy(targets),
                             torch.from_numpy(mask))
    flat = ((c["b"] * ny + c["gj"]) * nx + c["gi"]) * na + c["a"]
    val = torch.where(c["valid"], torch.rand(len(flat)), 0.0)
    fwd = torch.zeros(p[..., 0].numel()).scatter_reduce(
        0, flat, val, "amax", include_self=True)
    rev = torch.zeros(p[..., 0].numel()).scatter_reduce(
        0, flat.flip(0), val.flip(0), "amax", include_self=True)
    hit = flat[c["valid"]]
    assert len(hit) > len(hit.unique())           # cells written twice
    assert torch.equal(fwd, rev)
    for cell in hit.unique():
        assert fwd[cell] == val[flat == cell].max()


def test_loss_gradient_matches_jax_grad():
    preds, targets, mask, jl, tl = _both(7)
    want = jax.grad(lambda ps: jl(ps, jnp.asarray(targets),
                                  jnp.asarray(mask))[0])(
        [jnp.asarray(p) for p in preds])
    ps = [torch.from_numpy(p).requires_grad_() for p in preds]
    tl(ps, torch.from_numpy(targets), torch.from_numpy(mask))[0].backward()
    for g, w in zip(ps, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
@pytest.mark.parametrize("xyxy", [True, False])
def test_bbox_iou_matches_jax(kind, xyxy):
    rng = np.random.default_rng(11)
    a = rng.uniform(0, 10, (64, 4)).astype(np.float32)
    b = rng.uniform(0, 10, (64, 4)).astype(np.float32)
    if xyxy:      # proper corners
        a[:, 2:] = a[:, :2] + rng.uniform(0.1, 5, (64, 2))
        b[:, 2:] = b[:, :2] + rng.uniform(0.1, 5, (64, 2))
    flags = {"giou": {"GIoU": True}, "diou": {"DIoU": True},
             "ciou": {"CIoU": True}, "iou": {}}[kind]
    want = jax_boxes.bbox_iou(jnp.asarray(a), jnp.asarray(b), xyxy, **flags)
    got = bbox_iou(torch.from_numpy(a), torch.from_numpy(b), xyxy, **flags)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_ciou_alpha_carries_no_gradient():
    rng = np.random.default_rng(12)
    a = rng.uniform(1, 5, (32, 4)).astype(np.float32)
    b = rng.uniform(1, 5, (32, 4)).astype(np.float32)
    want = jax.grad(lambda x: jax_boxes.bbox_iou(
        x, jnp.asarray(b), False, CIoU=True).sum())(jnp.asarray(a))
    x = torch.from_numpy(a).requires_grad_()
    bbox_iou(x, torch.from_numpy(b), False, CIoU=True).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("name,kw", [
    ("bce_with_logits", {"pos_weight": 1.5}),
    ("focal_bce_with_logits", {"gamma": 1.5}),
    ("qfocal_bce_with_logits", {"gamma": 1.5}),
    ("bce_blur_with_logits", {}),
    ("vf_bce_with_logits", {})])
def test_bce_variants_match_jax(name, kw):
    rng = np.random.default_rng(13)
    logits = rng.normal(0, 2, (64, 5)).astype(np.float32)
    targets = np.where(rng.random((64, 5)) < 0.5, 0.0,
                       rng.uniform(0.2, 1.0, (64, 5))).astype(np.float32)
    want = getattr(jax_loss, name)(jnp.asarray(logits), jnp.asarray(targets),
                                   **kw)
    got = getattr(loss, name)(torch.from_numpy(logits),
                              torch.from_numpy(targets), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert loss.smooth_bce(0.1) == jax_loss.smooth_bce(0.1)
