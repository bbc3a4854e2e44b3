"""icafusion_tpu_torch NMS against the JAX package: the plain greedy loop
against the Pallas kernel (interpret mode) and the lax.scan loop, and
non_max_suppression against the JAX one with use_pallas=False."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.kernels.nms import pallas_greedy_nms
from icafusion_tpu.ops import nms as jax_nms
from icafusion_tpu_torch.kernels.nms import greedy_nms_reference
from icafusion_tpu_torch.ops.boxes import box_iou, xywh2xyxy
from icafusion_tpu_torch.ops.nms import (MAX_WH, detections_to_numpy,
                                         non_max_suppression)

torch.set_num_threads(1)


def _candidates(B, K, n_valid, seed=0):
    """Clustered boxes, descending scores with runs of exact ties, padding
    (-1) after n_valid, and a last image that is all padding."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(0, 300, (B, K // 4, 1, 2))
    xy = (ctr + rng.normal(0, 4, (B, K // 4, 4, 2))).reshape(B, K, 2)
    wh = rng.uniform(10, 60, (B, K, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, (B, K)) * 32) / 32
    scores = -np.sort(-scores, axis=1).astype(np.float32)
    scores[:, n_valid:] = -1.0
    scores[-1] = -1.0
    return boxes, scores


@pytest.mark.parametrize("K,n_valid,max_det", [(128, 100, 30), (64, 40, 60),
                                               (256, 256, 300)])
def test_greedy_reference_matches_pallas_and_scan(K, n_valid, max_det):
    """(64, 40, 60): the steps run out of candidates (exhausted steps)."""
    boxes, scores = _candidates(3, K, n_valid)
    keep, ok = greedy_nms_reference(torch.from_numpy(boxes),
                                    torch.from_numpy(scores), 0.45, max_det)
    keep, ok = keep.numpy(), ok.numpy()
    kp, okp = pallas_greedy_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.45,
                                max_det, interpret=True)
    ks, oks = jax.vmap(lambda b, s: jax_nms._greedy_nms(b, s, 0.45, max_det))(
        jnp.asarray(boxes), jnp.asarray(scores))
    for k_j, ok_j in ((kp, okp), (ks, oks)):
        np.testing.assert_array_equal(ok, np.asarray(ok_j))
        np.testing.assert_array_equal(keep[ok], np.asarray(k_j)[ok])
    assert not ok[-1].any()                      # all padding: nothing kept
    # suppression happened: the picks are not just the first candidates
    assert not np.array_equal(keep[0][ok[0]], np.arange(ok[0].sum()))


def _predictions(B, N, nc, seed=1):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 256, (B, N, 2))
    wh = rng.uniform(4, 64, (B, N, 2))
    obj = rng.uniform(0, 1, (B, N, 1))
    cls = rng.uniform(0, 1, (B, N, nc))
    cls[:, ::7] = cls[:, 1::7].max()             # tied class scores
    return np.concatenate([xy, wh, obj, cls], -1).astype(np.float32)


NMS_CASES = [
    dict(conf_thres=0.001),
    dict(conf_thres=0.25),
    dict(conf_thres=0.25, multi_label=True),
    dict(conf_thres=0.001, multi_label=True, classes=(0, 2)),
    dict(conf_thres=0.25, agnostic=True),
    dict(conf_thres=0.25, classes=(1,)),
]


@pytest.mark.parametrize("kw", NMS_CASES, ids=[str(k) for k in NMS_CASES])
def test_non_max_suppression_matches_jax(kw):
    pred = _predictions(2, 400, 3)
    want = jax_nms.non_max_suppression(jnp.asarray(pred), iou_thres=0.45,
                                       max_det=100, top_k=512,
                                       use_pallas=False, **kw)
    got = non_max_suppression(torch.from_numpy(pred), iou_thres=0.45,
                              max_det=100, top_k=512, **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for g, w in zip(detections_to_numpy(got), jax_nms.detections_to_numpy(want)):
        np.testing.assert_array_equal(g[:, 5], w[:, 5])           # classes
        np.testing.assert_allclose(g[:, :5], w[:, :5], rtol=1e-6, atol=1e-5)
    assert got.valid.any()


def test_boxes_match_jax():
    from icafusion_tpu.ops import boxes as jax_boxes
    rng = np.random.default_rng(2)
    xywh = rng.uniform(1, 50, (6, 4)).astype(np.float32)
    a = xywh2xyxy(torch.from_numpy(xywh))
    np.testing.assert_allclose(
        a.numpy(), np.asarray(jax_boxes.xywh2xyxy(jnp.asarray(xywh))))
    b = a.flip(0)
    np.testing.assert_allclose(
        box_iou(a, b).numpy(),
        np.asarray(jax_boxes.box_iou(jnp.asarray(a.numpy()),
                                     jnp.asarray(b.numpy()))), rtol=1e-6)
    assert MAX_WH == jax_nms.MAX_WH


def test_non_max_suppression_past_the_register_pool_matches_jax():
    """top_k = 10000, above the 8192 candidates the card kernel holds in
    registers: 12000 multi-label candidates at conf 0.001 fill the pool."""
    pred = _predictions(1, 4000, 3, seed=3)
    kw = dict(conf_thres=0.001, iou_thres=0.45, multi_label=True,
              max_det=300, top_k=10000)
    want = jax_nms.non_max_suppression(jnp.asarray(pred), use_pallas=False,
                                       **kw)
    got = non_max_suppression(torch.from_numpy(pred), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    (g,), (w,) = detections_to_numpy(got), jax_nms.detections_to_numpy(want)
    assert len(g) == 300
    np.testing.assert_array_equal(g[:, 5], w[:, 5])
    np.testing.assert_allclose(g[:, :5], w[:, :5], rtol=1e-6, atol=1e-5)


def test_greedy_nms_takes_a_pool_past_the_registers():
    """The wrapper has no cap on K (the card kernel spills past
    REGISTER_K); on the CPU it runs the plain loop."""
    from icafusion_tpu_torch.kernels.nms import REGISTER_K, greedy_nms
    boxes, scores = _candidates(2, REGISTER_K + 8, REGISTER_K)
    keep, ok = greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                          0.45, 5)
    assert keep.shape == ok.shape == (2, 5)
    assert ok[0].all() and not ok[1].any()
