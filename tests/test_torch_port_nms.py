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
    """top_k = 10000, a pool past 8192 candidates (where an earlier card
    design left its registers): 12000 multi-label candidates at conf 0.001
    fill it."""
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
    """The wrapper has no cap on K: 8200 candidates, past the 8192 that an
    earlier card design held in registers. On the CPU it runs the plain
    loop."""
    from icafusion_tpu_torch.kernels.nms import greedy_nms
    boxes, scores = _candidates(2, 8200, 8192)
    keep, ok = greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                          0.45, 5)
    assert keep.shape == ok.shape == (2, 5)
    assert ok[0].all() and not ok[1].any()


def _bitmask_walk(boxes, scores, iou_thres, max_det):
    """The card's algorithm (csrc/greedy_nms.cu) in plain numpy, for sorted
    scores: a dense mask, row i marking each j > i with IoU(i, j) >
    iou_thres in float32 in the plain loop's operation order; then a walk
    with a forward cursor. A step picks the first candidate at or past the
    cursor that is not removed, if its score is > -1, keeps it with ok =
    (score > 0) and removes its row; otherwise the walk ends and the slots
    left are (0, False). The kernel reads "score > -1" and "score > 0" as
    j < live and j < pos, the counts of those scores, which sorted scores
    make prefixes. Step 0 of an image with no score > -1 picks index 0 in
    the argmax loop with ok False: the slot the ended walk writes."""
    B, K, _ = boxes.shape
    f = np.float32
    x1, y1, x2, y2 = (boxes[..., c].astype(f) for c in range(4))
    area = (x2 - x1) * (y2 - y1)
    keep = np.zeros((B, max_det), np.int32)
    ok = np.zeros((B, max_det), bool)
    for b in range(B):
        iw = np.maximum(np.minimum(x2[b][:, None], x2[b][None])
                        - np.maximum(x1[b][:, None], x1[b][None]), f(0))
        ih = np.maximum(np.minimum(y2[b][:, None], y2[b][None])
                        - np.maximum(y1[b][:, None], y1[b][None]), f(0))
        inter = iw * ih
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = inter / (area[b][None] + area[b][:, None] - inter + f(1e-12))
        mask = (iou > f(iou_thres)) & np.triu(np.ones((K, K), bool), 1)
        removed = np.zeros(K, bool)
        cursor = 0
        for step in range(max_det):
            free = np.flatnonzero(~removed[cursor:])
            if not len(free) or not scores[b, cursor + free[0]] > -1:
                break
            j = cursor + free[0]
            keep[b, step], ok[b, step] = j, scores[b, j] > 0
            removed |= mask[j]
            cursor = j + 1
    return keep, ok


def _sorted_candidates(B, K, pad, seed, degenerate=False, n_valid=None):
    """Clustered boxes, scores with exact ties sorted descending, `pad`
    after n_valid (80 % by default) and in the whole last image;
    degenerate adds zero-area boxes and boxes with x2 < x1."""
    rng = np.random.default_rng(seed)
    ctr = np.repeat(rng.uniform(0, 200, (B, (K + 7) // 8, 2)), 8, axis=1)
    xy = ctr[:, :K] + rng.normal(0, 6, (B, K, 2))
    wh = rng.uniform(10, 60, (B, K, 2))
    if degenerate:
        wh[:, ::5] = 0.0
        wh[:, 1::7, 0] *= -1.0
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = -np.sort(-np.round(rng.uniform(0, 1, (B, K)) * 32) / 32, axis=1)
    scores[:, int(0.8 * K) if n_valid is None else n_valid:] = pad
    scores[-1] = pad
    return boxes, scores.astype(np.float32)


BITMASK_CASES = [
    # K, max_det, padding, degenerate
    (1, 300, -1.0, False),      # max_det > K, every image padding
    (63, 300, 0.0, False),      # live padding picked with ok False
    (65, 40, -0.5, True),
    (200, 300, -2.0, False),    # padding below the removed value -1
    (256, 100, -1.0, True),
    (130, 500, -0.5, False),
]


@pytest.mark.parametrize("K,max_det,pad,degenerate", BITMASK_CASES,
                         ids=[f"K{c[0]}-det{c[1]}-pad{c[2]}-deg{c[3]:d}"
                              for c in BITMASK_CASES])
def test_bitmask_walk_equals_the_argmax_loop(K, max_det, pad, degenerate):
    """The card's scan rule against the plain loop and the Pallas kernel,
    keep and ok in every slot: ties, padding of 0, -0.5, -1 and -2, zero-area
    and inverted boxes, max_det past the live candidates and past K, K not a
    multiple of 32 or 64."""
    boxes, scores = _sorted_candidates(3, K, pad, seed=K, degenerate=degenerate)
    got = _bitmask_walk(boxes, scores, 0.45, max_det)
    ref = greedy_nms_reference(torch.from_numpy(boxes),
                               torch.from_numpy(scores), 0.45, max_det)
    pal = pallas_greedy_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.45,
                            max_det, interpret=True)
    for k, o in (ref, pal):
        np.testing.assert_array_equal(got[0], np.asarray(k))
        np.testing.assert_array_equal(got[1], np.asarray(o))


def test_bitmask_walk_when_everything_is_removed():
    """Identical boxes: the first pick removes every other candidate, live
    padding (-0.5) included, long before max_det; and an image whose
    positives are all removed while spread-out live padding (0.0) is left
    to pick with ok False."""
    K = 96
    boxes = np.tile(np.float32([10, 10, 50, 50]), (2, K, 1))
    far = np.arange(40, K, dtype=np.float32) * 100
    boxes[1, 40:, 0] = boxes[1, 40:, 2] = far
    boxes[1, 40:, 2] += 30
    scores = np.zeros((2, K), np.float32)
    scores[0, :50], scores[0, 50:] = 0.9, -0.5
    scores[1, :40], scores[1, 40:] = 0.8, 0.0
    got = _bitmask_walk(boxes, scores, 0.45, 80)
    ref = greedy_nms_reference(torch.from_numpy(boxes),
                               torch.from_numpy(scores), 0.45, 80)
    pal = pallas_greedy_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.45, 80,
                            interpret=True)
    for k, o in (ref, pal):
        np.testing.assert_array_equal(got[0], np.asarray(k))
        np.testing.assert_array_equal(got[1], np.asarray(o))
    assert got[1][0].tolist() == [True] + [False] * 79
    assert got[0][1, :57].tolist() == [0] + list(range(40, K))
    assert got[1][1].sum() == 1
