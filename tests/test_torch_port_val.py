"""The port's validation data and scoring against the JAX package: the rect
protocol (rect_val_canvas, rect_val_batches) on the n320 val pairs,
confluence, the COCO AP/AR suite and the KAIST miss-rate suite. Numpy and
cv2 only: no JAX compile."""

import json
from pathlib import Path

import numpy as np
import pytest

from icafusion_tpu.data import datasets as jax_datasets
from icafusion_tpu.data.loader import PairedLoader as JaxPairedLoader
from icafusion_tpu.eval import cocoeval as jax_cocoeval
from icafusion_tpu.eval import kaist as jax_kaist
from icafusion_tpu.ops import confluence as jax_confluence
from icafusion_tpu_torch.data import datasets
from icafusion_tpu_torch.data.loader import PairedLoader
from icafusion_tpu_torch.eval import cocoeval, kaist
from icafusion_tpu_torch.ops import confluence

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "artifacts" / "trained_n320" / "data"
FIX = Path(__file__).parent / "fixtures"


def _val_sets(n=None):
    ours = datasets.PairedDetectionDataset(
        str(DATA / "visible" / "val"), str(DATA / "infrared" / "val"), 320,
        nc=3)
    theirs = jax_datasets.PairedDetectionDataset(
        str(DATA / "visible" / "val"), str(DATA / "infrared" / "val"),
        img_size=320, nc=3)
    if n is not None:
        for ds in (ours, theirs):
            ds.files_rgb, ds.files_ir = ds.files_rgb[:n], ds.files_ir[:n]
            ds.labels = ds.labels[:n]
    return ours, theirs


def test_rect_val_canvas_matches_jax():
    """Every n320 val pair (256 x 256 images): the same native shapes and
    the same canvas, one 352 x 352 group at 320; other strides and pads
    too; and the extval geometry (512 x 640 images at 640: 544 x 672)."""
    ours, theirs = _val_sets()
    np.testing.assert_array_equal(ours.image_shapes(), theirs.image_shapes())
    canvases = set()
    for i in range(len(ours)):
        got = ours.rect_val_canvas(i)
        assert got == theirs.rect_val_canvas(i)
        canvases.add(got)
        for kw in ({"stride": 64}, {"pad": 0.0}, {"stride": 16, "pad": 1.0}):
            assert ours.rect_val_canvas(i, **kw) == theirs.rect_val_canvas(
                i, **kw), kw
    assert canvases == {(352, 352)}
    for ds in (ours, theirs):
        ds.img_size = 640
        ds._image_shapes = np.array([[512, 640], [640, 512], [480, 640]])
    for i in range(3):
        assert ours.rect_val_canvas(i) == theirs.rect_val_canvas(i)
    assert ours.rect_val_canvas(0) == (544, 672)
    assert ours.rect_val_canvas(1) == (672, 544)


def test_rect_val_batches_match_jax():
    """Pixels, labels, shapes, count and paths of every rect batch (7
    pairs in batches of 4, the last padded), against the JAX package."""
    ours, theirs = _val_sets(7)
    got = list(PairedLoader(ours, 4).rect_val_batches())
    want = list(JaxPairedLoader(theirs, 4, shuffle=False).rect_val_batches())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["rgb"].shape == (4, 352, 352, 3)
        np.testing.assert_array_equal(g["rgb"], w["rgb"])
        np.testing.assert_array_equal(g["ir"], w["ir"])
        assert g["count"] == w["count"] and g["paths"] == w["paths"]
        assert g["shapes"] == w["shapes"]
        for a, b in zip(g["labels"], w["labels"]):
            np.testing.assert_array_equal(a, b)
    assert got[1]["count"] == 3


def _predictions(seed, B=2, N=100, nc=3):
    """Decoded predictions (B, N, 5 + nc): clustered xywh boxes, scores in
    [0, 1], so that confluence merges some and keeps others."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(40, 600, (B, N // 10, 1, 2))
    xy = (ctr + rng.normal(0, 5, (B, N // 10, 10, 2))).reshape(B, N, 2)
    wh = rng.uniform(10, 80, (B, N, 2))
    obj = rng.uniform(0, 1, (B, N, 1))
    cls = rng.uniform(0, 1, (B, N, nc))
    return np.concatenate([xy, wh, obj, cls], -1).astype(np.float32)


@pytest.mark.parametrize("seed,conf,p", [(0, 0.1, 0.6), (1, 0.3, 0.6),
                                         (2, 0.2, 0.4)])
def test_confluence_matches_jax(seed, conf, p):
    pred = _predictions(seed)
    got = confluence.confluence_process(pred, conf_thres=conf, p_thres=p)
    want = jax_confluence.confluence_process(pred, conf_thres=conf,
                                             p_thres=p)
    assert len(got) == len(want) == 2
    for x, g, w in zip(pred, got, want):
        x = x[x[:, 4] > conf]
        n_cand = int((x[:, 5:] * x[:, 4:5] > conf).sum())   # multi-label
        assert 0 < len(g) < n_cand          # some kept, some merged away
        np.testing.assert_array_equal(g, w)
    single = _predictions(seed, nc=1)
    for g, w in zip(confluence.confluence_process(single, conf, p),
                    jax_confluence.confluence_process(single, conf, p)):
        np.testing.assert_array_equal(g, w)


def _coco_case(seed, n_img=6, n_cat=3, n_gt=60, n_dt=180):
    """Seeded COCO ground truth (crowds included, areas across the
    small/medium/large buckets) and detections (jittered copies of it and
    random boxes, scores with ties)."""
    rng = np.random.default_rng(seed)
    anns = []
    for i in range(n_gt):
        w, h = rng.uniform(4, 200, 2)
        anns.append({"id": i + 1, "image_id": int(rng.integers(n_img)),
                     "category_id": int(rng.integers(n_cat)),
                     "bbox": [float(rng.uniform(0, 500)),
                              float(rng.uniform(0, 500)), float(w), float(h)],
                     "area": float(w * h),
                     "iscrowd": int(rng.random() < 0.12)})
    gt = {"images": [{"id": i} for i in range(n_img)],
          "annotations": anns,
          "categories": [{"id": c} for c in range(n_cat)]}
    dts = []
    for _ in range(n_dt):
        if rng.random() < 0.6:
            a = anns[rng.integers(len(anns))]
            bb = np.array(a["bbox"]) + rng.normal(0, 6, 4)
            cat, img = a["category_id"], a["image_id"]
        else:
            bb = np.concatenate([rng.uniform(0, 500, 2),
                                 rng.uniform(4, 200, 2)])
            cat, img = int(rng.integers(n_cat)), int(rng.integers(n_img))
        bb[2:] = np.maximum(bb[2:], 1.0)
        dts.append({"image_id": img, "category_id": cat,
                    "bbox": [float(v) for v in bb],
                    "score": float(np.round(rng.random(), 2))})
    return gt, dts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cocoeval_matches_jax(seed, tmp_path):
    """CocoDetEval's precision and recall arrays and the 12 stats, and
    evaluate_files on the same json files: equal to the JAX package's."""
    gt, dts = _coco_case(seed)
    ours, theirs = cocoeval.CocoDetEval(gt, dts), jax_cocoeval.CocoDetEval(
        gt, dts)
    ours.accumulate()
    theirs.accumulate()
    for k in ("precision", "recall"):
        np.testing.assert_array_equal(ours.eval[k], theirs.eval[k])
    stats = ours.summarize(verbose=False)
    np.testing.assert_array_equal(stats, theirs.summarize(verbose=False))
    assert 0 < stats[0] < 1
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    (tmp_path / "dt.json").write_text(json.dumps(dts))
    got, _ = cocoeval.evaluate_files(str(tmp_path / "gt.json"),
                                     str(tmp_path / "dt.json"), verbose=False)
    want, _ = jax_cocoeval.evaluate_files(
        str(tmp_path / "gt.json"), str(tmp_path / "dt.json"), verbose=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, stats)


@pytest.mark.parametrize("result", ["MBNet_result.txt", "MSDS-RCNN_result.txt"])
def test_kaist_matches_jax(result):
    """The nine miss rates and the recall on the shipped KAIST fixtures,
    exactly; and the loaders."""
    ann, res = str(FIX / "KAIST_annotation.json"), str(FIX / result)
    got = kaist.evaluate_kaist(ann, res).as_dict()
    assert got == jax_kaist.evaluate_kaist(ann, res).as_dict()
    assert len(got) == 10 and 0 < got["MR_all"] < 0.2
    ids, gts = kaist.load_kaist_gt(ann)
    jids, jgts = jax_kaist.load_kaist_gt(ann)
    assert ids == jids and dict(gts) == dict(jgts)
    dts, jdts = kaist.load_detections(res), jax_kaist.load_detections(res)
    assert dts.keys() == jdts.keys()
    for k in dts:
        np.testing.assert_array_equal(dts[k], jdts[k])
