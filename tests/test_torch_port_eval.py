"""The port's evaluation slice against the JAX package: the checkpoint
reader, the val data path, the metrics and the Evaluator, on the trained
yolov5n-Transfusion checkpoint and its 77 val pairs (artifacts/trained_n320).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from flax import serialization

from icafusion_tpu.data import augment as jax_augment
from icafusion_tpu.data import datasets as jax_datasets
from icafusion_tpu.data.loader import PairedLoader as JaxPairedLoader
from icafusion_tpu.eval import evaluator as jax_evaluator
from icafusion_tpu.eval import metrics as jax_metrics
from icafusion_tpu.models import zoo as jax_zoo
from icafusion_tpu.models.assembler import build_model as jax_build_model
from icafusion_tpu.utils import checkpoint as jax_checkpoint
from icafusion_tpu_torch.data import augment, datasets
from icafusion_tpu_torch.data.loader import PairedLoader
from icafusion_tpu_torch.eval import evaluator, metrics
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.models.zoo import icafusion_config
from icafusion_tpu_torch.utils import checkpoint
from icafusion_tpu_torch.utils.convert import load_jax_variables

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N320 = ROOT / "artifacts" / "trained_n320"
CKPT = N320 / "stripped.ckpt"
DATA = N320 / "data"
# TRAINED_PARITY.json, ours/fp32: the JAX Evaluator's record on these pairs
JAX_MAP50, JAX_MAP = 0.9787130451428997, 0.787443950285305
GATE = 0.003   # ACCURACY.md: within 0.3 mAP@50 points


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_msgpack_reader_matches_flax():
    """Leaf for leaf: the same paths, types, dtypes (float16) and values,
    meta's Python numbers included."""
    data = CKPT.read_bytes()
    got = _leaves(checkpoint.msgpack_restore(data))
    want = _leaves(serialization.msgpack_restore(data))
    assert [k for k, _ in got] == [k for k, _ in want]
    assert len(got) > 500
    for (path, g), (_, w) in zip(got, want):
        assert type(g) is type(w), path
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, path
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w, path


def test_msgpack_reader_types():
    """Every msgpack type a flax document can hold, through flax's writer:
    scalars of each width, strings, bytes, nested maps, numpy scalars and
    arrays."""
    tree = {"ints": {"a": 1, "b": -3, "c": 300, "d": -40000, "e": 2 ** 40,
                     "f": -2 ** 40},
            "floats": {"x": 0.5, "y": -1e300},
            "misc": {"s": "x" * 40, "t": "é", "n": None, "yes": True,
                     "no": False, "bin": b"\x00\x01" * 200},
            "arrays": {"f16": np.arange(6, dtype=np.float16).reshape(2, 3),
                       "i32": np.arange(70000, dtype=np.int32),
                       "empty": np.zeros((0, 5), np.float32),
                       "scalar": np.float32(2.5)}}
    data = serialization.msgpack_serialize(tree)
    got = checkpoint.msgpack_restore(data)
    for (path, g), (_, w) in zip(_leaves(got), _leaves(tree)):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, path
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w and type(g) is type(w), path
    with pytest.raises(ValueError, match="truncated"):
        checkpoint.msgpack_restore(data[:-3])


def test_inference_variables_match_jax():
    """EMA first, meta dropped, float32 leaves, the same tree as the JAX
    package's load_inference_variables."""
    got = checkpoint.load_inference_variables(CKPT)
    want = jax_checkpoint.load_inference_variables(str(CKPT))
    assert set(got) == {"params", "batch_stats"}
    g, w = _leaves(got), _leaves(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (_, a), (_, b) in zip(g, w):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw,new,kw", [
    ((256, 256), 320, {}),
    ((256, 256), 320, {"scaleup": False}),
    ((480, 640), 320, {}),
    ((123, 77), (96, 160), {}),
    ((500, 300), 256, {"auto": True}),
])
def test_letterbox_matches_jax(hw, new, kw):
    img = np.random.default_rng(0).integers(0, 256, (*hw, 3), np.uint8)
    got = augment.letterbox(img, new, **kw)
    want = jax_augment.letterbox(img, new, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_label_discovery_matches_jax(tmp_path):
    files = datasets.discover_images(str(DATA / "visible" / "val"))
    assert files == jax_datasets.discover_images(str(DATA / "visible" / "val"))
    assert len(files) == 77
    for f in files[:5] + ["/a/images/b.png", "/a/x/c.jpg"]:
        assert datasets.img2label_path(f) == jax_datasets.img2label_path(f)
    for f in files:
        lp = datasets.img2label_path(f)
        np.testing.assert_array_equal(datasets.parse_label_file(lp, 3),
                                      jax_datasets.parse_label_file(lp, 3))
    dup = tmp_path / "dup.txt"
    dup.write_text("1 0.5 0.5 0.2 0.2\n1 0.5 0.5 0.2 0.2\n0 0.1 0.1 0.1 0.1\n")
    np.testing.assert_array_equal(datasets.parse_label_file(str(dup)),
                                  jax_datasets.parse_label_file(str(dup)))
    with pytest.raises(AssertionError, match="exceeds nc"):
        datasets.parse_label_file(str(dup), nc=1)


def _datasets(n):
    """The port's and the JAX package's val sets over the first n pairs."""
    ours = datasets.PairedDetectionDataset(
        str(DATA / "visible" / "val"), str(DATA / "infrared" / "val"), 320,
        nc=3)
    theirs = jax_datasets.PairedDetectionDataset(
        str(DATA / "visible" / "val"), str(DATA / "infrared" / "val"),
        img_size=320, nc=3)
    for ds in (ours, theirs):
        ds.files_rgb, ds.files_ir = ds.files_rgb[:n], ds.files_ir[:n]
        ds.labels = ds.labels[:n]
    return ours, theirs


def test_val_batches_match_jax():
    """Pixels, labels, shapes, count and paths of every batch, the last
    one padded (5 pairs in batches of 4), against val_batches on the JAX
    package's cv2 path."""
    ours, theirs = _datasets(5)
    got = list(PairedLoader(ours, 4).val_batches())
    want = list(JaxPairedLoader(theirs, 4, shuffle=False)
                .val_batches(use_native=False))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        np.testing.assert_array_equal(g["rgb"], w["rgb"])
        np.testing.assert_array_equal(g["ir"], w["ir"])
        assert g["count"] == w["count"] and g["paths"] == w["paths"]
        assert g["shapes"] == w["shapes"]
        for a, b in zip(g["labels"], w["labels"]):
            np.testing.assert_array_equal(a, b)
    assert got[1]["count"] == 1


def _random_stats(seed, n_img=12, nc=3):
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for _ in range(n_img):
        m = int(rng.integers(0, 6))
        xy = rng.uniform(0, 200, (m, 2))
        gt = np.concatenate([rng.integers(0, nc, (m, 1)), xy,
                             xy + rng.uniform(10, 60, (m, 2))], 1)
        n = int(rng.integers(0, 15))
        src = gt[rng.integers(0, max(m, 1), n)] if m else np.zeros((n, 5))
        box = src[:, 1:5] + rng.normal(0, 6, (n, 4))
        cls = np.where(rng.uniform(size=n) < 0.8, src[:, 0],
                       rng.integers(0, nc, n))
        pred = np.concatenate([box, rng.uniform(0, 1, (n, 1)),
                               cls[:, None]], 1).astype(np.float32)
        preds.append(pred)
        gts.append(gt.astype(np.float32))
    return preds, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matching_and_metrics_match_jax(seed):
    """match_predictions, ap_per_class, summarize and ConfusionMatrix on
    random detections near random boxes: equal outputs."""
    preds, gts = _random_stats(seed)
    stats = []
    cm, jcm = metrics.ConfusionMatrix(3), jax_metrics.ConfusionMatrix(3)
    for pred, gt in zip(preds, gts):
        c = evaluator.match_predictions(pred, gt[:, 1:], gt[:, 0])
        np.testing.assert_array_equal(
            c, jax_evaluator.match_predictions(pred, gt[:, 1:], gt[:, 0]))
        stats.append((c, pred[:, 4], pred[:, 5], gt[:, 0]))
        cm.process_batch(pred, gt)
        jcm.process_batch(pred, gt)
    np.testing.assert_array_equal(cm.matrix, jcm.matrix)
    cat = [np.concatenate([s[k] for s in stats]) for k in range(4)]
    for g, w in zip(metrics.ap_per_class(*cat),
                    jax_metrics.ap_per_class(*cat)):
        np.testing.assert_array_equal(g, w)
    got, want = metrics.summarize(stats, 3), jax_metrics.summarize(stats, 3)
    np.testing.assert_array_equal(got.pop("nt"), want.pop("nt"))
    assert got == want
    assert metrics.fitness(np.arange(8)) == jax_metrics.fitness(np.arange(8))
    assert metrics.compute_ap([0.2, 0.6], [1.0, 0.5])[0] == pytest.approx(
        jax_metrics.compute_ap([0.2, 0.6], [1.0, 0.5])[0], abs=0)


@pytest.fixture(scope="module")
def n320():
    """The trained model in the port, with the n320 weights read by the
    port's own reader."""
    return load_jax_variables(build_model(icafusion_config("n", nc=3)),
                              checkpoint.load_inference_variables(CKPT))


def _capture_stats(monkeypatch, module):
    seen = []

    def capture(stats, nc, *a, **kw):
        seen.append(stats)
        return real(stats, nc, *a, **kw)

    real = module.summarize
    monkeypatch.setattr(module, "summarize", capture)
    return seen


def _losses(cfg, jcfg):
    """The port's and the JAX package's YoloLoss for the n320 config."""
    from icafusion_tpu.config import load_hyp_config as jax_hyp
    from icafusion_tpu.models.assembler import (
        anchors_grid_units as jax_anchors)
    from icafusion_tpu.train.loss import YoloLoss as JaxYoloLoss
    from icafusion_tpu_torch.config import load_hyp_config
    from icafusion_tpu_torch.models.assembler import anchors_grid_units
    from icafusion_tpu_torch.train.loss import YoloLoss
    return (YoloLoss(hyp=load_hyp_config(), nc=3,
                     anchors=anchors_grid_units(cfg)),
            JaxYoloLoss(hyp=jax_hyp(), nc=3, anchors=jax_anchors(jcfg)))


def test_evaluator_matches_jax(n320, monkeypatch, tmp_path):
    """The port's Evaluator (CPU, fp32) and the JAX Evaluator on the first
    8 val pairs, each with its package's YoloLoss and both dumps: equal
    stats rows (matches, classes, targets; confidences within fp32
    summation noise), equal headline metrics, val loss items within rtol
    1e-4, the same MR lines and the same COCO entries (numbers within 1e-4
    relative)."""
    ours_stats = _capture_stats(monkeypatch, evaluator)
    jax_stats = _capture_stats(monkeypatch, jax_evaluator)
    ours, theirs = _datasets(8)
    jcfg = jax_zoo.icafusion_config("n", nc=3)
    loss, jloss = _losses(icafusion_config("n", nc=3), jcfg)
    got = evaluator.Evaluator(n320, nc=3, loss_fn=loss, device="cpu").run(
        PairedLoader(ours, 4).val_batches(), 320, confusion=True,
        mr_txt_dir=str(tmp_path / "ours"),
        coco_json=str(tmp_path / "ours.json"))
    jev = jax_evaluator.Evaluator(model=jax_build_model(jcfg), nc=3,
                                  loss_fn=jloss)
    want = jev.run(jax_checkpoint.load_inference_variables(str(CKPT)),
                   JaxPairedLoader(theirs, 4, shuffle=False)
                   .val_batches(use_native=False), 320, confusion=True,
                   mr_txt_dir=str(tmp_path / "jax"),
                   coco_json=str(tmp_path / "jax.json"))
    (g_stats,), (w_stats,) = ours_stats, jax_stats
    assert len(g_stats) == len(w_stats) == 8
    n_det = 0
    for g, w in zip(g_stats, w_stats):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_allclose(g[1], w[1], rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_array_equal(g[3], w[3])
        n_det += len(g[1])
    assert n_det > 100
    np.testing.assert_array_equal(got["cm"], want["cm"])
    for k in ("map50", "map", "mp", "mr"):
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert got["seen"] == 8 and got["map50"] > 0.9
    np.testing.assert_allclose(got["val_loss_items"], want["val_loss_items"],
                               rtol=1e-4)
    assert got["val_loss_items"][0] > 0 and got["val_loss_items"][3] == 0

    def rows(text):
        return [[float(v) for v in line.split(",")]
                for line in text.splitlines()]

    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "ours").iterdir()) == files
    assert "result.txt" in files and len(files) == 9
    for name in files:
        g = rows((tmp_path / "ours" / name).read_text())
        w = rows((tmp_path / "jax" / name).read_text())
        assert len(g) == len(w)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3)
    g, w = (json.loads((tmp_path / f).read_text())
            for f in ("ours.json", "jax.json"))
    assert len(g) == len(w) == n_det
    for a, b in zip(g, w):
        assert (a["image_id"], a["category_id"]) == (b["image_id"],
                                                     b["category_id"])
        np.testing.assert_allclose(a["bbox"] + [a["score"]],
                                   b["bbox"] + [b["score"]], rtol=1e-4,
                                   atol=2e-3)


def test_evaluator_map_over_the_val_set(n320):
    """All 77 pairs through the port (CPU, fp32): mAP@50 and mAP within
    0.3 points of the JAX Evaluator's record."""
    ds = datasets.PairedDetectionDataset(
        str(DATA / "visible" / "val"), str(DATA / "infrared" / "val"), 320,
        nc=3)
    out = evaluator.Evaluator(n320, nc=3, device="cpu").run(
        PairedLoader(ds, 8).val_batches(), 320)
    assert out["seen"] == 77
    assert abs(out["map50"] - JAX_MAP50) <= GATE, out["map50"]
    assert abs(out["map"] - JAX_MAP) <= GATE, out["map"]


def test_evaluator_refuses_what_is_not_ported(n320):
    """The CUDA default; rows that do not divide over the replicas
    (n_devices) and the val loss under TTA are refused as in JAX."""
    if torch.cuda.is_available():
        assert evaluator.Evaluator(n320, 3).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluator.Evaluator(n320, 3)
    ev3 = evaluator.Evaluator(n320, 3, device="cpu", n_devices=3)
    assert len(ev3.replicas) == 3 and ev3.model is ev3.replicas[0]
    z = np.zeros((8, 64, 64, 3), np.uint8)
    with pytest.raises(ValueError, match="8 rows do not divide over 3"):
        ev3._infer(z, z)
    with pytest.raises(ValueError, match="TTA"):
        evaluator.Evaluator(n320, 3, device="cpu", augment=True,
                            loss_fn=lambda *a: None)
    ev = evaluator.Evaluator(n320, 3, device="cpu", n_devices=1)
    assert ev.top_k == 8192 and ev.conf_thres == 0.001
    assert ev.iou_thres == 0.5 and ev.max_det == 300
    assert not ev.augment and not ev.confluence and ev.confluence_p == 0.6
