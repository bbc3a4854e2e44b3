"""python -m icafusion_tpu_torch.cli.detect against the JAX package's
cli.detect on the CPU, on one tiny checkpoint written by the JAX side:
the folder branch with every output flag, --rect over two aspect ratios,
--augment on a 64 x 96 canvas, --merge 2, the video branch frame by
frame; the stream branch on a file replayed as a stream; and the drawing
half of utils/plots.py against the JAX package's.

Tolerances: txt rows hold normalised coordinates and confidences printed
with %g (six significant digits); classes and row counts are exact, the
numbers within 1e-4 (fp32 through about 70 layers summed in other orders
moves a box by well under 1e-3 px of a 128 px image). Video detections
rtol 1e-4 / atol 1e-3 px, as tests/test_torch_port_serve.py.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.cli import detect as jax_detect
from icafusion_tpu.utils import plots as jax_plots
from icafusion_tpu_torch.cli import detect
from icafusion_tpu_torch.utils import plots

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The tiny model's flax variables from the JAX initialiser, written by
    flax's serialization as the JAX package's checkpoints are."""
    from flax import serialization

    from icafusion_tpu.models import build_model
    from icafusion_tpu.models.zoo import tiny_icafusion_config
    model = build_model(tiny_icafusion_config(nc=3), dtype=jnp.float32)
    x = jnp.zeros((1, 64, 64, 3))
    v = jax.jit(model.init, static_argnames=("train", "decode"))(
        {"params": jax.random.PRNGKey(0)}, x, x, train=False, decode=False)
    path = tmp_path_factory.mktemp("ckpt") / "w.ckpt"
    path.write_bytes(serialization.msgpack_serialize({
        "params": jax.device_get(v["params"]),
        "batch_stats": jax.device_get(v.get("batch_stats", {})),
        "meta": {"epoch": 0, "best_fitness": 0.0}}))
    return path


def _folders(root, sizes, seed=0):
    import cv2
    vis, ir = root / "vis", root / "ir"
    vis.mkdir(parents=True)
    ir.mkdir()
    rng = np.random.default_rng(seed)
    for stem, hw in sizes:
        for d in (vis, ir):
            cv2.imwrite(str(d / f"{stem}.jpg"),
                        rng.integers(0, 255, (*hw, 3), np.uint8))
    return vis, ir


def _run_both(ckpt, tmp_path, vis, ir, *flags):
    """Run both CLIs with the same flags; (JAX out dir, port out dir)."""
    base = ["--weights", str(ckpt), "--cfg", "zoo:tiny", "--source1",
            str(vis), "--source2", str(ir), *flags]
    jax_detect.main(base + ["--save-dir", str(tmp_path / "jax")])
    detect.main(base + ["--save-dir", str(tmp_path / "port"),
                        "--device", "cpu"])
    return tmp_path / "jax", tmp_path / "port"


def _files(d: Path):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def _assert_txts_equal(want_dir: Path, got_dir: Path, cols: int):
    txts = sorted(want_dir.glob("*.txt"))
    assert txts, "random weights at conf 0.001 must detect"
    assert [t.name for t in txts] == sorted(
        t.name for t in got_dir.glob("*.txt"))
    n = 0
    for t in txts:
        want = np.loadtxt(t, ndmin=2)
        got = np.loadtxt(got_dir / t.name, ndmin=2)
        assert want.shape == got.shape and want.shape[1] == cols
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0,
                                   atol=1e-4)
        n += len(want)
    return n


def test_folder_flags_match_jax(ckpt, tmp_path):
    """--save-txt --save-conf --save-crop --classes 0 1 over three pairs in
    batches of 2 (the last padded): equal rows, and the same crops and
    annotated images by name."""
    vis, ir = _folders(tmp_path / "data", [("a", (96, 128)), ("b", (64, 64)),
                                           ("c", (100, 90))])
    jdir, pdir = _run_both(ckpt, tmp_path, vis, ir, "--img-size", "64",
                           "--batch-size", "2", "--conf-thres", "0.001",
                           "--save-txt", "--save-conf", "--save-crop",
                           "--classes", "0", "1")
    n = _assert_txts_equal(jdir, pdir, 6)
    assert n > 0
    rows = np.concatenate([np.loadtxt(t, ndmin=2)
                           for t in pdir.glob("*.txt")])
    assert set(rows[:, 0].astype(int)) <= {0, 1}
    assert _files(pdir) == _files(jdir)
    assert list(pdir.glob("crops/*/*.jpg"))
    assert (pdir / "a_rgb.jpg").is_file() and (pdir / "a_ir.jpg").is_file()


def test_rect_buckets_match_jax(ckpt, tmp_path, capsys):
    """--rect: 96 x 128 and 128 x 96 sources land in two canvas buckets at
    --img-size 128 (scaleup off keeps r = 1)."""
    vis, ir = _folders(tmp_path / "data", [
        ("a", (96, 128)), ("b", (96, 128)), ("c", (96, 128)),
        ("d", (128, 96)), ("e", (128, 96))], seed=1)
    jdir, pdir = _run_both(ckpt, tmp_path, vis, ir, "--img-size", "128",
                           "--batch-size", "2", "--conf-thres", "0.001",
                           "--rect", "--save-txt", "--nosave")
    assert capsys.readouterr().out.count("2 canvas shape(s)") == 2
    assert _assert_txts_equal(jdir, pdir, 5) > 0
    assert _files(pdir) == _files(jdir)


def test_augment_on_a_rect_canvas_matches_jax(ckpt, tmp_path):
    """--augment on 64 x 96 pairs (--rect at 96: one 64 x 96 canvas); the
    TTA passes run at 64 x 96, 64 x 96 (53 x 79 padded) and 64 x 64."""
    vis, ir = _folders(tmp_path / "data", [("a", (64, 96)), ("b", (64, 96))],
                       seed=2)
    jdir, pdir = _run_both(ckpt, tmp_path, vis, ir, "--img-size", "96",
                           "--batch-size", "2", "--conf-thres", "0.001",
                           "--rect", "--augment", "--save-txt",
                           "--save-conf", "--nosave")
    assert _assert_txts_equal(jdir, pdir, 6) > 0


def _videos(root, n_frames, seed=0):
    import cv2
    rng = np.random.default_rng(seed)
    paths = []
    for name in ("rgb.mp4", "ir.mp4"):
        p = str(root / name)
        w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 10, (128, 96))
        for _ in range(n_frames):
            w.write(rng.integers(0, 255, (96, 128, 3), np.uint8))
        w.release()
        paths.append(p)
    return paths


def test_video_branch_matches_jax_frame_by_frame(ckpt, tmp_path,
                                                 monkeypatch):
    """An mp4v pair of five frames: each frame's detections (native
    pixels) equal JAX's; both write the annotated video."""
    paths = _videos(tmp_path, 5)
    seen = {"jax": [], "port": []}
    for key, mod in (("jax", jax_detect), ("port", detect)):
        draw = mod._annotate_bgr

        def record(im0, pred, names, args, key=key, draw=draw):
            seen[key].append(pred.copy())
            return draw(im0, pred, names, args)

        monkeypatch.setattr(mod, "_annotate_bgr", record)
    jdir, pdir = _run_both(ckpt, tmp_path, *paths, "--img-size", "128",
                           "--conf-thres", "0.001")
    assert len(seen["jax"]) == len(seen["port"]) == 5
    assert sum(len(p) for p in seen["port"]) > 0
    for g, w in zip(seen["port"], seen["jax"]):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, :5], w[:, :5], rtol=1e-4, atol=1e-3)
    for d in (pdir, jdir):
        assert (d / "rgb_det.mp4").is_file()


def test_stream_branch_on_a_replayed_file(ckpt, tmp_path):
    """A file replayed as a paced stream: each frame served once, bounded
    by --max-frames, the latest annotated frame written."""
    from icafusion_tpu_torch.cli._common import load_model_for_inference
    assert detect._is_stream("0") and detect._is_stream("rtsp://cam/1")
    assert not detect._is_stream("a.mp4")
    paths = _videos(tmp_path, 40, seed=1)
    args = detect.parse_args([
        "--weights", str(ckpt), "--cfg", "zoo:tiny", "--source1", paths[0],
        "--source2", paths[1], "--img-size", "64", "--max-frames", "3",
        "--stream-fps", "20", "--save-dir", str(tmp_path / "out")])
    _, model = load_model_for_inference("zoo:tiny", str(ckpt))
    infer = detect.make_infer(model, args, torch.device("cpu"))
    n = detect.detect_streams(args, infer, ["a", "b", "c"],
                              stale_timeout=8.0)
    assert 1 <= n <= 3
    assert (tmp_path / "out" / "stream0_last.jpg").is_file()


def test_unported_and_device(ckpt, tmp_path):
    """--merge 2 (refused before stream merging was ported) against the JAX
    CLI at --merge 2: equal txt rows; and without a card the CLI needs
    --device cpu."""
    vis, ir = _folders(tmp_path / "data", [("a", (64, 64)), ("b", (96, 80))])
    jdir, pdir = _run_both(ckpt, tmp_path, vis, ir, "--img-size", "64",
                           "--conf-thres", "0.001", "--save-txt",
                           "--save-conf", "--merge", "2")
    assert _assert_txts_equal(jdir, pdir, 6) > 0
    base = ["--weights", str(ckpt), "--cfg", "zoo:tiny", "--source1",
            str(vis), "--source2", str(ir), "--save-dir", str(tmp_path / "o")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            detect.main(base)


def test_drawing_matches_jax(tmp_path):
    """plot_one_box, save_one_box and plot_images draw the same pixels as
    the JAX package's (cv2 alone, no matplotlib); plot_labels and
    plot_evolution write their pngs."""
    import cv2
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (96, 128, 3), np.uint8)
    a, b = img.copy(), img.copy()
    plots.plot_one_box(a, (10.4, 12.7, 80.2, 70.9), "car 0.91", plots.color(1))
    jax_plots.plot_one_box(b, (10.4, 12.7, 80.2, 70.9), "car 0.91",
                           jax_plots.color(1))
    np.testing.assert_array_equal(a, b)
    assert plots.COLORS == jax_plots.COLORS
    f1 = plots.save_one_box((10, 12, 80, 70), img, tmp_path / "p" / "x.jpg")
    f2 = jax_plots.save_one_box((10, 12, 80, 70), img,
                                tmp_path / "j" / "x.jpg")
    np.testing.assert_array_equal(cv2.imread(str(f1)), cv2.imread(str(f2)))
    assert plots.save_one_box((10, 12, 80, 70), img,
                              tmp_path / "p" / "x.jpg").name == "x_2.jpg"
    imgs = rng.integers(0, 255, (3, 64, 64, 3), np.uint8)
    t = np.array([[[0, 0.5, 0.5, 0.3, 0.4], [2, 0.2, 0.3, 0.1, 0.1]]] * 3,
                 np.float32)
    m = np.array([[True, False], [True, True], [False, False]])
    np.testing.assert_array_equal(
        plots.plot_images(imgs, t, m, tmp_path / "mosaic.jpg",
                          ["a", "b", "c"]),
        jax_plots.plot_images(imgs, t, m, None, ["a", "b", "c"]))
    assert (tmp_path / "mosaic.jpg").is_file()
    labels = [np.array([[0, 0.5, 0.5, 0.2, 0.2], [1, 0.3, 0.3, 0.1, 0.2]]),
              np.zeros((0, 5))]
    assert plots.plot_labels(labels, ["a", "b"], tmp_path).is_file()
    csv = tmp_path / "evolve.csv"
    csv.write_text("fitness,lr0,momentum\n0.5,0.01,0.9\n0.7,0.02,0.93\n")
    assert Path(plots.plot_evolution(csv)).is_file()


def test_drawing_needs_no_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    img = np.zeros((32, 32, 3), np.uint8)
    plots.plot_one_box(img, (2, 2, 20, 20), "x")
    assert img.any()
    plots.save_one_box((2, 2, 20, 20), img, tmp_path / "c.jpg")
    with pytest.raises(ImportError, match="matplotlib"):
        plots.plot_labels([np.array([[0, 0.5, 0.5, 0.2, 0.2]])], None,
                          tmp_path)
