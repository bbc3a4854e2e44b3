"""python -m icafusion_tpu_torch.cli.val on the CPU: every task (val, speed,
study) and the dumps and suites (--rect, --save-txt, --save-json,
--coco-gt, --kaist-ann, --confusion, --augment), on a tiny synthetic set
with a checkpoint the port wrote; --int8 with its persisted calibration;
--merge against the JAX package's cli.val; and without a card the CLI
needs --device cpu."""

import json
import sys

import numpy as np
import pytest
import torch

from icafusion_tpu_torch.cli import _common, val
from icafusion_tpu_torch.data.synthetic import make_dataset
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.models.zoo import tiny_icafusion_config
from icafusion_tpu_torch.utils import plots
from icafusion_tpu_torch.utils.checkpoint import msgpack_serialize
from icafusion_tpu_torch.utils.convert import to_jax_variables
from torch_port_common import val_ground_truth

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(data yaml, checkpoint, KAIST gt json, COCO gt json): 14 pairs of
    64 x 80 (3 val), the tiny model with random weights from seed 0."""
    root = tmp_path_factory.mktemp("val")
    data = make_dataset(root / "data", 14, np.random.default_rng(0),
                        hw=(64, 80))
    model = build_model(tiny_icafusion_config(),
                        generator=torch.Generator().manual_seed(0))
    ckpt = root / "tiny.ckpt"
    ckpt.write_bytes(msgpack_serialize({**to_jax_variables(model),
                                        "meta": {"epoch": 0}}))
    return (data, ckpt, *val_ground_truth(data, root / "gt"))


def _args(setup, save_dir, *extra):
    data, ckpt = setup[:2]
    return ["--weights", str(ckpt), "--cfg", "zoo:tiny", "--data", str(data),
            "--img-size", "64", "--batch-size", "2", "--device", "cpu",
            "--save-dir", str(save_dir), *extra]


@pytest.mark.parametrize("rect", [False, True])
def test_val_task_dumps_and_suites(setup, tmp_path, rect):
    """--task val with every dump: result.txt has one line per kept
    detection, as detections.json has one entry; the COCO and KAIST suites
    run on them; metrics.json and the confusion matrix are written."""
    kaist_gt, coco_gt = setup[2:]
    extra = ["--save-txt", "--save-json", "--confusion", "--coco-gt",
             str(coco_gt), "--kaist-ann", str(kaist_gt),
             "--conf-thres", "0.01"] + (["--rect"] if rect else [])
    out = val.main(_args(setup, tmp_path, *extra))
    assert out["seen"] == 3
    dets = json.loads((tmp_path / "detections.json").read_text())
    lines = (tmp_path / "labels" / "result.txt").read_text().splitlines()
    assert len(lines) == len(dets) > 0
    assert {int(l.split(",")[0]) for l in lines} <= {1, 2, 3}
    assert -1 <= out["coco_map"] <= 1 and -1 <= out["coco_map50"] <= 1
    assert out["cm"].shape == (4, 4)
    summary = json.loads((tmp_path / "metrics.json").read_text())
    assert {"map50", "map", "seen", "t_total_ms", "nt"} <= set(summary)
    assert "cm" not in summary


def test_speed_augment_and_study(setup, tmp_path):
    """speed (conf 0.25 / IoU 0.45, no dumps even when asked), --augment,
    and --task study at two sizes: study_*.txt of 10 columns and
    study.png."""
    out = val.main(_args(setup, tmp_path / "speed", "--task", "speed",
                         "--save-txt", "--save-json"))
    assert out["seen"] == 3 and out["t_total_ms"] >= 0
    assert not (tmp_path / "speed" / "labels").exists()
    assert not (tmp_path / "speed" / "detections.json").exists()
    out = val.main(_args(setup, tmp_path / "tta", "--augment"))
    assert out["seen"] == 3
    rows = val.main(_args(setup, tmp_path / "study", "--task", "study",
                          "--study-sizes", "64:129:64"))
    txt = list((tmp_path / "study").glob("study_*.txt"))
    assert len(rows) == 2 and len(txt) == 1
    assert np.loadtxt(txt[0]).shape == (2, 10)
    assert (tmp_path / "study" / "study.png").is_file()


@pytest.mark.parametrize("extra,item", [(["--merge", "2"], "merge")])
def test_unported_flags_raise(setup, tmp_path, extra, item, monkeypatch):
    """--merge 2, which the CLI refused before stream merging was ported:
    the merged graph scores what the unmerged one scores, and what the JAX
    package's cli.val --merge 2 scores on the same checkpoint (P, R,
    mAP@50 and mAP within 1e-6), the JAX loader decoding with cv2 as the
    port does (its C++ decoder rounds differently)."""
    from icafusion_tpu.cli import val as jax_val
    from icafusion_tpu.data import native
    monkeypatch.setattr(native, "available", lambda: False)
    got = val.main(_args(setup, tmp_path / item, *extra))
    plain = val.main(_args(setup, tmp_path / "plain"))
    data, ckpt = setup[:2]
    want = jax_val.main(["--weights", str(ckpt), "--cfg", "zoo:tiny",
                         "--data", str(data), "--img-size", "64",
                         "--batch-size", "2", "--save-dir",
                         str(tmp_path / "jax"), *extra])
    assert got["seen"] == want["seen"] == 3
    for k in ("mp", "mr", "map50", "map"):
        assert got[k] == pytest.approx(plain[k], abs=1e-6), k
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_int8_calibrates_then_loads_the_persisted_calibration(setup, tmp_path,
                                                              capsys):
    """--int8: the first run calibrates on the val batches and writes
    <weights>.calib beside a copy of the checkpoint; a second run loads it
    and scores the same."""
    import shutil
    ckpt = tmp_path / "w.ckpt"
    shutil.copy(setup[1], ckpt)
    argv = _args(setup, tmp_path / "a", "--int8")
    argv[argv.index("--weights") + 1] = str(ckpt)
    first = val.main(argv)
    said = capsys.readouterr().out
    assert "calibrated on 2 batches" in said and "persisted to" in said
    assert (tmp_path / "w.ckpt.calib").is_file()
    second = val.main(argv)
    assert "loaded persisted calibration" in capsys.readouterr().out
    assert first["seen"] == second["seen"] == 3
    assert first["map50"] == second["map50"]


@pytest.mark.parametrize("spec", [
    "zoo:nin:s", "zoo:vgg16:tfb", "zoo:add", "zoo:dmaf:n", "zoo:tiny:nin",
    "zoo:tiny:dmaf", "zoo:vgg16", "zoo:resnet50", "zoo:resnet50:add"])
def test_zoo_specs_match_the_jax_cli(spec):
    """Every fusion family and backbone spec the JAX CLI takes resolves to
    the JAX CLI's graph."""
    from icafusion_tpu.cli._common import \
        resolve_model_config as jax_resolve_config
    from icafusion_tpu.models.assembler import resolve_model as jax_resolve
    from icafusion_tpu_torch.models.assembler import resolve_model
    mc, jmc = (_common.resolve_model_config(spec, nc=2),
               jax_resolve_config(spec, nc=2))
    assert mc.name == jmc.name and mc.nc == 2
    mine, theirs = resolve_model(mc), jax_resolve(jmc)
    assert ([(r.i, r.f, r.module, r.args, r.c2) for r in mine[0]]
            == [(r.i, r.f, r.module, r.args, r.c2) for r in theirs[0]])
    assert mine[1] == theirs[1]


def test_model_loading(setup):
    """The zoo specs the port has, min sizes, and a missing reference .pt
    raising FileNotFoundError."""
    mc, model = _common.load_model_for_inference("zoo:tiny", str(setup[1]))
    assert mc.nc == 3 and not model.training
    assert _common.resolve_model_config("zoo:tfb:s").width_multiple == 0.5
    assert _common.resolve_model_config("zoo:tfb").width_multiple == 1.0
    assert _common.mc_min_size(mc) == 64
    assert _common.mc_min_size(_common.resolve_model_config("zoo:tfb:n")) \
        == 320
    with pytest.raises(FileNotFoundError, match="yolov5l.pt"):
        _common.load_model_for_inference("zoo:tiny", "yolov5l.pt")


def test_needs_a_card_unless_the_cpu_is_asked(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    args = _args(setup, tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        val.main(args[:args.index("--device")] + args[args.index("--device")
                                                      + 2:])


def test_plots_name_matplotlib_when_it_is_missing(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plots.plot_mr_fppi([0.1, 1.0], [0.5, 0.2], tmp_path / "mr.png")


def test_single_cls_scores_collapsed_labels_unlike_jax(setup, tmp_path,
                                                       monkeypatch):
    """--single-cls on two-class labels (class 0 and class 1 on each of
    four images) with detections that are exactly the labels, each of its
    own class. The port collapses the labels to class 0 in the dataset,
    forces the predictions to 0 and scores one class: every label is
    matched, as without --single-cls. The JAX package keeps the labels'
    classes and scores the predictions on their own (ROADMAP, JAX-side
    faults): no class-1 label is ever matched, so class 1 scores 0 and
    mAP@50 falls to half."""
    import cv2

    from icafusion_tpu.cli import val as jax_val
    from icafusion_tpu.eval import evaluator as jax_evaluator
    from icafusion_tpu_torch.eval import evaluator

    root = tmp_path / "data"
    for d in ("visible/val", "infrared/val", "labels/val"):
        (root / d).mkdir(parents=True)
    for i in range(4):
        for d in ("visible", "infrared"):
            cv2.imwrite(str(root / d / "val" / f"{i}.jpg"),
                        np.full((64, 64, 3), 40 * i, np.uint8))
        (root / "labels" / "val" / f"{i}.txt").write_text(
            "0 0.25 0.25 0.25 0.25\n1 0.75 0.75 0.25 0.25\n")
    data = tmp_path / "two.yaml"
    data.write_text(f"path: {root}\nval_rgb: visible/val\n"
                    "val_ir: infrared/val\nnc: 3\nnames: [a, b, c]\n")
    exact = np.array([[8, 8, 24, 24, 0.9, 0], [40, 40, 56, 56, 0.8, 1]],
                     np.float32)
    fake = lambda dets: [exact.copy() for _ in range(dets.boxes.shape[0])]
    monkeypatch.setattr(evaluator, "detections_to_numpy", fake)
    monkeypatch.setattr(jax_evaluator, "detections_to_numpy", fake)
    args = ["--weights", str(setup[1]), "--cfg", "zoo:tiny", "--data",
            str(data), "--img-size", "64", "--batch-size", "2"]
    run = lambda main, name, *extra: main(
        args + ["--save-dir", str(tmp_path / name), *extra])
    port = run(val.main, "p1", "--single-cls", "--device", "cpu")
    port_plain = run(val.main, "p2", "--device", "cpu")
    jax_single = run(jax_val.main, "j1", "--single-cls")
    jax_plain = run(jax_val.main, "j2")
    perfect = port_plain["map50"]
    assert perfect == jax_plain["map50"] > 0.99
    assert port["map50"] == perfect and port["map"] == port_plain["map"]
    assert port["nt"].tolist() == [8]             # one class, 8 labels
    assert jax_single["map50"] == pytest.approx(perfect / 2)
    assert jax_single["per_class"][1]["ap50"] == 0.0


@pytest.mark.parametrize("spec", ["zoo:tiny:nin", "zoo:tiny:dmaf"])
def test_val_and_detect_run_the_other_families(setup, tmp_path, spec):
    """cli.val and cli.detect take a checkpoint of a non-DMFF model: no
    TransformerFusionBlock row (mc_min_size 64), the same data."""
    from pathlib import Path

    import yaml

    from icafusion_tpu_torch.cli import detect
    mc = _common.resolve_model_config(spec, nc=3)
    assert _common.mc_min_size(mc) == 64
    model = build_model(mc, generator=torch.Generator().manual_seed(1))
    ckpt = tmp_path / "family.ckpt"
    ckpt.write_bytes(msgpack_serialize({**to_jax_variables(model),
                                        "meta": {"epoch": 0}}))
    args = _args(setup, tmp_path / "val", "--save-txt")
    args[args.index("--weights") + 1] = str(ckpt)
    args[args.index("--cfg") + 1] = spec
    out = val.main(args)
    assert out["seen"] == 3 and 0 <= out["map50"] <= 1
    d = yaml.safe_load(Path(setup[0]).read_text())
    root = Path(d["path"])
    detect.main(["--weights", str(ckpt), "--cfg", spec, "--source1",
                 str(root / d["val_rgb"]), "--source2",
                 str(root / d["val_ir"]), "--img-size", "64",
                 "--conf-thres", "0.001", "--save-txt", "--nosave",
                 "--device", "cpu", "--save-dir", str(tmp_path / "det")])
    assert len(list((tmp_path / "det").rglob("*.txt"))) == 3
