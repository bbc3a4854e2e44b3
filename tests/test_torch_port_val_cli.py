"""python -m icafusion_tpu_torch.cli.val on the CPU: every task (val, speed,
study) and the dumps and suites (--rect, --save-txt, --save-json,
--coco-gt, --kaist-ann, --confusion, --augment), on a tiny synthetic set
with a checkpoint the port wrote; the flags that are not ported raise with
their ROADMAP items, and without a card the CLI needs --device cpu."""

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


@pytest.mark.parametrize("extra,item", [
    (["--int8"], "A9"), (["--merge", "2"], "A10"),
    (["--cfg", "zoo:nin:s"], "A5"), (["--cfg", "zoo:vgg16:tfb"], "A10")])
def test_unported_flags_raise(setup, tmp_path, extra, item):
    with pytest.raises(NotImplementedError, match=item):
        val.main(_args(setup, tmp_path, *extra))


def test_model_loading(setup):
    """The zoo specs the port has, min sizes, and a .pt refused (A10)."""
    mc, model = _common.load_model_for_inference("zoo:tiny", str(setup[1]))
    assert mc.nc == 3 and not model.training
    assert _common.resolve_model_config("zoo:tfb:s").width_multiple == 0.5
    assert _common.resolve_model_config("zoo:tfb").width_multiple == 1.0
    assert _common.mc_min_size(mc) == 64
    assert _common.mc_min_size(_common.resolve_model_config("zoo:tfb:n")) \
        == 320
    with pytest.raises(NotImplementedError, match="A10"):
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
