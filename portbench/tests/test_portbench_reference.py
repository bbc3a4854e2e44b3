"""The plain reference against the measured package on a tiny model of the
same family, fp32 on the CPU, seeded weights: the forward and its decode,
the NMS, W8A8 calibration, quantization and int8 products, and the train
step (loss, dropout, SGD groups and schedule, EMA). The reference imports
nothing of the package; this test imports both."""

import numpy as np
import pytest
import torch

from portbench.core.serving import Inputs, reference_model, to_nchw
from portbench.reference import model as refm
from portbench.reference.nms import nms as ref_nms
from portbench.tests.tiny import MODEL

CFG = {"model": MODEL, "canvas": [64, 64], "frame": [48, 64]}


@pytest.fixture(scope="module")
def pair():
    from icafusion_tpu_torch.config import load_model_config
    from icafusion_tpu_torch.models.assembler import ICAFusionModel
    inp = Inputs(CFG, 2 ** 31 + 3, 8, "cpu")
    ref = reference_model(CFG, inp.state, "cpu")
    port = ICAFusionModel(load_model_config(MODEL))
    port.load_state_dict(inp.state, strict=True)
    return inp, ref, port


def test_the_reference_imports_nothing_of_the_package():
    import inspect
    from portbench.reference import nms, train
    for mod in (refm, nms, train):
        src = inspect.getsource(mod)
        assert "icafusion_tpu" not in src and "import jax" not in src


def test_forward_and_decode_equal_the_package(pair):
    inp, ref, port = pair
    x, y = to_nchw(inp.rgb, "cpu"), to_nchw(inp.ir, "cpu")
    with torch.no_grad():
        pr, logits = ref(x, y)
        pp, _, maps = port(x, y, raw=True, logits=True)
    assert (pr - pp).abs().max() <= 1e-4 * pr.abs().max()
    for lv, m in zip(logits, maps):
        b, na, no = m.shape[0], m.shape[3], m.shape[4]
        ours = lv.view(b, na, no, *lv.shape[2:]).permute(0, 3, 4, 1, 2)
        assert torch.allclose(ours, m, rtol=1e-4, atol=1e-4)


def test_nms_equals_the_package(pair):
    from icafusion_tpu_torch.ops.nms import (detections_to_numpy,
                                             non_max_suppression)
    inp, ref, port = pair
    with torch.no_grad():
        pred = port(to_nchw(inp.rgb, "cpu"), to_nchw(inp.ir, "cpu"))
    for conf, iou in ((0.25, 0.45), (0.4, 0.6), (0.1, 0.3)):
        want = detections_to_numpy(non_max_suppression(
            pred, conf_thres=conf, iou_thres=iou, max_det=300, top_k=1024))
        got = ref_nms(pred, conf, iou, 300, 1024)
        assert sum(len(g) for g in got) > 0
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def test_w8a8_equals_the_package(pair):
    """The same calibration batches: the reference's absmax is the
    package's (two fp32 forwards, to rounding); from the same absmax its
    scales and int weights are the package's exactly, and its exact int8
    forward matches the package's int8 model on the CPU."""
    import copy
    from icafusion_tpu_torch.utils.quantize import (calibrate,
                                                    detect_feeder_skip,
                                                    quantize_model)
    inp, ref, port = pair
    batches = [(inp.rgb[:4], inp.ir[:4]), (inp.rgb[4:], inp.ir[4:])]
    calib = calibrate(port, [(r / 255.0, i / 255.0) for r, i in batches])
    qport = quantize_model(copy.deepcopy(port), calib,
                           skip=detect_feeder_skip(port.cfg))
    am = refm.calibrate(copy.deepcopy(ref),
                        [(to_nchw(r, "cpu"), to_nchw(i, "cpu"))
                         for r, i in batches])

    def port_absmax(name):
        tree = calib
        for k in name.split("."):
            tree = tree[k]
        return torch.from_numpy(tree["absmax"])

    assert set(am) == {n for n, m in port.named_modules()
                       if type(m).__name__ == "Conv"}
    for name, a in am.items():
        assert torch.allclose(a, port_absmax(name), rtol=1e-4, atol=1e-6)
    qref = copy.deepcopy(ref)
    n = refm.quantize(qref, {k: port_absmax(k) for k in am}, q=127)
    quantized = [k for k, m in qport.named_modules()
                 if getattr(m, "w8", None) is not None]
    assert n == len(quantized) > 0
    for name in quantized:
        mp, mr = qport.get_submodule(name), qref.get_submodule(name)
        w_int, s_in, s_w, _ = mr.quant
        assert torch.equal(mp.w8.permute(0, 3, 1, 2).double(), w_int)
        assert torch.equal(mp.s_in, s_in) and torch.equal(mp.s_w, s_w)
    x, y = to_nchw(inp.rgb, "cpu"), to_nchw(inp.ir, "cpu")
    with torch.no_grad():
        a, _ = qref(x, y)
        b = qport(x, y)
    assert (a - b).norm() / a.norm() < 1e-3


def test_int4_is_coarser_than_int8(pair):
    import copy
    inp, ref, _ = pair
    x, y = to_nchw(inp.rgb, "cpu"), to_nchw(inp.ir, "cpu")
    am = refm.calibrate(copy.deepcopy(ref), [(x, y)])
    with torch.no_grad():
        base, _ = ref(x, y)
        errs = []
        for q in (127, 7):
            m = copy.deepcopy(ref)
            refm.quantize(m, am, q=q)
            errs.append(float((m(x, y)[0] - base).norm() / base.norm()))
    assert errs[1] > 3 * errs[0]


def test_the_sgd_groups_equal_the_package(pair):
    from icafusion_tpu_torch.train.optim import param_group
    from icafusion_tpu_torch.utils.convert import flax_paths
    from portbench.reference.train import param_group as ref_group
    _, _, port = pair
    paths = {k: p for k, (c, p) in flax_paths(port).items() if c == "params"}
    names = [n for n, _ in port.named_parameters()]
    assert names and all(ref_group(n) == param_group(paths[n])
                         for n in names)


def test_float32_train_steps_equal_the_package():
    """The train cell's driver in float32 on the tiny model: the measured
    package's Trainer against the reference, every compared number at
    round-off."""
    import json
    import tempfile
    from pathlib import Path
    from portbench.core import runner
    from portbench.tests.tiny import tiny_root
    root = tiny_root(Path(tempfile.mkdtemp()), limits={
        "loss_gap": 1e-6, "grad_gap": 1e-4, "change_gap": 1e-2})
    f = root / "portbench" / "configs" / "yolov5l-tfb-640-bf16.json"
    cfg = json.loads(f.read_text())
    cfg["precision"] = "fp32"
    f.write_text(json.dumps(cfg))
    res = runner.run("yolov5l-tfb-640-bf16.train-b64", 2 ** 31 + 5, 0.5,
                     False, device="cpu", root=root)
    assert res["correct"], res["checks"]
