"""python -m icafusion_tpu_torch.cli.export on the CPU against the JAX
package's cli.export: every target of one tiny checkpoint (weights, onnx,
pt2, --nms, --int8, --validate), the .weights.msgpack tree equal to the
JAX CLI's array for array, the ONNX bytes equal to the JAX CLI's (the
producer aside), the .pt2 program holding the icafusion::* operators and
reloading bit-equal to the eager forward, and the refused targets."""

import shutil

import numpy as np
import pytest
import torch

from icafusion_tpu.cli import export as jax_export_cli
from icafusion_tpu_torch.cli import export
from icafusion_tpu_torch.cli._common import load_model_for_inference
from icafusion_tpu_torch.export import onnx_proto
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.models.zoo import tiny_icafusion_config
from icafusion_tpu_torch.ops.nms import non_max_suppression
from icafusion_tpu_torch.utils.checkpoint import msgpack_serialize
from icafusion_tpu_torch.utils.convert import to_jax_variables

torch.set_num_threads(1)

PX = 64
CONF = 0.3      # the random tiny model keeps fewer than 300 boxes a class


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    model = build_model(tiny_icafusion_config(),
                        generator=torch.Generator().manual_seed(0))
    path = root / "tiny.ckpt"
    path.write_bytes(msgpack_serialize({**to_jax_variables(model),
                                        "meta": {"epoch": 0}}))
    return path


def _argv(ckpt, out, *extra):
    return ["--weights", str(ckpt), "--cfg", "zoo:tiny", "--img-size",
            str(PX), "--device", "cpu", "--out", str(out), *extra]


@pytest.mark.parametrize("nms", [False, True], ids=["decode", "nms"])
def test_every_target_exports_and_validates(ckpt, tmp_path, capsys, nms):
    """--include weights onnx pt2 --int8 --validate (and --nms): exit 0,
    every file written, the ONNX graph OK against the port's forward on
    the CPU, the int8 QDQ graph beside it."""
    flags = ["--include", "weights", "onnx", "pt2", "--int8", "--validate",
             "--conf-thres", str(CONF)] + (["--nms"] if nms else [])
    assert export.main(_argv(ckpt, tmp_path / "m", *flags)) == 0
    out = capsys.readouterr().out
    for suffix in (".pt2", ".onnx", ".int8.onnx", ".weights.msgpack"):
        assert (tmp_path / f"m{suffix}").stat().st_size > 1000, suffix
    assert "vs the port's forward on cpu (OK)" in out
    assert "calibrated on RANDOM inputs" in out
    assert ("int8 validate" in out) == (not nms)
    if nms:
        assert " 0 detections" not in out
        ops = [n.op_type for n in onnx_proto.load(
            (tmp_path / "m.int8.onnx").read_bytes()).nodes]
        assert "NonMaxSuppression" in ops and "QuantizeLinear" in ops


def test_validate_exits_non_zero_when_it_diverges(ckpt, tmp_path, capsys):
    """At conf 0.01 the random model keeps more than 300 boxes: the ONNX
    tail caps each class at 300 where ops/nms.py caps the image, the counts
    differ, and the CLI says DIVERGED and exits 1."""
    argv = _argv(ckpt, tmp_path / "m", "--include", "onnx", "--nms",
                 "--validate", "--conf-thres", "0.01")
    assert export.main(argv) == 1
    assert "DIVERGED" in capsys.readouterr().out


def test_weights_and_onnx_equal_the_jax_clis(ckpt, tmp_path):
    """On the same checkpoint the two CLIs write the same .weights.msgpack
    tree (float16 params and batch_stats, meta) and the same ONNX bytes
    after the producer name."""
    from flax import serialization
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir(), theirs.mkdir()
    w = theirs / "tiny.ckpt"
    shutil.copy(ckpt, w)
    assert export.main(_argv(ckpt, ours / "tiny", "--include", "weights",
                             "onnx")) == 0
    jax_export_cli.main(["--weights", str(w), "--cfg", "zoo:tiny",
                         "--img-size", str(PX), "--include", "weights",
                         "onnx"])
    got, want = (serialization.msgpack_restore(
        (d / "tiny.weights.msgpack").read_bytes()) for d in (ours, theirs))

    def leaves(t, p=()):
        for k, v in t.items():
            yield from (leaves(v, p + (k,)) if isinstance(v, dict)
                        else [(p + (k,), v)])

    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    assert got[("meta", "cfg")] == "zoo:tiny" and got[("meta", "img_size")] \
        == PX
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype == np.float16, k
            np.testing.assert_array_equal(got[k], v, err_msg=str(k))
        else:
            assert got[k] == v, k
    head = lambda p: onnx_proto._vint(1, 7) + onnx_proto._ld(2, p)
    a = (ours / "tiny.onnx").read_bytes()
    b = (theirs / "tiny.onnx").read_bytes()
    assert a[len(head(b"icafusion_tpu_torch")):] == \
        b[len(head(b"icafusion_tpu")):]


@pytest.mark.parametrize("nms", [False, True], ids=["decode", "nms"])
def test_pt2_holds_the_kernel_ops_and_reloads_bit_equal(ckpt, tmp_path, nms):
    """The .pt2 of the CPU export holds 3 icafusion::dual_cross_attention
    and 3 icafusion::conv3x3_bn_silu nodes (and 1 icafusion::greedy_nms
    with --nms); torch.export.load of it gives the eager forward's outputs
    bit for bit."""
    flags = ["--include", "pt2", "--conf-thres", str(CONF)] + (
        ["--nms"] if nms else [])
    assert export.main(_argv(ckpt, tmp_path / "m", *flags)) == 0
    program = torch.export.load(str(tmp_path / "m.pt2"))
    want_ops = {"dual_cross_attention": 3, "conv3x3_bn_silu": 3}
    if nms:
        want_ops["greedy_nms"] = 1
    assert export.program_ops(program) == want_ops
    _, model = load_model_for_inference("zoo:tiny", str(ckpt))
    g = torch.Generator().manual_seed(3)
    x, y = (torch.rand(1, 3, PX, PX, generator=g) for _ in range(2))
    got = program.module()(x, y)
    with torch.no_grad():
        pred, logits = model.eval()(x, y, logits=True)
        want = (tuple(non_max_suppression(pred, conf_thres=CONF,
                                          iou_thres=0.45, top_k=1024))
                if nms else (pred, logits))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("target", ["stablehlo", "savedmodel"])
def test_jax_only_targets_are_refused(ckpt, tmp_path, capsys, target):
    with pytest.raises(SystemExit) as e:
        export.main(_argv(ckpt, tmp_path / "m", "--include", target))
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert ("--include pt2" in err) if target == "stablehlo" \
        else ("not ported" in err)


def test_validate_pairs_tied_scores_by_box():
    """A saturated model ties scores: the validate pairing matches each
    detection to the nearest box of its image and class, where an order by
    score alone would pair tied rows arbitrarily."""
    rows = np.array([[0, 10, 10, 20, 20, 1.0, 1], [0, 50, 50, 60, 60, 1.0, 1],
                     [0, 90, 90, 99, 99, 0.5, 2]], np.float32)
    got, want = export.pair_detections(rows[[1, 0, 2]] + [0, .01, 0, 0, 0,
                                                          0, 0], rows)
    assert np.abs(got[:, 1:5] - want[:, 1:5]).max() < 0.02
    assert (got[:, [0, 6]] == want[:, [0, 6]]).all()
