"""The port's ONNX exporter (icafusion_tpu_torch/export/) against the JAX
package's: on the same weights both write the same bytes, the producer name
aside ("icafusion_tpu_torch" against "icafusion_tpu"), for the tiny tfb,
nin, add and dmaf models, a grouped C3, the legacy kitchen-sink graph, the
--nms tail and the int8 QDQ graphs (tiny and kitchen sink, the latter with
grouped convs); the port's numpy evaluator runs each graph to the port's
CPU forward at the JAX test's scale-aware tolerance; and each package's
protobuf reader parses the other's bytes.

Weights: flax variables from tests/torch_port_common.random_variables,
loaded into the port model by utils/convert.load_jax_variables. MixConv2d
sizes its convs from a jnp.linspace, so the kitchen sink's JAX side runs
under jax.ensure_compile_time_eval."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.config import load_model_config as jax_load_model_config
from icafusion_tpu.export import onnx_proto as jax_proto
from icafusion_tpu.export.onnx_export import export_onnx as jax_export
from icafusion_tpu.models import zoo as jax_zoo
from icafusion_tpu.models.assembler import build_model as jax_build_model
from icafusion_tpu.utils import quantize as jq
from icafusion_tpu_torch.config import load_model_config
from icafusion_tpu_torch.export import onnx_numpy, onnx_proto
from icafusion_tpu_torch.export.onnx_export import export_onnx
from icafusion_tpu_torch.models import zoo
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.smoke.reference import kitchen_sink_yaml
from icafusion_tpu_torch.utils.convert import load_jax_variables
from icafusion_tpu_torch.utils.quantize import quantize_model
from torch_port_common import nchw, random_variables

torch.set_num_threads(1)

PX = 64
NMS = (0.25, 0.45, 512)     # caps that do not bind (the JAX test's)


def _grouped_c3(cfg):
    """The tiny add model with C3 rows carrying g = 2 and e = 0.25 (the JAX
    test_grouped_c3_roundtrip's rewrite)."""
    layers = list(cfg.layers)
    for i, ld in enumerate(layers):
        if ld.module == "C3" and ld.args == (32,):
            layers[i] = dataclasses.replace(ld, args=(32, "True", 2, 0.25))
    return dataclasses.replace(cfg, layers=tuple(layers))


CONFIGS = {
    "tfb": lambda z: z.tiny_icafusion_config(nc=3, fusion="tfb"),
    "nin": lambda z: z.tiny_icafusion_config(nc=3, fusion="nin"),
    "add": lambda z: z.tiny_icafusion_config(nc=3, fusion="add"),
    "dmaf": lambda z: z.tiny_icafusion_config(nc=3, fusion="dmaf"),
    "grouped_c3": lambda z: _grouped_c3(
        z.tiny_icafusion_config(nc=3, fusion="add")),
}


def _configs(name):
    """(JAX config, port config) of a case's graph."""
    if name == "kitchen_sink":
        return (jax_load_model_config(kitchen_sink_yaml()),
                load_model_config(kitchen_sink_yaml()))
    return CONFIGS[name](jax_zoo), CONFIGS[name](zoo)


# (graph, batch, nms, int8)
CASES = {
    "tfb": ("tfb", 1, None, False),
    "nin": ("nin", 1, None, False),
    "add_b2": ("add", 2, None, False),
    "dmaf": ("dmaf", 1, None, False),
    "grouped_c3": ("grouped_c3", 1, None, False),
    "kitchen_sink": ("kitchen_sink", 1, None, False),
    "nms_tail": ("tfb", 2, NMS, False),
    "int8_qdq": ("tfb", 1, None, True),
    "int8_qdq_kitchen_sink": ("kitchen_sink", 1, None, True),
}


def _inputs(batch, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0, 1, (batch, PX, PX, 3)).astype(np.float32)
                 for _ in range(2))


@pytest.fixture(scope="module")
def exported():
    """case -> (JAX bytes, port bytes, port model, rgb, ir), built once."""
    cache = {}

    def get(case):
        if case in cache:
            return cache[case]
        graph, batch, nms, int8 = CASES[case]
        jcfg, cfg = _configs(graph)
        jm = jax_build_model(jcfg)
        rgb, ir = _inputs(batch)
        with jax.ensure_compile_time_eval():
            v = random_variables(jm, jnp.asarray(rgb), jnp.asarray(ir),
                                 train=False)
            model = load_jax_variables(build_model(cfg), v)
            if int8:
                calib = jq.calibrate(jm, v, [(jnp.asarray(rgb),
                                              jnp.asarray(ir))])
                v = jq.quantize_variables(dict(v), calib)
                quantize_model(model, calib)
        want = jax_export(jcfg, jax.tree.map(np.asarray, v), batch=batch,
                          imgsz=PX, nms=nms)
        got = export_onnx(model, batch=batch, imgsz=PX, nms=nms)
        cache[case] = (want, got, model, rgb, ir)
        return cache[case]

    return get


def _body(blob: bytes, producer: str) -> bytes:
    """The model bytes after ir_version and producer_name, the fields
    model_proto writes first."""
    head = onnx_proto._vint(1, 7) + onnx_proto._ld(2, producer.encode())
    assert blob.startswith(head), blob[:40]
    return blob[len(head):]


@pytest.mark.parametrize("case", list(CASES))
def test_onnx_bytes_equal_the_jax_exporters(exported, case):
    want, got, *_ = exported(case)
    assert _body(got, "icafusion_tpu_torch") == _body(want, "icafusion_tpu")
    ops = [n.op_type for n in onnx_proto.load(got).nodes]
    if CASES[case][3]:
        assert ops.count("QuantizeLinear") > 10
        assert ops.count("DequantizeLinear") == 2 * ops.count("QuantizeLinear")
    if CASES[case][2]:
        assert "NonMaxSuppression" in ops


@pytest.mark.parametrize("case", [c for c in CASES if not CASES[c][3]])
def test_numpy_evaluator_matches_the_port_forward(exported, case, tol=2e-3):
    """The float graph run by the port's numpy evaluator against the port's
    CPU forward: decoded predictions at the JAX test's scale-aware
    tolerance (boxes in pixels), or with --nms the same detection multiset
    as ops/nms.py with multi_label (the JAX test's comparison). (The QDQ
    graphs quantize activations per tensor where the model's int8 path
    keeps per-channel scales: the next test bounds them.)"""
    from icafusion_tpu_torch.ops.nms import (detections_to_numpy,
                                             non_max_suppression)
    _, blob, model, rgb, ir = exported(case)
    feeds = {"rgb": rgb.transpose(0, 3, 1, 2), "ir": ir.transpose(0, 3, 1, 2)}
    (out,) = onnx_numpy.run(onnx_proto.load(blob), feeds).values()
    with torch.no_grad():
        pred = model(nchw(rgb), nchw(ir))
    nms = CASES[case][2]
    if nms is None:
        pred = pred.numpy()
        assert out.shape == pred.shape
        np.testing.assert_allclose(out[..., :4], pred[..., :4], rtol=tol,
                                   atol=tol * PX)
        np.testing.assert_allclose(out[..., 4:], pred[..., 4:], rtol=tol,
                                   atol=tol)
        return
    dets = detections_to_numpy(non_max_suppression(
        pred, conf_thres=nms[0], iou_thres=nms[1], multi_label=True,
        max_det=nms[2], top_k=4096))
    want = np.concatenate([np.c_[np.full(len(d), bi), d]
                           for bi, d in enumerate(dets)])
    assert len(want) > 0, "no detections above the threshold"
    order = lambda d: d[np.lexsort((-d[:, 5], d[:, 6], d[:, 0]))]
    got, want = order(out), order(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, [0, 6]], want[:, [0, 6]])
    np.testing.assert_allclose(got[:, 1:5], want[:, 1:5], rtol=tol,
                               atol=tol * PX)
    np.testing.assert_allclose(got[:, 5], want[:, 5], rtol=tol, atol=tol)


def test_int8_qdq_graph_tracks_the_port_int8_forward():
    """On the JAX test_int8_qdq_roundtrip's weights (flax's init, jittered
    by its _jitter) and calibration, the QDQ graph stays within 0.05 of the
    fp32 graph's and of the port's own int8 forward's scores: that test's
    bounds."""
    from test_onnx_export import _jitter
    cfg = zoo.tiny_icafusion_config(nc=3, fusion="tfb")
    jm = jax_build_model(jax_zoo.tiny_icafusion_config(nc=3, fusion="tfb"))
    rgb, ir = _inputs(1)
    x, y = jnp.asarray(rgb), jnp.asarray(ir)
    v = _jitter(jm.init({"params": jax.random.PRNGKey(0)}, x, y,
                        train=False, decode=False), 0)
    model = load_jax_variables(build_model(cfg), v)
    fp_blob = export_onnx(model, batch=1, imgsz=PX)
    quantize_model(model, jq.calibrate(jm, v, [(x, y)]))
    q_blob = export_onnx(model, batch=1, imgsz=PX)
    feeds = {"rgb": rgb.transpose(0, 3, 1, 2), "ir": ir.transpose(0, 3, 1, 2)}
    (fp,) = onnx_numpy.run(onnx_proto.load(fp_blob), feeds).values()
    (q8,) = onnx_numpy.run(onnx_proto.load(q_blob), feeds).values()
    with torch.no_grad():
        qpred = model(nchw(rgb), nchw(ir)).numpy()
    assert np.isfinite(q8).all()
    assert np.abs(q8[..., 4:] - fp[..., 4:]).max() < 0.05
    assert np.abs(q8[..., 4:] - qpred[..., 4:]).max() < 0.05


@pytest.mark.parametrize("reader", ["port_reads_jax", "jax_reads_port"])
def test_each_reader_parses_the_others_bytes(exported, reader):
    want, got, *_ = exported("kitchen_sink")
    blob, mine, theirs = ((want, onnx_proto, jax_proto)
                          if reader == "port_reads_jax"
                          else (got, jax_proto, onnx_proto))
    a, b = mine.load(blob), theirs.load(blob)
    assert (a.opset, a.ir_version, a.graph_name) == (13, 7, b.graph_name)
    assert a.inputs == b.inputs and a.outputs == b.outputs
    assert [(n.op_type, n.inputs, n.outputs, n.name) for n in a.nodes] == \
        [(n.op_type, n.inputs, n.outputs, n.name) for n in b.nodes]
    assert all(repr(x.attrs) == repr(y.attrs) for x, y in zip(a.nodes,
                                                              b.nodes))
    assert a.initializers.keys() == b.initializers.keys()
    for k, v in a.initializers.items():
        np.testing.assert_array_equal(v, b.initializers[k])


def test_unsupported_module_message():
    """Classify is the one registered module without an emitter; the
    message is the JAX exporter's."""
    cfg = zoo.tiny_icafusion_config(nc=3, fusion="tfb")
    bad = dataclasses.replace(cfg.layers[0], module="Classify",
                              args=(16, 16))
    model = build_model(dataclasses.replace(cfg, layers=(bad,)
                                            + cfg.layers[1:]))
    with pytest.raises(NotImplementedError,
                       match=r"module 'Classify' \(layer 0\) has no emitter"):
        export_onnx(model, batch=1, imgsz=PX)


def test_avgpool_and_nms_semantics_of_the_evaluator():
    """The port's copy of the evaluator keeps the JAX one's op semantics:
    AveragePool excludes pad cells (count_include_pad=0), and
    NonMaxSuppression's default max_output_boxes_per_class of 0 selects
    nothing."""
    import torch.nn.functional as F
    x = np.random.default_rng(1).normal(size=(2, 3, 7, 7)).astype(np.float32)
    got = onnx_numpy._pool(x, "AveragePool", (3, 3), (2, 2), (1, 1, 1, 1))
    want = F.avg_pool2d(torch.from_numpy(x), 3, 2, padding=1,
                        count_include_pad=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    boxes = np.array([[[10, 10, 20, 20], [50, 50, 20, 20]]], np.float32)
    scores = np.array([[[0.9, 0.8]]], np.float32)
    assert onnx_numpy._nms(boxes, scores, 0, 0.5, None, 1).shape == (0, 3)
