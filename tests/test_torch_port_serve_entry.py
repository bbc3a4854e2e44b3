"""The port's serving entry points against the JAX package, on the CPU:
merge-NMS, batched_nms and detections_to_records; ServingEngine._dispatch
at each bucket, predict_paths (pipelined and serial), warmup;
decode_letterbox_batch; the MicroBatcher; the HTTP server,
batched and not; the hub; stream merging in the engine and the server.
Model weights are one flax variable tree carried
across with load_jax_variables; the JAX engine gets the port's letterboxed
uint8 arrays, so both see the same pixels (the JAX package decodes files
with its own C++ library).

Tolerances: detections rtol 1e-4 / atol 1e-3 px, as
tests/test_torch_port_serve.py (fp32 through about 70 layers summed in
other orders); classes and counts exact.
"""

import base64
import http.client
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.models import zoo as jax_zoo
from icafusion_tpu.models.assembler import build_model as jax_build_model
from icafusion_tpu.ops import nms as jax_nms
from icafusion_tpu.serve.engine import ServingEngine as JaxServingEngine
from icafusion_tpu_torch import hub
from icafusion_tpu_torch.data.augment import letterbox
from icafusion_tpu_torch.data.decode import decode_letterbox_batch
from icafusion_tpu_torch.models import zoo
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.ops import nms
from icafusion_tpu_torch.serve import http_server
from icafusion_tpu_torch.serve.batcher import MicroBatcher, default_buckets
from icafusion_tpu_torch.serve.engine import ServingEngine
from icafusion_tpu_torch.utils.checkpoint import msgpack_serialize
from icafusion_tpu_torch.utils.convert import load_jax_variables
from test_nms import np_merge_nms_pipeline, random_preds
from torch_port_common import random_variables

torch.set_num_threads(1)

CANVAS = (64, 96)
ENGINE_KW = dict(img_size=CANVAS, batch_size=4, conf_thres=0.001,
                 max_det=100)


def assert_dets_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, :5], w[:, :5], rtol=1e-4, atol=1e-3)


# ---- NMS ---------------------------------------------------------------


@pytest.mark.parametrize("multi_label", [False, True])
def test_merge_nms_matches_jax_and_the_oracle(multi_label):
    """Merge-NMS on clustered candidates: the same kept rows as JAX's
    merge, boxes within 1e-4 (a weighted mean summed in another order),
    scores and classes exact; and the numpy oracle of tests/test_nms.py."""
    rng = np.random.default_rng(3)
    pred = random_preds(rng, 2, 600, 3, frac_confident=0.2)
    kw = dict(conf_thres=0.25, iou_thres=0.45, multi_label=multi_label,
              top_k=4096, merge=True)
    got = nms.detections_to_numpy(
        nms.non_max_suppression(torch.from_numpy(pred), **kw))
    want = jax_nms.detections_to_numpy(
        jax_nms.non_max_suppression(jnp.asarray(pred), **kw))
    oracle = np_merge_nms_pipeline(pred, 0.25, 0.45, multi_label)
    for g, w, o in zip(got, want, oracle):
        assert len(g) == len(w) == len(o) > 0
        np.testing.assert_array_equal(g[:, 4:], w[:, 4:])
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g[:, :4], o[:, :4], rtol=1e-4, atol=1e-2)
    plain = nms.detections_to_numpy(nms.non_max_suppression(
        torch.from_numpy(pred), **{**kw, "merge": False}))
    assert all(len(m) <= len(p) for m, p in zip(got, plain))


@pytest.mark.parametrize("agnostic", [False, True])
def test_batched_nms_matches_jax(agnostic):
    """Unsorted scores with ties and padding (<= 0) and three classes: the
    same keep indices and ok flags as JAX's argmax loop, slot for slot."""
    rng = np.random.default_rng(5)
    K = 300
    ctr = rng.uniform(0, 200, (K // 6, 1, 2))
    xy = (ctr + rng.normal(0, 5, (K // 6, 6, 2))).reshape(-1, 2)
    boxes = np.concatenate([xy, xy + rng.uniform(10, 40, (K, 2))],
                           1).astype(np.float32)
    scores = (np.round(rng.random(K) * 32) / 32).astype(np.float32)
    scores[rng.random(K) < 0.2] = 0.0
    scores[:5] = -0.5
    classes = rng.integers(0, 3, K).astype(np.int32)
    keep, ok = nms.batched_nms(torch.from_numpy(boxes),
                               torch.from_numpy(scores),
                               torch.from_numpy(classes), 0.45, 300,
                               agnostic=agnostic)
    jkeep, jok = jax_nms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                     jnp.asarray(classes), 0.45, 300,
                                     agnostic=agnostic)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert 0 < int(ok.sum()) < 240


def test_detections_to_records_matches_jax():
    rng = np.random.default_rng(0)
    arrs = [rng.random((2, 7, 4)).astype(np.float32) * 100,
            rng.random((2, 7)).astype(np.float32),
            rng.integers(0, 4, (2, 7)).astype(np.int32),
            rng.random((2, 7)) < 0.6]
    names = ["person", "car", "bike"]       # class 3 has no name
    got = nms.detections_to_records(
        nms.Detections(*(torch.from_numpy(a) for a in arrs)), names)
    want = jax_nms.detections_to_records(
        jax_nms.Detections(*(jnp.asarray(a) for a in arrs)), names)
    assert got == want and sum(len(r) for r in got) > 0
    assert {r["name"] for recs in got for r in recs} <= {*names, "3"}


# ---- engine --------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """(port engine on the CPU, JAX engine) of the tiny model with one
    flax variable tree, fp32, batch 4, on the 64 x 96 canvas."""
    jmodel = jax_build_model(jax_zoo.tiny_icafusion_config())
    x = jnp.zeros((1, *CANVAS, 3), jnp.float32)
    v = random_variables(jmodel, x, x, train=False, seed=1)
    model = load_jax_variables(build_model(zoo.tiny_icafusion_config()), v)
    jax_engine = JaxServingEngine(model=jmodel, variables=v, n_devices=1,
                                  dtype="float32", merge_streams=0,
                                  **ENGINE_KW)
    return ServingEngine(model, dtype="float32", device="cpu",
                         **ENGINE_KW), jax_engine


def _pairs(n, seed=0, hw=CANVAS):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, *hw, 3), np.uint8),
            rng.integers(0, 256, (n, *hw, 3), np.uint8))


@pytest.mark.parametrize("bucket,n", [(1, 1), (2, 2), (4, 3)])
def test_dispatch_at_each_bucket_matches_jax(engines, bucket, n):
    """_dispatch pads to the bucket, not the engine batch; the padding
    images' rows are dropped."""
    engine, jax_engine = engines
    rgb, ir = _pairs(n, seed=bucket)
    dets, m = engine._dispatch(rgb, ir, batch=bucket)
    assert m == n and dets.boxes.shape[0] == bucket
    got = engine._finalize(dets, n)
    want = jax_engine._finalize(*jax_engine._dispatch(rgb, ir, batch=bucket))
    assert sum(len(g) for g in got) > 0
    assert_dets_close(got, want)
    with pytest.raises(ValueError, match="bucket"):
        engine._dispatch(rgb, ir, batch=8)


@pytest.fixture(scope="module")
def jpeg_pairs(tmp_path_factory):
    """Five JPEG pairs of three native sizes: (rgb paths, ir paths)."""
    import cv2
    d = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(11)
    rgb, ir = [], []
    for i, hw in enumerate([(120, 160), (96, 128), (64, 96), (120, 160),
                            (80, 80)]):
        for paths, tag in ((rgb, "rgb"), (ir, "ir")):
            p = d / f"{tag}_{i}.jpg"
            cv2.imwrite(str(p), rng.integers(0, 256, (*hw, 3), np.uint8))
            paths.append(str(p))
    return rgb, ir


def test_decode_letterbox_batch_equals_letterbox(jpeg_pairs, tmp_path):
    import cv2
    rgb_p, ir_p = jpeg_pairs
    for canvas, scaleup in ((CANVAS, True), (128, False)):
        rgb, ir, ratios, pads, hw = decode_letterbox_batch(
            rgb_p, ir_p, canvas, scaleup=scaleup, n_threads=3)
        for i, (a, b) in enumerate(zip(rgb_p, ir_p)):
            img = cv2.cvtColor(cv2.imread(a), cv2.COLOR_BGR2RGB)
            lb, ratio, pad = letterbox(img, canvas, scaleup=scaleup)
            np.testing.assert_array_equal(rgb[i], lb)
            np.testing.assert_array_equal(ir[i], letterbox(
                cv2.cvtColor(cv2.imread(b), cv2.COLOR_BGR2RGB), canvas,
                scaleup=scaleup)[0])
            np.testing.assert_array_equal(ratios[i], np.float32(ratio))
            np.testing.assert_array_equal(pads[i], np.float32(pad))
            assert tuple(hw[i]) == img.shape[:2]
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    with pytest.raises(RuntimeError, match="bad.jpg"):
        decode_letterbox_batch([str(bad)], [ir_p[0]], CANVAS)


@pytest.mark.parametrize("pipeline", [True, False])
def test_predict_paths_matches_jax_on_the_same_arrays(engines, jpeg_pairs,
                                                      pipeline):
    """Five pairs in batches of 4 (4 + 1), native coordinates; pipelined
    and serial give equal results, in order."""
    engine, jax_engine = engines
    rgb_p, ir_p = jpeg_pairs
    got = engine.predict_paths(rgb_p, ir_p, pipeline=pipeline)
    rgb, ir, _, _, hw = decode_letterbox_batch(rgb_p, ir_p, CANVAS,
                                               scaleup=True)
    want = []
    for s in (slice(0, 4), slice(4, 5)):
        want += jax_engine.predict_arrays(rgb[s], ir[s],
                                          orig_hw=hw[s].tolist())
    assert sum(len(g) for g in got) > 0
    assert_dets_close(got, want)
    other = engine.predict_paths(rgb_p, ir_p, pipeline=not pipeline)
    for a, b in zip(got, other):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def merged_jax():
    """(the engines' flax variables, a JAX engine over them at
    merge_streams=2)."""
    jmodel = jax_build_model(jax_zoo.tiny_icafusion_config())
    x = jnp.zeros((1, *CANVAS, 3), jnp.float32)
    v = random_variables(jmodel, x, x, train=False, seed=1)
    return v, JaxServingEngine(model=jmodel, variables=v, n_devices=1,
                               dtype="float32", merge_streams=2, **ENGINE_KW)


def test_warmup_throughput_and_unported_options(engines, merged_jax):
    """warmup; merge_streams 0 and "auto" serve unmerged (auto
    is 0 in the port), and merge_streams=2 (refused before stream merging
    was ported) serves the merged graph as the JAX engine at 2 does."""
    engine, _ = engines
    engine.warmup()
    model = build_model(zoo.tiny_icafusion_config())
    for merge in (0, "auto"):
        assert ServingEngine(model, 64, 1, device="cpu",
                             merge_streams=merge).merge_streams == 0
    merged = ServingEngine(engine._float_model, dtype="float32",
                           device="cpu", merge_streams=2, **ENGINE_KW)
    assert merged.model.merge_pairs == 2
    rgb, ir = _pairs(3, seed=11)
    got = merged.predict_arrays(rgb, ir)
    assert sum(len(g) for g in got) > 0
    assert_dets_close(got, merged_jax[1].predict_arrays(rgb, ir))
    assert_dets_close(got, engine.predict_arrays(rgb, ir))
    # int8 serving (A9) works: a copy quantizes on one batch and serves
    q = ServingEngine(engine._float_model, CANVAS, 2, dtype="float32",
                      device="cpu")
    assert q.quantize([_pairs(2, 9)]) is False
    assert all(d.shape[1] == 6 for d in q.predict_arrays(*_pairs(2, 10)))
    with pytest.raises(ValueError, match="at least one batch"):
        ServingEngine(model, 64, 1, device="cpu").quantize([])


# ---- MicroBatcher ---------------------------------------------------------


def test_default_and_invalid_buckets(engines):
    engine, _ = engines
    assert default_buckets(engine) == [1, 2, 4]
    with pytest.raises(ValueError):
        MicroBatcher(engine, buckets=[8])


def test_concurrent_submits_match_jax_and_coalesce(engines):
    """Eight requests released together through a 500 ms window coalesce
    into fewer batches; each equals the JAX engine's serial result."""
    engine, jax_engine = engines
    rgb, ir = _pairs(8, seed=21)
    want = [jax_engine.predict_arrays(rgb[i:i + 1], ir[i:i + 1])[0]
            for i in range(8)]
    with MicroBatcher(engine, max_wait_ms=500.0) as mb:
        mb.warmup()
        barrier = threading.Barrier(8)

        def call(i):
            barrier.wait(timeout=60)
            return mb.submit(rgb[i], ir[i])

        with ThreadPoolExecutor(8) as ex:
            got = list(ex.map(call, range(8)))
        stats = mb.stats()
    assert stats["requests"] == 8 and stats["batches"] < 8
    assert max(stats["bucket_counts"]) >= 2
    assert sum(stats["bucket_counts"].values()) == stats["batches"]
    assert sum(len(g) for g in got) > 0
    assert_dets_close(got, want)


def test_concurrent_predict_arrays_equal_serial_calls(engines):
    """Eight threads calling predict_arrays at once, with no batcher (the
    HTTP server's direct path), batches of 1 to 4 pairs: each gets the
    detections of the same call made alone."""
    engine, _ = engines
    reqs = [_pairs(1 + i % 4, seed=40 + i) for i in range(8)]
    want = [engine.predict_arrays(*r) for r in reqs]
    barrier = threading.Barrier(8)

    def call(r):
        barrier.wait(timeout=60)
        return engine.predict_arrays(*r)

    with ThreadPoolExecutor(8) as ex:
        got = list(ex.map(call, reqs))
    assert sum(len(d) for g in got for d in g) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_orig_hw_rescale_matches_jax(engines):
    engine, jax_engine = engines
    rgb, ir = _pairs(1, seed=3)
    want = jax_engine.predict_arrays(rgb, ir, orig_hw=[(120, 160)])
    with MicroBatcher(engine) as mb:
        got = mb.submit(rgb[0], ir[0], orig_hw=(120, 160))
    assert_dets_close([got], want)


def test_an_error_reaches_every_waiter(engines):
    """Three bad pairs coalesced into one batch: each submitter gets the
    batch's error; then a good request is served."""
    engine, _ = engines
    bad = np.zeros((3, 3, 3), np.uint8)
    with MicroBatcher(engine, max_wait_ms=300.0) as mb:
        barrier = threading.Barrier(3)

        def call(_):
            barrier.wait(timeout=60)
            try:
                mb.submit(bad, bad)
            except ValueError as e:
                return str(e)
            return None

        with ThreadPoolExecutor(3) as ex:
            errors = list(ex.map(call, range(3)))
        assert all(e and "want at most" in e for e in errors), errors
        rgb, ir = _pairs(1, seed=5)
        out = mb.submit(rgb[0], ir[0])
        assert out.ndim == 2 and out.shape[1] == 6
        assert mb.stats()["requests"] == 1


def test_closed_batcher_refuses(engines):
    engine, _ = engines
    mb = MicroBatcher(engine)
    mb.close()
    assert not mb._thread.is_alive()
    rgb, ir = _pairs(1)
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(rgb[0], ir[0])


# ---- HTTP server ----------------------------------------------------------


@pytest.fixture(params=["batched", "direct"])
def server(request, engines):
    engine, _ = engines
    batcher = (MicroBatcher(engine, max_wait_ms=200.0)
               if request.param == "batched" else None)
    srv = http_server.make_server(engine, batcher, ["person", "car", "bike"],
                                  host="127.0.0.1", port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address[1], batcher
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    if batcher is not None:
        batcher.close()


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def test_http_roundtrip_matches_jax(server, engines, jpeg_pairs):
    """Five pairs POSTed from five threads as base64 JPEGs: the records
    equal the JAX engine's detections of the same cv2-decoded pairs in
    native pixels; stats count them where a batcher serves."""
    import cv2
    port, batcher = server
    _, jax_engine = engines
    rgb_p, ir_p = jpeg_pairs
    b64 = lambda p: base64.b64encode(open(p, "rb").read()).decode()
    with ThreadPoolExecutor(5) as ex:
        results = list(ex.map(lambda i: _request(
            port, "POST", "/v1/detect", {"rgb": b64(rgb_p[i]),
                                          "ir": b64(ir_p[i])}), range(5)))
    n_records = 0
    for (status, data), a, b in zip(results, rgb_p, ir_p):
        assert status == 200
        recs = json.loads(data)
        imgs = [cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB) for p in (a, b)]
        lb = [letterbox(im, CANVAS, auto=False, scaleup=True)[0][None]
              for im in imgs]
        want = jax_engine.predict_arrays(*lb, orig_hw=[imgs[0].shape[:2]])[0]
        assert len(recs) == len(want)
        n_records += len(recs)
        for r, w in zip(recs, want):
            assert set(r) == {"xmin", "ymin", "xmax", "ymax", "confidence",
                              "class", "name"}
            assert r["class"] == int(w[5])
            assert r["name"] == ["person", "car", "bike"][r["class"]]
            np.testing.assert_allclose(
                [r[k] for k in ("xmin", "ymin", "xmax", "ymax",
                                "confidence")], w[:5], rtol=1e-4, atol=1e-3)
    assert n_records > 0
    status, data = _request(port, "GET", "/v1/stats")
    if batcher is None:
        assert status == 404
    else:
        assert status == 200 and json.loads(data)["requests"] == 5


def test_http_bad_body_and_unknown_path(server):
    port, _ = server
    status, data = _request(port, "POST", "/v1/detect", {"rgb": "not b64!!"})
    assert status == 400 and "error" in json.loads(data)
    status, _ = _request(port, "POST", "/v1/detect", None)
    assert status == 400
    assert _request(port, "POST", "/nope", {})[0] == 404
    assert _request(port, "GET", "/nope")[0] == 404


def test_http_cli_refuses_what_is_not_ported(tmp_path, merged_jax):
    """The server's flags; --merge 2 (refused before stream merging was
    ported) builds a merged engine that serves as the JAX engine at
    merge_streams=2 does, and --merge auto an unmerged one."""
    v, jax_engine = merged_jax
    ckpt = tmp_path / "w.ckpt"
    ckpt.write_bytes(msgpack_serialize({**v, "meta": {"epoch": 0}}))
    base = ["--weights", str(ckpt), "--cfg", "zoo:tiny", "--device", "cpu"]
    args = http_server.parse_args(base + ["--int8", "--calib-rgb", "a",
                                          "--calib-ir", "b"])
    assert args.int8 and (args.calib_rgb, args.calib_ir) == ("a", "b")
    args = http_server.parse_args(base + ["--img-size", "512x640"])
    assert args.img_size == (512, 640)
    built = {}
    for merge in ("auto", "2"):
        built[merge], batcher = http_server.build(http_server.parse_args(
            base + ["--img-size", "64x96", "--batch-size", "4",
                    "--merge", merge]))
        batcher.close()
    assert built["auto"].merge_streams == built["auto"].model.merge_pairs == 0
    assert built["2"].merge_streams == built["2"].model.merge_pairs == 2
    # the server serves bf16; its merged float32 model, in an fp32 engine
    merged = ServingEngine(built["2"]._float_model, dtype="float32",
                           device="cpu", **ENGINE_KW)
    assert merged.merge_streams == 2
    rgb, ir = _pairs(2, seed=12)
    got = merged.predict_arrays(rgb, ir)
    assert sum(len(g) for g in got) > 0
    assert_dets_close(got, jax_engine.predict_arrays(rgb, ir))


# ---- hub -----------------------------------------------------------------


def test_hub_matches_the_jax_hub(tmp_path):
    """The same names; a checkpoint of the JAX hub's icafusion_tiny gives
    the same decoded predictions in both hubs, and the port's pipeline
    serves like a JAX engine on those weights; the NiN, Add, VGG16 and
    ResNet50 names resolve to the JAX hub's graphs."""
    from icafusion_tpu import hub as jax_hub
    assert hub.list_models() == jax_hub.list_models()
    jmodel, v = jax_hub.create("icafusion_tiny", img_size=64)
    v = jax.device_get(v)
    ckpt = tmp_path / "tiny.ckpt"
    ckpt.write_bytes(msgpack_serialize({**v, "meta": {"epoch": 0}}))
    model = hub.create("icafusion_tiny", weights=str(ckpt))
    rgb, ir = _pairs(2, seed=4, hw=(64, 64))
    want = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, train=False, decode=True)[0])(
            v, jnp.asarray(rgb, jnp.float32) / 255,
            jnp.asarray(ir, jnp.float32) / 255))
    with torch.no_grad():
        x, y = (torch.from_numpy(a).permute(0, 3, 1, 2).float() / 255
                for a in (rgb, ir))
        got = model(x, y).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    engine = hub.pipeline("icafusion_tiny", weights=str(ckpt), img_size=64,
                          batch_size=2, conf_thres=0.001, dtype="float32",
                          device="cpu")
    jax_engine = JaxServingEngine(model=jmodel, variables=v, img_size=64,
                                  batch_size=2, conf_thres=0.001,
                                  n_devices=1, dtype="float32",
                                  merge_streams=0)
    assert_dets_close(engine.predict_arrays(rgb, ir),
                      jax_engine.predict_arrays(rgb, ir))
    seeded = hub.create("icafusion_tiny",
                        generator=torch.Generator().manual_seed(3))
    again = hub.create("icafusion_tiny",
                       generator=torch.Generator().manual_seed(3))
    for a, b in zip(seeded.parameters(), again.parameters()):
        assert torch.equal(a, b)
    assert hub.create("icafusion_s").m0.conv.weight.shape[0] == 32
    from icafusion_tpu.hub import _FACTORIES as jax_factories
    from icafusion_tpu.models.assembler import resolve_model as jax_resolve
    from icafusion_tpu_torch.models.assembler import resolve_model
    for name in ("icafusion_s_nin", "icafusion_l_add", "icafusion_vgg16",
                 "icafusion_resnet50"):
        mine = resolve_model(hub.model_config(name))
        theirs = jax_resolve(jax_factories[name](nc=3))
        assert ([(r.i, r.f, r.module, r.args, r.c2) for r in mine[0]]
                == [(r.i, r.f, r.module, r.args, r.c2) for r in theirs[0]])
        assert mine[1] == theirs[1], name
    nin = hub.create("icafusion_s_nin")
    assert nin.m20.conv.weight.shape == (128, 256, 1, 1)
    with pytest.raises(KeyError):
        hub.create("yolov5s")
