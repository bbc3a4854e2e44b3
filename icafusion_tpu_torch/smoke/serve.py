"""Phase 8 of chip_smoke.py and its --trained-l640 run: serving through the
entry points a user calls (cli.detect, predict_paths, the MicroBatcher,
the HTTP server, video)."""

from __future__ import annotations

import contextlib
import io
import json
import time
from pathlib import Path

import numpy as np
import torch

from icafusion_tpu_torch.smoke.common import (CONVS_PER_FORWARD,
                                              MAP50_GATE, RECT, REPO, S640,
                                              S640_CFG, counted, done,
                                              extval_files, matched, phase,
                                              read_rgb)
from icafusion_tpu_torch.smoke.val import VAL_BATCH
from icafusion_tpu_torch.smoke.int8 import INT8_CONVS_L, int8_record

# Phase 8 (serving through the entry points a user calls) holds the
# results of the MicroBatcher and the HTTP server against serial
# predict_arrays calls on the same pairs, in bf16 at another batch size:
# the share of all their detections that have a partner of the same class
# (matched), both ways. cuDNN may take another algorithm at another batch,
# and one bf16 rounding can reorder near-tied scores or move a score across
# the threshold. The thresholds are set from a run on an H100 80GB HBM3
# at 700 W (PERF.md section 6), which measured 0.9965 behind the batcher
# (the random flagship at conf 0.001) and 0.9967 behind the HTTP server
# (trained s640 at conf 0.25).
MATCH_SHARE = {"http": 0.97, "batcher": 0.97}
SERVE_PAIRS, SERVE_THREADS = 96, 24
HTTP_THREADS = 16


VIDEO_FRAMES = 10
# The random flagship amplifies a difference of rounding through its
# depth, so its bf16 decoded predictions at bucket 32 and at batch 1
# differ far more than the kernels do (that run: 439 px and 0.72 at most,
# 0.0027 at the 99th percentile of obj). In fp32 they are held to these
# (box rtol, box atol px, obj and cls atol); that run measured 0.23 px and
# 7.7e-4 at most.
FP32_BUCKET_TOL = (1e-3, 1.0, 5e-3)


def engine_rows(engine, files1, files2, canvas, auto: bool):
    """Per stem, the rows cli.detect --save-txt writes for each pair, from
    engine.predict_arrays on the pairs letterboxed as detect does
    (scaleup off): [cls, xc, yc, w, h, conf], normalised to the native
    image."""
    from icafusion_tpu_torch.data.augment import letterbox
    from icafusion_tpu_torch.ops.boxes import scale_coords_np
    out = {}
    B = engine.batch_size
    for s in range(0, len(files1), B):
        items = []
        for f1, f2 in zip(files1[s:s + B], files2[s:s + B]):
            a, b = read_rgb(f1), read_rgb(f2)
            la, ratio, pad = letterbox(a, canvas, scaleup=False, auto=auto)
            lb = letterbox(b, canvas, scaleup=False, auto=auto)[0]
            items.append((Path(f1).stem, la, lb, a.shape[:2], (ratio, pad)))
        dets = engine.predict_arrays(np.stack([it[1] for it in items]),
                                     np.stack([it[2] for it in items]))
        for (stem, _, _, (h0, w0), rp), d in zip(items, dets):
            d = d.copy()
            d[:, :4] = scale_coords_np(tuple(engine.canvas), d[:, :4],
                                       (h0, w0), ratio_pad=rp)
            x1, y1, x2, y2, conf, cls = d.T.astype(np.float64)
            out[stem] = np.stack([cls, (x1 + x2) / 2 / w0, (y1 + y2) / 2 / h0,
                                  (x2 - x1) / w0, (y2 - y1) / h0, conf], 1)
    return out


def check_txts(out_dir: Path, want: dict) -> int:
    """detect's txt of each stem against the engine's rows: the same count
    and classes, every number within 1e-4 (the txt prints six significant
    digits). Returns the rows compared."""
    n = 0
    for stem, rows in want.items():
        txt = out_dir / f"{stem}.txt"
        got = np.loadtxt(txt, ndmin=2) if txt.exists() else np.zeros((0, 6))
        assert got.shape == rows.shape, (stem, got.shape, rows.shape)
        assert np.array_equal(got[:, 0], rows[:, 0]), stem
        err = float(np.abs(got[:, 1:] - rows[:, 1:]).max()) if len(got) else 0
        assert err <= 1e-4, (stem, err)
        n += len(rows)
    return n


def txt_map50(out_dir: Path, files1) -> float:
    """mAP@50 of detect's txts against the extval labels, scored with the
    port's matching and eval/metrics.py."""
    from icafusion_tpu_torch.eval.evaluator import IOUV, match_predictions
    from icafusion_tpu_torch.eval.metrics import summarize

    def xyxy(r, h, w):
        cx, cy, bw, bh = r[:, 0] * w, r[:, 1] * h, r[:, 2] * w, r[:, 3] * h
        return np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                        1)

    stats = []
    for f in files1:
        stem = Path(f).stem
        h, w = read_rgb(f).shape[:2]
        lab = np.loadtxt(S640 / "extval" / "labels" / "val" / f"{stem}.txt",
                         ndmin=2)
        txt = out_dir / f"{stem}.txt"
        rows = np.loadtxt(txt, ndmin=2) if txt.exists() else np.zeros((0, 6))
        pred = np.concatenate([xyxy(rows[:, 1:5], h, w), rows[:, 5:6],
                               rows[:, :1]], 1)
        correct = (match_predictions(pred, xyxy(lab[:, 1:5], h, w), lab[:, 0])
                   if len(pred) else np.zeros((0, len(IOUV)), bool))
        stats.append((correct, pred[:, 4], pred[:, 5], lab[:, 0]))
    return summarize(stats, 3)["map50"]


def check_match(tag, got, want, gate):
    """The share of all detections of got with a partner in want (matched,
    pair by pair), and of want in got; both at least gate."""
    def share(a, b):
        n = sum(len(x) for x in a)
        return sum(matched(x, y) * len(x) for x, y in zip(a, b)) / max(n, 1)

    fwd, back = share(got, want), share(want, got)
    worst = min(min(matched(g, w), matched(w, g)) for g, w in zip(got, want))
    print(f"   {tag}: share of detections matched (same class, IoU > 0.5 "
          f"or within 1 px): "
          f"{fwd:.4f} of {sum(map(len, got))}, back {back:.4f} of "
          f"{sum(map(len, want))} (gate >= {gate}); the worst pair "
          f"{worst:.4f}")
    assert min(fwd, back) >= gate, (tag, fwd, back)


def serve_slice(work: Path, model_l) -> dict:
    """Phase 8: the serving entry points on the card. (a) cli.detect on the
    trained s640 checkpoint over the 141 extval pairs, square and --rect;
    (b) ServingEngine.predict_paths, pipelined and not; (c) the
    MicroBatcher over the flagship at 640 in bf16 (model_l: random weights
    from seed 0); (d) the HTTP server with a MicroBatcher over s640; (f)
    cli.detect on videos. Returns the launches of the three kernels summed
    over (a)-(d)."""
    from icafusion_tpu_torch.cli import detect as cli_detect
    from icafusion_tpu_torch.cli._common import load_model_for_inference
    from icafusion_tpu_torch.data.decode import decode_letterbox_batch
    from icafusion_tpu_torch.serve.engine import ServingEngine

    files1, files2 = extval_files()
    n_pairs = len(files1)
    total = {"dual_cross_attention": 0, "greedy_nms": 0, "conv3x3_bn_silu": 0}

    def add(launches, batches, convs):
        want = {"dual_cross_attention": 3 * batches, "greedy_nms": batches,
                "conv3x3_bn_silu": convs * batches}
        assert launches == want, (launches, want)
        for k, v in launches.items():
            total[k] += v

    _, s640 = load_model_for_inference(S640_CFG, str(S640 / "stripped.ckpt"),
                                       nc=3)
    batches = -(-n_pairs // VAL_BATCH)
    base = ["--weights", str(S640 / "stripped.ckpt"), "--cfg", S640_CFG,
            "--source1", str(S640 / "extval" / "visible" / "val"),
            "--source2", str(S640 / "extval" / "infrared" / "val"),
            "--img-size", "640", "--batch-size", str(VAL_BATCH),
            "--conf-thres", "0.001", "--iou-thres", "0.5", "--save-txt",
            "--save-conf", "--nosave"]
    kw = dict(batch_size=VAL_BATCH, conf_thres=0.001, iou_thres=0.5,
              dtype="float32")
    rect_engine = ServingEngine(s640, RECT, **kw)
    for tag, extra, engine, auto in (
            ("square 640", [], ServingEngine(s640, 640, **kw), False),
            ("--rect", ["--rect"], rect_engine, True)):
        t0 = phase(f"8a cli.detect s640 fp32 {tag}, {n_pairs} extval pairs, "
                   f"batch {VAL_BATCH}")
        out = work / f"8a{len(extra)}"
        said = io.StringIO()      # a line an image: kept out of the report
        t = time.perf_counter()
        with contextlib.redirect_stdout(said):
            _, launches = counted(lambda: cli_detect.main(
                base + extra + ["--save-dir", str(out)]))
        wall = time.perf_counter() - t
        print(f"   cli.detect: {said.getvalue().splitlines()[-2]}")
        add(launches, batches, 5)
        rows = check_txts(out, engine_rows(engine, files1, files2,
                                           640 if auto else engine.canvas,
                                           auto))
        print(f"   {wall:.1f} s for {n_pairs} pairs; launches {launches}; "
              f"{rows} txt rows equal predict_arrays' (classes exact, "
              f"numbers within 1e-4); mAP@50 of the txts "
              f"{txt_map50(out, files1):.5f} (best-class NMS at top_k 1024: "
              f"not gated)")
        done(t0)

    t0 = phase(f"8b predict_paths s640 fp32 on {RECT}, batch {VAL_BATCH}")
    t = time.perf_counter()
    piped, launches = counted(lambda: rect_engine.predict_paths(files1,
                                                                files2))
    t_piped = time.perf_counter() - t
    add(launches, batches, 5)
    t = time.perf_counter()
    serial = rect_engine.predict_paths(files1, files2, pipeline=False)
    t_serial = time.perf_counter() - t
    rgb, ir, _, _, hw = decode_letterbox_batch(files1, files2, RECT,
                                               scaleup=True)
    direct = []
    for s in range(0, n_pairs, VAL_BATCH):
        part = slice(s, s + VAL_BATCH)
        direct += rect_engine.predict_arrays(rgb[part], ir[part],
                                             orig_hw=hw[part].tolist())
    assert len(piped) == len(serial) == len(direct) == n_pairs
    for a, b, c in zip(piped, serial, direct):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    print(f"   pipelined {t_piped:.2f} s, serial {t_serial:.2f} s (host "
          f"clock, {n_pairs} pairs); equal to each other and to "
          f"predict_arrays on decode_letterbox_batch ({sum(map(len, piped))} "
          f"detections); launches {launches}")
    done(t0)

    t0 = phase("8c MicroBatcher: yolov5l-Transfusion 640, bf16, batch_size "
               f"32, {SERVE_PAIRS} pairs from {SERVE_THREADS} threads")
    served = microbatcher_slice(model_l, files1, files2, add)
    done(t0)

    t0 = phase(f"8d HTTP server: s640 on {RECT}, bf16, MicroBatcher, "
               f"{HTTP_THREADS} client threads")
    http_slice(s640, files1, files2, add)
    done(t0)

    t0 = phase(f"8f cli.detect on a pair of {VIDEO_FRAMES}-frame MJPG videos, "
               "s640 fp32")
    video_slice(work, s640, files1, files2, add)
    done(t0)
    return total


def video_slice(work: Path, s640, files1, files2, add):
    """8f: the video branch of cli.detect over two MJPG .avi files written
    from extval pairs: each frame's detections (recorded where detect draws
    them) equal predict_arrays' on the frames cv2 reads back."""
    import cv2

    from icafusion_tpu_torch.cli import detect as cli_detect
    from icafusion_tpu_torch.data.augment import letterbox
    from icafusion_tpu_torch.serve.engine import ServingEngine

    paths, frames = [], []
    for files, name in ((files1, "rgb.avi"), (files2, "ir.avi")):
        p = work / name
        w = cv2.VideoWriter(str(p), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                            (640, 512))
        assert w.isOpened(), "cv2 cannot write MJPG"
        for f in files[:VIDEO_FRAMES]:
            w.write(cv2.imread(f))
        w.release()
        cap, got = cv2.VideoCapture(str(p)), []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            got.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
        cap.release()
        assert len(got) == VIDEO_FRAMES, (name, len(got))
        paths.append(str(p))
        frames.append(got)
    seen = []
    draw = cli_detect._annotate_bgr

    def record(im0, pred, names, args):
        seen.append(pred.copy())
        return draw(im0, pred, names, args)

    cli_detect._annotate_bgr = record
    try:
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            n, launches = counted(lambda: cli_detect.main([
                "--weights", str(S640 / "stripped.ckpt"), "--cfg", S640_CFG,
                "--source1", paths[0], "--source2", paths[1], "--img-size",
                "640", "--conf-thres", "0.001", "--iou-thres", "0.5",
                "--nosave", "--save-dir", str(work / "8f")]))
    finally:
        cli_detect._annotate_bgr = draw
    assert n == len(seen) == VIDEO_FRAMES, (n, len(seen))
    add(launches, n, 5)
    engine = ServingEngine(s640, 640, 1, conf_thres=0.001, iou_thres=0.5,
                           dtype="float32")
    rows = 0
    for pred, a, b in zip(seen, *frames):
        want = engine.predict_arrays(letterbox(a, 640)[0][None],
                                     letterbox(b, 640)[0][None],
                                     orig_hw=[a.shape[:2]])[0]
        assert pred.shape == want.shape, (pred.shape, want.shape)
        assert np.array_equal(pred[:, 5], want[:, 5])
        assert not len(pred) or np.abs(pred[:, :5] - want[:, :5]).max() <= 1e-4
        rows += len(pred)
    print(f"   cli.detect: {said.getvalue().splitlines()[-1]}; {n} frames, "
          f"launches {launches}; {rows} detections equal predict_arrays' on "
          f"the frames read back (classes exact, numbers within 1e-4)")


def microbatcher_slice(model_l, files1, files2, add):
    """8c: warm every bucket, then SERVE_PAIRS letterboxed extval pairs
    submitted from SERVE_THREADS threads; each result against a serial
    predict_arrays of its pair at batch 1."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from icafusion_tpu_torch.data.augment import letterbox
    from icafusion_tpu_torch.serve.batcher import MicroBatcher
    from icafusion_tpu_torch.serve.engine import ServingEngine

    pairs = [(letterbox(read_rgb(a), 640)[0], letterbox(read_rgb(b), 640)[0])
             for a, b in zip(files1[:SERVE_PAIRS], files2[:SERVE_PAIRS])]
    engine = ServingEngine(model_l, 640, 32, conf_thres=0.001)
    with MicroBatcher(engine) as mb:
        t = time.perf_counter()
        mb.warmup()
        print(f"   warm-up of buckets {mb.buckets}: "
              f"{time.perf_counter() - t:.1f} s")
        barrier = threading.Barrier(SERVE_THREADS)

        def client(j):
            barrier.wait(timeout=120)
            return [(i, mb.submit(*pairs[i]))
                    for i in range(j, SERVE_PAIRS, SERVE_THREADS)]

        def run():
            with ThreadPoolExecutor(SERVE_THREADS) as ex:
                return [r for rs in ex.map(client, range(SERVE_THREADS))
                        for r in rs]

        t = time.perf_counter()
        results, launches = counted(run)
        wall = time.perf_counter() - t
        stats = mb.stats()
        assert stats["requests"] == SERVE_PAIRS, stats
        add(launches, stats["batches"], CONVS_PER_FORWARD)
        print(f"   {SERVE_PAIRS} requests in {wall:.2f} s -> "
              f"{SERVE_PAIRS / wall:.1f} pairs/s; stats {stats}; launches "
              f"{launches}")
        lat = []
        for i in range(10):
            t = time.perf_counter()
            mb.submit(*pairs[i % len(pairs)])
            lat.append(1e3 * (time.perf_counter() - t))
        big = [np.stack([p[k] for p in pairs[:32]]) for k in (0, 1)]
        per32 = []
        for _ in range(5):
            t = time.perf_counter()
            engine._finalize(*engine._dispatch(*big, batch=32))
            per32.append(1e3 * (time.perf_counter() - t) / 32)
        print(f"   host clock: a lone request (bucket 1) median "
              f"{np.median(lat):.2f} ms over 10; bucket 32 "
              f"{np.median(per32):.3f} ms a pair (median of 5)")
    one = ServingEngine(model_l, 640, 1, conf_thres=0.001)
    serial = [one.predict_arrays(a[None], b[None])[0] for a, b in pairs]
    got = [r for _, r in sorted(results, key=lambda x: x[0])]
    print(f"   detections a pair: batcher {np.mean([len(g) for g in got]):.1f}"
          f", serial {np.mean([len(w) for w in serial]):.1f}")
    check_match("batcher vs serial batch 1", got, serial,
                MATCH_SHARE["batcher"])
    # decoded predictions of 4 pairs at bucket 1 and at bucket 32
    x = [np.stack([p[k] for p in pairs[:32]]) for k in (0, 1)]
    fp32 = ServingEngine(model_l, 640, 32, dtype="float32")
    rtol, atol, score_tol = FP32_BUCKET_TOL
    for eng in (engine, fp32):
        with torch.inference_mode():
            rgb, ir = ((torch.from_numpy(a).to(eng.device).permute(0, 3, 1, 2)
                        .float() / 255.0).to(eng.dtype) for a in x)
            big = eng.model(rgb, ir)[:4].float()
            alone = torch.cat([eng.model(rgb[i:i + 1], ir[i:i + 1])
                               for i in range(4)]).float()
        d = (alone - big).abs()
        print(f"   {str(eng.dtype)[6:]} decoded predictions, bucket 1 vs "
              f"bucket 32 (4 pairs): max |box| {d[..., :4].max():.4g} px, "
              f"max |obj| {d[..., 4].max():.4g}, max |cls| "
              f"{d[..., 5:].max():.4g}, 99th percentile |obj| "
              f"{torch.quantile(d[..., 4].flatten(), 0.99):.4g}")
    torch.testing.assert_close(alone[..., :4], big[..., :4], rtol=rtol,
                               atol=atol)
    assert d[..., 4:].max() <= score_tol, float(d[..., 4:].max())


def http_slice(s640, files1, files2, add):
    """8d: the HTTP server with a MicroBatcher over s640 on the 512 x 640
    canvas in bf16, on 127.0.0.1 in a thread; HTTP_THREADS clients POST
    the extval pairs as base64 JPEGs."""
    import base64
    import http.client
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from icafusion_tpu_torch.data.augment import letterbox
    from icafusion_tpu_torch.serve import http_server
    from icafusion_tpu_torch.serve.batcher import MicroBatcher
    from icafusion_tpu_torch.serve.engine import ServingEngine

    def request(port, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request(method, path, body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, data

    engine = ServingEngine(s640, RECT, 32)
    with MicroBatcher(engine) as mb:
        mb.warmup()
        srv = http_server.make_server(engine, mb, ["red", "green", "blue"],
                                      host="127.0.0.1", port=0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        port = srv.server_address[1]
        bodies = [json.dumps({"rgb": base64.b64encode(Path(a).read_bytes())
                              .decode(), "ir": base64.b64encode(
                                  Path(b).read_bytes()).decode()})
                  for a, b in zip(files1, files2)]
        try:
            t = time.perf_counter()
            with ThreadPoolExecutor(HTTP_THREADS) as ex:
                replies, launches = counted(lambda: list(ex.map(
                    lambda body: request(port, "POST", "/v1/detect", body),
                    bodies)))
            wall = time.perf_counter() - t
            status, data = request(port, "GET", "/v1/stats")
            stats = json.loads(data)
            bad = request(port, "POST", "/v1/detect", '{"rgb": "nope!!"}')
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)
    assert status == 200 and stats["requests"] == len(files1), stats
    assert bad[0] == 400 and "error" in json.loads(bad[1]), bad
    add(launches, stats["batches"], 5)
    got = []
    for code, data in replies:
        assert code == 200, (code, data[:200])
        got.append(np.array([[r[k] for k in ("xmin", "ymin", "xmax", "ymax",
                                             "confidence", "class")]
                             for r in json.loads(data)],
                            np.float32).reshape(-1, 6))
    want = []
    for s in range(0, len(files1), engine.batch_size):
        imgs = [(read_rgb(a), read_rgb(b)) for a, b in
                zip(files1[s:s + engine.batch_size],
                    files2[s:s + engine.batch_size])]
        lb = [np.stack([letterbox(p[k], RECT)[0] for p in imgs])
              for k in (0, 1)]
        want += engine.predict_arrays(*lb, orig_hw=[p[0].shape[:2]
                                                    for p in imgs])
    print(f"   {len(files1)} POSTs in {wall:.2f} s -> "
          f"{len(files1) / wall:.1f} pairs/s; stats {stats}; launches "
          f"{launches}; malformed body -> {bad[0]}; detections a pair "
          f"{np.mean([len(g) for g in got]):.2f}")
    check_match("HTTP vs predict_arrays", got, want, MATCH_SHARE["http"])



L640 = REPO / "artifacts" / "trained_l640"
L640_CFG = "yolov5l_Transfusion.yaml"


def l640_slice(work: Path):
    """chip_smoke.py --trained-l640: the trained flagship
    (artifacts/trained_l640, yolov5l-Transfusion at 640) over the 141
    extval pairs: (a) cli.detect fp32, every txt row equal to
    predict_arrays'; (b) cli.val fp32, mAP@50 within 0.3 points of
    TRAINED_PARITY_L640.json's JAX and reference-stack records; (d)
    cli.val --int8 fp32, within 0.3 points of the JAX int8 record; (c)
    the Evaluator in bf16 beside the JAX bf16 record (not gated). The
    checkpoint and extval do not fit one chip copy beside the whole tree,
    so this runs apart from the default phases, in a copy without docs/,
    trained_n320 and trained_s640/stripped.ckpt."""
    from icafusion_tpu_torch.cli import detect as cli_detect
    from icafusion_tpu_torch.cli import val as cli_val
    from icafusion_tpu_torch.cli._common import load_model_for_inference
    from icafusion_tpu_torch.data.datasets import PairedDetectionDataset
    from icafusion_tpu_torch.data.loader import PairedLoader
    from icafusion_tpu_torch.eval.evaluator import Evaluator
    from icafusion_tpu_torch.serve.engine import ServingEngine

    rec = json.loads((REPO / "TRAINED_PARITY_L640.json").read_text())
    jax_rec = {k: rec["ours"][k]["ref_scored"]["map50"]
               for k in ("fp32", "bf16")}
    ext = S640 / "extval"
    files1, files2 = extval_files()
    batches = -(-len(files1) // VAL_BATCH)
    want = {"dual_cross_attention": 3 * batches, "greedy_nms": batches,
            "conv3x3_bn_silu": CONVS_PER_FORWARD * batches}
    _, l640 = load_model_for_inference(L640_CFG, str(L640 / "stripped.ckpt"),
                                       nc=3)

    t0 = phase(f"9a cli.detect trained l640 fp32, {len(files1)} extval "
               f"pairs, batch {VAL_BATCH}")
    out = work / "9a"
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        _, launches = counted(lambda: cli_detect.main([
            "--weights", str(L640 / "stripped.ckpt"), "--cfg", L640_CFG,
            "--source1", str(ext / "visible" / "val"),
            "--source2", str(ext / "infrared" / "val"), "--img-size", "640",
            "--batch-size", str(VAL_BATCH), "--conf-thres", "0.001",
            "--iou-thres", "0.5", "--save-txt", "--save-conf", "--nosave",
            "--save-dir", str(out)]))
    assert launches == want, (launches, want)
    engine = ServingEngine(l640, 640, VAL_BATCH, conf_thres=0.001,
                           iou_thres=0.5, dtype="float32")
    rows = check_txts(out, engine_rows(engine, files1, files2, (640, 640),
                                       False))
    del engine
    print(f"   cli.detect: {said.getvalue().splitlines()[-2]}; launches "
          f"{launches}; {rows} txt rows equal predict_arrays' (classes "
          f"exact, numbers within 1e-4); mAP@50 of the txts "
          f"{txt_map50(out, files1):.5f} (best-class NMS at top_k 1024: not "
          f"gated)")
    done(t0)

    t0 = phase("9b cli.val trained l640 fp32")
    data = work / "extval.yaml"
    data.write_text(f"path: {ext}\nval_rgb: visible/val\n"
                    "val_ir: infrared/val\nnc: 3\n"
                    "names: ['red', 'green', 'blue']\n")
    r, launches = counted(lambda: cli_val.main([
        "--weights", str(L640 / "stripped.ckpt"), "--cfg", L640_CFG,
        "--data", str(data), "--img-size", "640", "--batch-size",
        str(VAL_BATCH), "--save-dir", str(work / "9b")]))
    ref = rec["torch"]["map50"]
    print(f"   fp32: mAP@50 {r['map50']:.5f} mAP {r['map']:.5f} over "
          f"{r['seen']} pairs; JAX fp32 record {jax_rec['fp32']:.5f} (delta "
          f"{100 * (r['map50'] - jax_rec['fp32']):+.3f} pts), reference stack "
          f"{ref:.5f} (delta {100 * (r['map50'] - ref):+.3f} pts); "
          f"{r['t_total_ms']:.2f} ms per image; launches {launches}")
    assert r["seen"] == len(files1) and launches == want, launches
    assert abs(r["map50"] - jax_rec["fp32"]) <= MAP50_GATE, r["map50"]
    assert abs(r["map50"] - ref) <= MAP50_GATE, r["map50"]
    done(t0)

    t0 = phase("9d cli.val --int8 trained l640 fp32")
    link = work / "l640.ckpt"       # <weights>.calib is written beside it
    link.symlink_to(L640 / "stripped.ckpt")
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        r, launches = counted(lambda: cli_val.main([
            "--weights", str(link), "--cfg", L640_CFG, "--data", str(data),
            "--img-size", "640", "--batch-size", str(VAL_BATCH), "--int8",
            "--save-dir", str(work / "9d")]), int8=True)
    rec_int8 = int8_record("l640")
    print(f"   int8 fp32: mAP@50 {r['map50']:.5f} mAP {r['map']:.5f}; JAX "
          f"int8 record {rec_int8:.5f} (delta "
          f"{100 * (r['map50'] - rec_int8):+.3f} pts); {r['t_total_ms']:.2f} "
          f"ms per image; launches {launches}")
    assert launches["conv_int8_bn_act"] == INT8_CONVS_L * batches, launches
    assert abs(r["map50"] - rec_int8) <= MAP50_GATE, r["map50"]
    done(t0)

    t0 = phase("9c Evaluator trained l640 bf16 (not gated)")
    ds = PairedDetectionDataset(str(ext / "visible" / "val"),
                                str(ext / "infrared" / "val"), 640, nc=3)
    r = Evaluator(l640, nc=3, dtype="bfloat16").run(
        PairedLoader(ds, VAL_BATCH).val_batches(), 640)
    print(f"   bf16: mAP@50 {r['map50']:.5f} mAP {r['map']:.5f}; JAX bf16 "
          f"record {jax_rec['bf16']:.5f} (delta "
          f"{100 * (r['map50'] - jax_rec['bf16']):+.3f} pts); "
          f"{r['t_total_ms']:.2f} ms per image")
    done(t0)
