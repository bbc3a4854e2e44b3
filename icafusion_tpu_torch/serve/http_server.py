"""HTTP detection service: the JAX package's serve/http_server.py
(reference utils/flask_rest_api/restapi.py:16-37), standard library only,
two-stream, with concurrent requests coalesced by the MicroBatcher
(serve/batcher.py).

POST /v1/detect with a JSON body {"rgb": <base64 jpeg>, "ir": <base64 jpeg>}
returns the detections as records [{"xmin", "ymin", "xmax", "ymax",
"confidence", "class", "name"}] in the native image's pixels (the
reference's Detections.pandas() fields); a body that does not parse or
decode gets 400 with {"error": ...}. GET /v1/stats reports how requests
coalesced (requests, batches, bucket_counts). Any other path is 404.

    python -m icafusion_tpu_torch.serve.http_server --weights best.ckpt \\
        --cfg zoo:tfb:s --img-size 512x640 [--device cpu]

Without a batcher (make_server(engine)), each request thread decodes its
pair and serves it through ServingEngine.predict_paths.
"""

from __future__ import annotations

import argparse
import base64
import json
import tempfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from icafusion_tpu_torch.ops.nms import records


def decode_letterboxed(jpeg_bytes: bytes, canvas):
    """JPEG bytes -> (letterboxed (H, W, 3) uint8 RGB, native (h0, w0)).
    Runs in the request thread, so decoding overlaps the device's batches."""
    import cv2
    import numpy as np

    from icafusion_tpu_torch.data.augment import letterbox
    img = cv2.imdecode(np.frombuffer(jpeg_bytes, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("undecodable image")
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return letterbox(img, canvas, auto=False, scaleup=True)[0], img.shape[:2]


class Handler(BaseHTTPRequestHandler):
    """Serves the engine, batcher and names of its server (make_server)."""

    def log_message(self, fmt, *args):
        pass

    def _reply(self, code: int, doc=None):
        self.send_response(code)
        if doc is None:
            self.end_headers()
            return
        payload = json.dumps(doc).encode()
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):
        if self.path != "/v1/stats" or self.server.batcher is None:
            return self._reply(404)
        self._reply(200, self.server.batcher.stats())

    def do_POST(self):
        if self.path != "/v1/detect":
            return self._reply(404)
        srv = self.server
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length))
            rgb_b = base64.b64decode(body["rgb"])
            ir_b = base64.b64decode(body.get("ir", body["rgb"]))
            if srv.batcher is not None:
                canvas = srv.batcher.engine.canvas
                rgb, hw0 = decode_letterboxed(rgb_b, canvas)
                ir, _ = decode_letterboxed(ir_b, canvas)
                dets = srv.batcher.submit(rgb, ir, orig_hw=hw0)
            else:
                with tempfile.NamedTemporaryFile(suffix=".jpg") as f1, \
                        tempfile.NamedTemporaryFile(suffix=".jpg") as f2:
                    f1.write(rgb_b)
                    f2.write(ir_b)
                    f1.flush()
                    f2.flush()
                    dets = srv.engine.predict_paths([f1.name], [f2.name])[0]
        except Exception as e:  # noqa: BLE001 - the client's request failed
            return self._reply(400, {"error": str(e)})
        self._reply(200, records(dets, srv.names))


class Server(ThreadingHTTPServer):
    # The standard library's backlog of 5 overflows under a burst of
    # concurrent clients into connection resets; size it for real load.
    request_queue_size = 128
    daemon_threads = True


def make_server(engine, batcher=None, names=None, host: str = "0.0.0.0",
                port: int = 5000) -> Server:
    """A threading HTTP server over ``engine``, in front of ``batcher``
    where one is given; port 0 picks a free port (server_address[1])."""
    srv = Server((host, port), Handler)
    srv.engine, srv.batcher, srv.names = engine, batcher, names
    return srv


def parse_args(argv=None):
    ap = argparse.ArgumentParser("icafusion-torch-serve")
    ap.add_argument("--weights", required=True)
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--img-size", default="640", metavar="S|HxW",
                    help="square size or HxW rect canvas (512x640: the "
                         "KAIST-native geometry)")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--batch-size", type=int, default=32,
                    help="largest micro-batch bucket")
    ap.add_argument("--max-wait-ms", type=float, default=0.0,
                    help="hold the first request of a batch up to this long "
                         "for peers to coalesce (0: dispatch at once)")
    ap.add_argument("--names", nargs="*", default=None)
    ap.add_argument("--int8", action="store_true",
                    help="W8A8 serving (not ported)")
    ap.add_argument("--merge", default="auto", metavar="K",
                    help="stream merging: 0 or auto only (the port runs the "
                         "streams apart)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, raising without one)")
    args = ap.parse_args(argv)
    hw = [int(v) for v in str(args.img_size).split("x")]
    args.img_size = hw[0] if len(hw) == 1 else tuple(hw)
    return args


def build(args):
    """(engine, batcher) of parsed arguments, every bucket warmed up."""
    from icafusion_tpu_torch.cli._common import load_model_for_inference
    from icafusion_tpu_torch.serve.batcher import MicroBatcher
    from icafusion_tpu_torch.serve.engine import ServingEngine
    from icafusion_tpu_torch.utils.general import not_ported

    if args.int8:
        not_ported("--int8 (W8A8 serving)", "A9")
    merge = 0 if str(args.merge) == "auto" else args.merge
    _, model = load_model_for_inference(args.cfg, args.weights, merge=merge)
    engine = ServingEngine(model, img_size=args.img_size,
                           batch_size=args.batch_size, device=args.device)
    batcher = MicroBatcher(engine, max_wait_ms=args.max_wait_ms)
    print(f"warming up buckets {batcher.buckets} ...")
    batcher.warmup()
    return engine, batcher


def main(argv=None):
    args = parse_args(argv)
    engine, batcher = build(args)
    srv = make_server(engine, batcher, args.names, port=args.port)
    print(f"serving on :{args.port} (POST /v1/detect, GET /v1/stats; "
          f"micro-batching buckets {batcher.buckets})")
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
        batcher.close()


if __name__ == "__main__":
    main()
