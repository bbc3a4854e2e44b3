"""Dynamic micro-batching in front of a ServingEngine: concurrent
single-pair requests coalesce into bucketed device batches.

Counterpart of the JAX package's serve/batcher.py. Request threads
``submit()`` one letterboxed pair each and block; one dispatcher thread,
which alone launches work on the card, drains the queue and runs the
smallest power-of-two bucket that holds the pending requests. An idle
server dispatches bucket 1 at once; under load the queue fills while the
card runs batch i, and batch i+1 goes out at a larger bucket.
``max_wait_ms > 0`` holds the first request of a batch to let peers arrive.

Results equal serial ``engine.predict_arrays`` calls up to the numerics of
another batch size: images are independent through the serve step
(eval-mode BatchNorm, per-image decode and NMS), and padding rows are zero
images whose outputs are dropped. A bucket is split over the engine's
replicas, so each must be a multiple of their number, as the JAX package's
buckets divide its device mesh.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional, Sequence

import numpy as np


class _Request:
    __slots__ = ("rgb", "ir", "hw", "event", "result", "error")

    def __init__(self, rgb, ir, hw):
        self.rgb, self.ir, self.hw = rgb, ir, hw
        self.event = threading.Event()
        self.result = None
        self.error = None


def default_buckets(engine) -> List[int]:
    """Powers of two up to the engine batch that are multiples of its mesh
    size, and the engine batch itself."""
    mesh_n = engine.mesh.size
    out, b = [], 1
    while b <= engine.batch_size:
        if b % mesh_n == 0:
            out.append(b)
        b *= 2
    if engine.batch_size not in out:
        out.append(engine.batch_size)
    return sorted(out)


class MicroBatcher:
    """Thread-safe coalescing front end over one ServingEngine.

    submit() is called from any number of request threads; one dispatcher
    thread owns the device. stats() reports how requests coalesced."""

    def __init__(self, engine, buckets: Optional[Sequence[int]] = None,
                 max_wait_ms: float = 0.0, queue_cap: int = 1024):
        self.engine = engine
        self.buckets = (sorted(set(buckets)) if buckets
                        else default_buckets(engine))
        mesh_n = engine.mesh.size
        bad = [b for b in self.buckets
               if b < 1 or b % mesh_n != 0 or b > engine.batch_size]
        if bad:
            raise ValueError(
                f"buckets {bad} invalid: must be multiples of the engine mesh "
                f"size ({mesh_n}) and <= engine.batch_size "
                f"({engine.batch_size})")
        self.max_wait_s = max_wait_ms / 1000.0
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue(queue_cap)
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "bucket_counts": {}}
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="icafusion-microbatcher")
        self._thread.start()

    # ---- client side ------------------------------------------------------

    def submit(self, rgb: np.ndarray, ir: np.ndarray,
               orig_hw=None) -> np.ndarray:
        """One letterboxed (H, W, 3) uint8 pair on the engine canvas ->
        (k, 6) [x1, y1, x2, y2, conf, cls] detections (native coordinates
        where orig_hw is the source (h0, w0)). Blocks until its batch is
        back; an error of the batch is raised in every waiter."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        req = _Request(np.asarray(rgb), np.asarray(ir), orig_hw)
        self._q.put(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def stats(self) -> dict:
        with self._lock:
            return {"requests": self._stats["requests"],
                    "batches": self._stats["batches"],
                    "bucket_counts": dict(self._stats["bucket_counts"])}

    def close(self):
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._thread.join(timeout=30)

    # ---- dispatcher side --------------------------------------------------

    def _collect(self) -> Optional[List[_Request]]:
        """Block for the first request, then take whatever is queued and,
        with max_wait_ms, wait for more until the largest bucket fills or
        the deadline passes."""
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        cap = self.buckets[-1]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < cap:
            timeout = deadline - time.monotonic()
            try:
                nxt = (self._q.get(timeout=timeout) if timeout > 0
                       else self._q.get_nowait())
            except queue.Empty:
                break
            if nxt is None:          # close(): finish this batch, then
                self._q.put(None)    # let the loop see the sentinel
                break
            batch.append(nxt)
        return batch

    def _run(self):
        engine = self.engine
        while True:
            batch = self._collect()
            if batch is None:
                return
            n = len(batch)
            bucket = next(b for b in self.buckets if b >= n)
            try:
                rgb = np.stack([r.rgb for r in batch])
                ir = np.stack([r.ir for r in batch])
                dets, _ = engine._dispatch(rgb, ir, batch=bucket)
                hw = [r.hw for r in batch]
                outs = engine._finalize(
                    dets, n, hw if any(h is not None for h in hw) else None)
                with self._lock:
                    self._stats["requests"] += n
                    self._stats["batches"] += 1
                    bc = self._stats["bucket_counts"]
                    bc[bucket] = bc.get(bucket, 0) + 1
                for req, out in zip(batch, outs):
                    req.result = out
                    req.event.set()
            except Exception as e:  # noqa: BLE001 - delivered to every waiter
                for req in batch:
                    req.error = e
                    req.event.set()

    def warmup(self):
        """Run every bucket once before live traffic, from the calling
        thread: the first call of a shape builds the kernels and picks the
        convolution algorithms."""
        (H, W) = self.engine.canvas
        for b in self.buckets:
            z = np.zeros((b, H, W, 3), np.uint8)
            self.engine._finalize(*self.engine._dispatch(z, z, batch=b))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
