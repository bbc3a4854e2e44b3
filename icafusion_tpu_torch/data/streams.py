"""Streaming inference sources: paired video files, cameras and network
streams, letterboxed as pairs.

Counterpart of the JAX package's data/streams.py (reference
utils/datasets.py LoadImages' video branch :172-249, LoadWebcam :252-307,
LoadStreams :310-388). cv2 is imported when a source opens.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from icafusion_tpu_torch.data.augment import letterbox


def _capture(source):
    import cv2
    return cv2.VideoCapture(int(source) if str(source).isnumeric()
                            else source)


def _rgb(frame_bgr):
    import cv2
    return cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)


class LoadPairedVideos:
    """Two video files (or camera indices) in lockstep: yields (letterboxed
    RGB, letterboxed IR, RGB frame, IR frame), frames in RGB order."""

    def __init__(self, source1, source2, img_size: int = 640,
                 stride: int = 32):
        self.caps = [_capture(s) for s in (source1, source2)]
        if not all(c.isOpened() for c in self.caps):
            self.release()
            raise OSError(f"failed to open {source1} / {source2}")
        self.img_size = img_size

    def __iter__(self):
        return self

    def __next__(self):
        frames = []
        for c in self.caps:
            ok, f = c.read()
            if not ok:
                raise StopIteration
            frames.append(_rgb(f))
        lbs = [letterbox(f, self.img_size, scaleup=True)[0] for f in frames]
        return lbs[0], lbs[1], frames[0], frames[1]

    def release(self):
        for c in self.caps:
            c.release()


class LoadPairedStreams:
    """Threaded readers of paired streams (RTSP, cameras) with latest-frame
    semantics (LoadStreams, datasets.py:310-388).

    fps > 0 paces each reader (a sleep of 1/fps between grabs): cameras pace
    themselves, a file replayed as a stream does not. seq[i] counts the
    frames stream i has read, so a consumer can tell a new frame from the
    last one kept after the stream ended."""

    def __init__(self, sources1: List, sources2: List, img_size: int = 640,
                 fps: float = 0.0):
        if len(sources1) != len(sources2):
            raise ValueError("paired stream lists differ in length")
        self.img_size = img_size
        self.frame_interval = 1.0 / fps if fps > 0 else 0.0
        self.frames: List[Optional[Tuple[np.ndarray, np.ndarray]]] = \
            [None] * len(sources1)
        self.seq: List[int] = [0] * len(sources1)
        self.caps = []
        self.threads = []
        self.running = True
        for i, (s1, s2) in enumerate(zip(sources1, sources2)):
            c1, c2 = _capture(s1), _capture(s2)
            self.caps.append((c1, c2))
            if not (c1.isOpened() and c2.isOpened()):
                self.close()
                raise OSError(f"failed to open stream {i}: {s1} / {s2}")
            t = threading.Thread(target=self._reader, args=(i,), daemon=True)
            t.start()
            self.threads.append(t)

    def _reader(self, i):
        c1, c2 = self.caps[i]
        while self.running:
            ok1, f1 = c1.read()
            ok2, f2 = c2.read()
            if ok1 and ok2:
                self.frames[i] = (_rgb(f1), _rgb(f2))
                self.seq[i] += 1
                if self.frame_interval:
                    time.sleep(self.frame_interval)
            else:
                time.sleep(0.01)

    def read(self):
        """The latest letterboxed frame pair of every stream, as (RGB, IR,
        RGB frame, IR frame), or None before its first frame."""
        out = []
        for fr in self.frames:
            if fr is None:
                out.append(None)
                continue
            r = letterbox(fr[0], self.img_size, scaleup=True)[0]
            i = letterbox(fr[1], self.img_size, scaleup=True)[0]
            out.append((r, i, fr[0], fr[1]))
        return out

    def close(self):
        self.running = False
        for t in self.threads:
            t.join(timeout=5)
        for c1, c2 in self.caps:
            c1.release()
            c2.release()
