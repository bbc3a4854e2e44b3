"""Fixed-shape batches of a PairedDetectionDataset (the JAX package's
data/loader.py, cv2 decoding only): train batches, val batches on the
img_size square, and rect val batches grouped by canvas.

Train batches: images (B, S, S, 3) uint8 and targets padded to (B, T, 5)
with a (B, T) mask, so no shape depends on the data. A thread pool decodes
and augments (cv2 releases the GIL) and a producer thread keeps a few
batches ahead. Each epoch shuffles with a generator seeded by (seed +
epoch); each sample augments with its own generator keyed on (seed, epoch,
dataset index), so a batch is the same bytes whatever the number of
workers, and the same bytes as the JAX package's loader.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from icafusion_tpu_torch.data.datasets import PairedDetectionDataset
from icafusion_tpu_torch.utils.general import labels_to_image_weights


@dataclasses.dataclass
class PairedLoader:
    dataset: PairedDetectionDataset
    batch_size: int
    max_targets: int = 64
    shuffle: bool = True
    seed: int = 0
    num_workers: int = 8
    drop_last: bool = True
    prefetch: int = 4
    image_weights: bool = False   # class-aware resampling (train.py:267-278)
    class_weights: Optional[np.ndarray] = None

    def __post_init__(self):
        n, B = len(self.dataset), self.batch_size
        self.steps_per_epoch = n // B if self.drop_last else (n + B - 1) // B

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        n = len(self.dataset)
        if self.image_weights:
            nc = self.dataset.nc or 1
            w = labels_to_image_weights(self.dataset.labels, nc,
                                        self.class_weights)
            w = w / max(w.sum(), 1e-9)
            idx = rng.choice(n, size=n, replace=True, p=w)
        else:
            idx = np.arange(n)
            if self.shuffle:
                rng.shuffle(idx)
        if self.drop_last:
            idx = idx[: self.steps_per_epoch * self.batch_size]
        return idx

    def _make_batch(self, indices, epoch: int) -> dict:
        B, S = len(indices), self.dataset.img_size
        rgb = np.empty((B, S, S, 3), np.uint8)
        ir = np.empty((B, S, S, 3), np.uint8)
        targets = np.zeros((B, self.max_targets, 5), np.float32)
        mask = np.zeros((B, self.max_targets), bool)

        def one(slot: int, index: int):
            rng = np.random.default_rng((self.seed, epoch, int(index)))
            rgb[slot], ir[slot], lab = self.dataset.train_sample(int(index),
                                                                 rng)
            n = min(len(lab), self.max_targets)
            if n:
                targets[slot, :n] = lab[:n]
                mask[slot, :n] = True

        if self.num_workers > 1:
            with ThreadPoolExecutor(self.num_workers) as ex:
                for f in [ex.submit(one, s, i) for s, i in enumerate(indices)]:
                    f.result()
        else:
            for s, i in enumerate(indices):
                one(s, i)
        return {"rgb": rgb, "ir": ir, "targets": targets, "mask": mask}

    def epoch(self, epoch: int) -> Iterator[dict]:
        """The epoch's batches, made ahead by a producer thread; an error
        there is raised here."""
        import cv2
        cv2.setNumThreads(0)   # cv2's own threads would fight the pool
        idx = self._epoch_indices(epoch)
        B = self.batch_size
        batches = [idx[i * B:(i + 1) * B] for i in range(self.steps_per_epoch)]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        end = object()

        def producer():
            try:
                for b in batches:
                    item = self._make_batch(b, epoch)
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
                q.put(end)
            except BaseException as e:   # handed to the consumer, re-raised
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=60)

    def val_batches(self) -> Iterator[dict]:
        """Batches of (B, S, S, 3) uint8 pairs in dataset order. The last
        batch is padded by repeating its final sample; ``count`` says how
        many rows are real. Keys: rgb, ir, labels, shapes, count, paths."""
        ds, B = self.dataset, self.batch_size
        n, S = len(ds), ds.img_size
        for start in range(0, n, B):
            idx = list(range(start, min(start + B, n)))
            count = len(idx)
            idx += [idx[-1]] * (B - count)
            rgb = np.empty((B, S, S, 3), np.uint8)
            ir = np.empty((B, S, S, 3), np.uint8)
            labels, shapes = [], []
            for slot, i in enumerate(idx):
                rgb[slot], ir[slot], lab, shp = ds.val_sample(i)
                labels.append(lab)
                shapes.append(shp)
            yield {"rgb": rgb, "ir": ir, "labels": labels, "shapes": shapes,
                   "count": count, "paths": [ds.files_rgb[i] for i in idx]}

    def rect_val_batches(self, stride: int = 32,
                         pad: float = 0.5) -> Iterator[dict]:
        """Batches on the reference's rect pad-0.5 canvases (its val
        protocol, test.py:100): each image gets its own canvas
        (rect_val_canvas, the reference's geometry at batch 1) and images
        are grouped by canvas, so every batch has one shape; a set of one
        aspect ratio makes one group. Within a group, dataset order; the
        last batch of a group is padded as in val_batches, whose keys these
        batches have."""
        ds, B = self.dataset, self.batch_size
        groups: dict = {}
        for i in range(len(ds)):
            groups.setdefault(ds.rect_val_canvas(i, stride, pad),
                              []).append(i)
        for (hh, ww), members in groups.items():
            for start in range(0, len(members), B):
                idx = members[start:start + B]
                count = len(idx)
                idx += [idx[-1]] * (B - count)
                rgb = np.empty((B, hh, ww, 3), np.uint8)
                ir = np.empty((B, hh, ww, 3), np.uint8)
                labels, shapes = [], []
                for slot, i in enumerate(idx):
                    rgb[slot], ir[slot], lab, shp = ds.val_sample(
                        i, canvas=(hh, ww))
                    labels.append(lab)
                    shapes.append(shp)
                yield {"rgb": rgb, "ir": ir, "labels": labels,
                       "shapes": shapes, "count": count,
                       "paths": [ds.files_rgb[i] for i in idx]}
