"""Fixed-shape evaluation batches (the val side of the JAX package's
data/loader.py, cv2 decoding only)."""

from __future__ import annotations

from typing import Iterator

import numpy as np

from icafusion_tpu_torch.data.datasets import PairedDetectionDataset


class PairedLoader:
    """Batches of a PairedDetectionDataset for evaluation."""

    def __init__(self, dataset: PairedDetectionDataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

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
