"""AutoAnchor: the anchor-fit check and the k-means + genetic anchor search
(the JAX package's train/autoanchor.py; reference utils/autoanchor.py), in
numpy; scipy is imported when k-means runs.

- check_anchors: best possible recall (BPR) of the label shapes against the
  anchors at the training size, with the reference's 0.9-1.1 jitter;
  recompute when BPR < 0.98;
- kmean_anchors: whitened k-means, then 1000 generations of multiplicative
  mutation keeping the fittest anchors;
- metric: r = min(wh / anchor, anchor / wh), its minimum over w and h;
  fitness is the mean best metric over labels above 1 / anchor_t.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _metric(wh: np.ndarray, anchors: np.ndarray):
    """(n, 2) label shapes x (k, 2) anchors -> (best metric per label,
    all metrics (n, k))."""
    r = wh[:, None] / anchors[None]
    x = np.minimum(r, 1 / r).min(2)
    return x.max(1), x


def anchor_fitness(wh: np.ndarray, anchors: np.ndarray, thr: float) -> float:
    best, _ = _metric(wh, anchors)
    return float((best * (best > thr)).mean())


def dataset_shapes(labels: Sequence[np.ndarray],
                   img_shapes: Sequence[Tuple[int, int]], img_size: int,
                   jitter: bool = True,
                   rng: np.random.Generator = None) -> np.ndarray:
    """Label wh in training pixels (normalised wh times the image's
    letterbox scale), with the 0.9-1.1 jitter."""
    rng = rng or np.random.default_rng(0)
    out = []
    for lab, (h, w) in zip(labels, img_shapes):
        if not len(lab):
            continue
        wh = lab[:, 3:5] * np.array([w, h]) * (img_size / max(h, w))
        if jitter:
            wh = wh * rng.uniform(0.9, 1.1, size=(len(wh), 1))
        out.append(wh)
    return np.concatenate(out, 0) if out else np.zeros((0, 2))


def check_anchors(wh: np.ndarray, anchors_px: np.ndarray, thr: float = 4.0):
    """(bpr, anchors above threshold per label)."""
    thr = 1.0 / thr
    best, x = _metric(wh, anchors_px.reshape(-1, 2))
    return float((best > thr).mean()), float((x > thr).sum(1).mean())


def kmean_anchors(wh: np.ndarray, n: int = 9, img_size: int = 640,
                  thr: float = 4.0, gen: int = 1000, seed: int = 0,
                  verbose: bool = False) -> np.ndarray:
    """k-means + genetic search; (n, 2) anchors sorted by area."""
    from scipy.cluster.vq import kmeans

    thr = 1.0 / thr
    rng = np.random.default_rng(seed)
    wh = wh[(wh >= 2.0).any(1)].astype(np.float64)
    s = wh.std(0)
    k = kmeans(wh / s, n, iter=30, seed=seed)[0] * s
    if len(k) != n:                     # degenerate k-means: random start
        k = wh[rng.integers(0, len(wh), n)]
    k = k[np.argsort(k.prod(1))]

    f = anchor_fitness(wh, k, thr)
    sh = k.shape
    mp, sigma = 0.9, 0.1                 # mutation probability and scale
    for g in range(gen):
        v = np.ones(sh)
        while (v == 1).all():
            v = ((rng.random(sh) < mp) * rng.random()
                 * rng.standard_normal(sh) * sigma + 1).clip(0.3, 3.0)
        kg = (k * v).clip(min=2.0)
        fg = anchor_fitness(wh, kg, thr)
        if fg > f:
            f, k = fg, kg.copy()
            if verbose and g % 100 == 0:
                print(f"gen {g}: fitness {f:.4f}")
    return k[np.argsort(k.prod(1))].astype(np.float32)


def maybe_autoanchor(dataset, anchors_px: np.ndarray, img_size: int,
                     thr: float = 4.0, bpr_threshold: float = 0.98):
    """The check_anchors flow: (anchors, recomputed?)."""
    import cv2
    shapes = [cv2.imread(p).shape[:2] for p in dataset.files_rgb]
    wh = dataset_shapes(dataset.labels, shapes, img_size)
    if not len(wh):
        return anchors_px, False
    bpr, aat = check_anchors(wh, anchors_px, thr)
    print(f"autoanchor: BPR={bpr:.4f}, anchors/target={aat:.2f}")
    if bpr > bpr_threshold:
        return anchors_px, False
    print("autoanchor: BPR below threshold, running k-means+GA...")
    n = int(np.prod(anchors_px.shape[:-1]))
    new = kmean_anchors(wh, n=n, img_size=img_size, thr=thr)
    new_bpr, _ = check_anchors(wh, new, thr)
    if new_bpr > bpr:
        return new.reshape(anchors_px.shape), True
    return anchors_px, False
