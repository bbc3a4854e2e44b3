"""Confluence: the IoU-free alternative to NMS, on the host in numpy.

A copy of the JAX package's ops/confluence.py (reference
utils/confluence.py:50-193, the optional swap-in at test.py:140): per
class, repeatedly keep the box with the smallest confidence-weighted
normalised Manhattan proximity to its cluster and drop every box within the
proximity threshold. It is sequential, with trip counts that depend on the
data, so it stays on the host; NMS (ops/nms.py) is the default. Copied as
it is, cost included: quadratic in the candidates of a class, so raise the
confidence threshold (0.1) with it; at 0.001 it may not finish.
"""

from __future__ import annotations

from typing import List

import numpy as np


def confluence_indices(dets: np.ndarray, class_num: int,
                       p_thres: float = 0.6) -> np.ndarray:
    """dets (n,6) [x1,y1,x2,y2,conf,cls] -> kept indices
    (reference confluence(), utils/confluence.py:109-193)."""
    index = np.arange(len(dets)).reshape(-1, 1)
    infos = np.concatenate([dets, index], 1)
    keep: List[int] = []

    for c in range(class_num):
        pcs = infos[infos[:, 5] == c]
        while len(pcs):
            n = len(pcs)
            xs = pcs[:, [0, 2]]
            ys = pcs[:, [1, 3]]
            ps = []
            confluence_min = 1e4
            best = None
            for i in range(n):
                if n == 1:
                    best = 0
                    break
                others = [j for j in range(n) if j != i]
                x_all = np.concatenate([np.tile(xs[i], (n - 1, 1)), xs[others]], 1)
                y_all = np.concatenate([np.tile(ys[i], (n - 1, 1)), ys[others]], 1)
                xmin, xmax = x_all.min(1, keepdims=True), x_all.max(1, keepdims=True)
                ymin, ymax = y_all.min(1, keepdims=True), y_all.max(1, keepdims=True)
                x_all = (x_all - xmin) / (xmax - xmin)
                y_all = (y_all - ymin) / (ymax - ymin)
                p = (np.abs(x_all[:, 0] - x_all[:, 2]) + np.abs(x_all[:, 1] - x_all[:, 3])
                     + np.abs(y_all[:, 0] - y_all[:, 2]) + np.abs(y_all[:, 1] - y_all[:, 3]))
                ps.append(p)
                wp = (p / pcs[i, 4])[p < 2]
                value = wp.min() if len(wp) else 0.0
                if value < confluence_min:
                    confluence_min = value
                    best = i
            keep.append(int(pcs[best][6]))
            if ps:
                p = ps[best]
                close = np.where(p < p_thres)[0]
                close = [j if j < best else j + 1 for j in close]
            else:
                close = []
            pcs = pcs[[j for j in range(n) if j != best and j not in close]]
    return np.unique(keep)


def confluence_process(prediction: np.ndarray, conf_thres: float = 0.1,
                       p_thres: float = 0.6) -> List[np.ndarray]:
    """Full pipeline over decoded predictions (B, N, 5+nc) in xywh+obj+cls
    (reference confluence_process, utils/confluence.py:50-106). Returns a list of
    (n,6) [xyxy, conf, cls] arrays."""
    nc = prediction.shape[2] - 5
    multi_label = nc > 1
    out = []
    for x in prediction:
        x = x[x[:, 4] > conf_thres]
        if not len(x):
            out.append(np.zeros((0, 6), np.float32))
            continue
        x = x.copy()
        x[:, 5:] *= x[:, 4:5]
        box = np.concatenate([x[:, :2] - x[:, 2:4] / 2, x[:, :2] + x[:, 2:4] / 2], 1)
        if multi_label:
            i, j = np.nonzero(x[:, 5:] > conf_thres)
            x = np.concatenate([box[i], x[i, j + 5, None],
                                j[:, None].astype(np.float32)], 1)
        else:
            conf = x[:, 5:].max(1, keepdims=True)
            j = x[:, 5:].argmax(1, keepdims=True).astype(np.float32)
            x = np.concatenate([box, conf, j], 1)[conf.ravel() > conf_thres]
        if not len(x):
            out.append(np.zeros((0, 6), np.float32))
            continue
        keep = confluence_indices(x, nc, p_thres)
        out.append(x[keep])
    return out
