"""Drawing and plots (a copy of the JAX package's utils/plots.py;
reference utils/plots.py, general.py and metrics.py).

Drawn with cv2 alone, so they work where matplotlib is missing:
- COLORS, color, plot_one_box (plots.py:67-87): a labelled box on an image;
- save_one_box (general.py:692-702): a padded crop written as jpg;
- plot_images (plots.py:173-249): a mosaic of a batch with its targets.

Drawn with matplotlib:
- plot_labels (plots.py:330-375): the class and box distributions;
- plot_evolution (plots.py:378-400): hyperparameters against fitness;
- plot_results (plots.py:457-480): the results.csv curves;
- plot_pr_curve and plot_mc_curve (metrics.py:190-227): PR, F1, P and R
  curves per class;
- plot_confusion_matrix (metrics.py:164-181);
- plot_study_txt (plots.py:298-326): the speed/accuracy frontier of
  cli/val.py --task study;
- plot_mr_fppi (the KAIST evaluation script's MR-FPPI curve).

cv2 and matplotlib are imported by each function when it draws,
matplotlib with the Agg backend; where it is missing the call raises an
ImportError that names it.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path

import numpy as np


COLORS = [(255, 56, 56), (50, 205, 50), (65, 105, 225), (255, 157, 151),
          (255, 112, 31), (147, 69, 52), (72, 249, 10), (26, 147, 52),
          (0, 212, 187), (255, 56, 132)]


def color(i: int):
    return COLORS[int(i) % len(COLORS)]


def plot_one_box(img, xyxy, label: str = "", col=(255, 56, 56),
                 line_thickness: int = None):
    """Draw one labelled box on img in place (plots.py:67-87)."""
    import cv2
    x1, y1, x2, y2 = (int(v) for v in xyxy)
    tl = line_thickness or max(
        round(0.002 * (img.shape[0] + img.shape[1]) / 2), 1)
    cv2.rectangle(img, (x1, y1), (x2, y2), col, tl, cv2.LINE_AA)
    if label:
        tf = max(tl - 1, 1)
        ts = cv2.getTextSize(label, 0, fontScale=tl / 3, thickness=tf)[0]
        cv2.rectangle(img, (x1, y1), (x1 + ts[0], y1 - ts[1] - 3), col, -1,
                      cv2.LINE_AA)
        cv2.putText(img, label, (x1, y1 - 2), 0, tl / 3, (225, 255, 255), tf,
                    cv2.LINE_AA)


def save_one_box(xyxy, im_bgr, file, gain: float = 1.02, pad: int = 10,
                 square: bool = False) -> Path:
    """Write a gain-scaled, pad-grown crop of im_bgr (BGR uint8) to file as
    jpg (general.py:692-702); an existing name gets _2, _3, ... Returns the
    path written."""
    import cv2
    x1, y1, x2, y2 = (float(v) for v in xyxy)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    w, h = x2 - x1, y2 - y1
    if square:
        w = h = max(w, h)
    w, h = w * gain + 2 * pad, h * gain + 2 * pad
    H, W = im_bgr.shape[:2]
    xa = int(np.clip(cx - w / 2, 0, W - 1))
    xb = int(np.clip(cx + w / 2, 0, W))
    ya = int(np.clip(cy - h / 2, 0, H - 1))
    yb = int(np.clip(cy + h / 2, 0, H))
    file = Path(file).with_suffix(".jpg")
    file.parent.mkdir(parents=True, exist_ok=True)
    base, n = file, 2
    while file.exists():
        file = base.with_name(f"{base.stem}_{n}.jpg")
        n += 1
    cv2.imwrite(str(file), im_bgr[ya:yb, xa:xb])
    return file


def plot_images(images, targets, masks=None, path=None, names=None,
                max_images: int = 16):
    """A mosaic of a batch with its target boxes (plots.py:173-249).
    images: (B, H, W, 3) uint8, or float in [0, 1]; targets: (B, T, 5)
    normalised class + xywh with a (B, T) mask. Written to path (RGB in, jpg
    out) where given; returns the mosaic."""
    import cv2
    imgs = np.asarray(images)[:max_images]
    if imgs.dtype != np.uint8:
        imgs = (imgs * 255).clip(0, 255).astype(np.uint8)
    B, H, W, _ = imgs.shape
    cols = int(math.ceil(math.sqrt(B)))
    rows = int(math.ceil(B / cols))
    canvas = np.full((rows * H, cols * W, 3), 255, np.uint8)
    for i in range(B):
        r, c = divmod(i, cols)
        tile = imgs[i].copy()
        t = np.asarray(targets[i])
        m = (np.asarray(masks[i]) if masks is not None
             else np.ones(len(t), bool))
        for (cls, cx, cy, bw, bh), ok in zip(t, m):
            if not ok:
                continue
            box = ((cx - bw / 2) * W, (cy - bh / 2) * H,
                   (cx + bw / 2) * W, (cy + bh / 2) * H)
            label = names[int(cls)] if names else str(int(cls))
            plot_one_box(tile, box, label, color(cls))
        canvas[r * H:(r + 1) * H, c * W:(c + 1) * W] = tile
    if path:
        cv2.imwrite(str(path), canvas[:, :, ::-1])
    return canvas


def _pyplot():
    """matplotlib.pyplot on the Agg backend."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_results(csv_path, save_path=None):
    """Training curves from results.csv (plots.py:457-480)."""
    plt = _pyplot()
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return None
    keys = [k for k in rows[0] if k not in ("epoch",)]
    epochs = [int(r["epoch"]) for r in rows]
    n = len(keys)
    cols = 5
    rws = int(math.ceil(n / cols))
    fig, ax = plt.subplots(rws, cols, figsize=(3 * cols, 3 * rws),
                           tight_layout=True)
    ax = np.atleast_1d(ax).ravel()
    for i, k in enumerate(keys):
        vals = [float(r[k]) for r in rows]
        ax[i].plot(epochs, vals, ".-")
        ax[i].set_title(k, fontsize=9)
    for j in range(n, len(ax)):
        ax[j].axis("off")
    out = Path(save_path or Path(csv_path).with_name("results.png"))
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def plot_pr_curve(px, py, ap, save_path, names=()):
    """PR curves per class (metrics.py:190-205)."""
    plt = _pyplot()
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.stack(py, axis=1) if isinstance(py, list) else py
    for i in range(py.shape[1]):
        label = (f"{names[i]} {ap[i, 0]:.3f}" if len(names) == py.shape[1]
                 else None)
        ax.plot(px, py[:, i], linewidth=1, label=label)
    ax.plot(px, py.mean(1), linewidth=3, color="blue",
            label=f"all classes {ap[:, 0].mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(loc="lower left", fontsize=8)
    fig.savefig(save_path, dpi=250)
    plt.close(fig)


def plot_mc_curve(px, py, save_path, names=(), xlabel="Confidence",
                  ylabel="Metric"):
    """Metric-vs-confidence curves per class (metrics.py:208-227)."""
    plt = _pyplot()
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.asarray(py)
    if 0 < len(names) < 21 and len(names) == py.shape[0]:
        for i, y in enumerate(py):
            ax.plot(px, y, linewidth=1, label=str(names[i]))
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    y = py.mean(0)
    ax.plot(px, y, linewidth=3, color="blue",
            label=f"all classes {y.max():.2f} at {px[y.argmax()]:.3f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(loc="lower left", fontsize=8)
    fig.savefig(save_path, dpi=250)
    plt.close(fig)


def plot_confusion_matrix(matrix, names=(), save_path="confusion_matrix.png"):
    """Normalized confusion matrix heatmap incl. background row/col
    (metrics.py:164-181)."""
    plt = _pyplot()
    m = np.asarray(matrix, np.float64)
    m = m / (m.sum(0, keepdims=True) + 1e-6)
    n = m.shape[0]
    fig, ax = plt.subplots(figsize=(8, 7), tight_layout=True)
    im = ax.imshow(m, cmap="Blues", vmin=0, vmax=1)
    fig.colorbar(im, ax=ax)
    ticks = (list(names) + ["background"]) if len(names) == n - 1 else \
        [str(i) for i in range(n)]
    ax.set_xticks(range(n))
    ax.set_xticklabels(ticks, rotation=90, fontsize=8)
    ax.set_yticks(range(n))
    ax.set_yticklabels(ticks, fontsize=8)
    ax.set_xlabel("True")
    ax.set_ylabel("Predicted")
    for i in range(n):
        for j in range(n):
            if m[i, j] > 0.005:
                ax.text(j, i, f"{m[i, j]:.2f}", ha="center", va="center",
                        fontsize=7, color="white" if m[i, j] > 0.5 else "black")
    fig.savefig(save_path, dpi=200)
    plt.close(fig)
    return save_path


def plot_mr_fppi(fppi, missrate, save_path, label=""):
    """KAIST MR-FPPI log-log curve (evaluation_script.py:397-430 draw_figure)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 6), tight_layout=True)
    ax.plot(fppi, missrate, linewidth=2, label=label)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("false positives per image")
    ax.set_ylabel("miss rate")
    ax.grid(which="both", alpha=0.3)
    if label:
        ax.legend()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)


def plot_study_txt(study_dir=".", save_path=None):
    """Speed-vs-accuracy frontier from `study_*.txt` files written by
    `cli/val.py --task study` (reference plots.py:298-326, test.py:425-438).

    Each file holds one row per image size with 10 columns:
    [P, R, mAP@.5, mAP@.5:.95, lbox, lobj, lcls, t_inf, t_nms, t_total] —
    the reference's layout, so files from either framework plot identically.
    """
    plt = _pyplot()
    study_dir = Path(study_dir)
    files = sorted(study_dir.glob("study_*.txt"))
    if not files:
        return None
    fig, ax = plt.subplots(1, 1, figsize=(8, 4), tight_layout=True)
    for f in files:
        y = np.loadtxt(f, dtype=np.float32,
                       usecols=[0, 1, 2, 3, 7, 8, 9], ndmin=2).T
        j = int(y[3].argmax()) + 1
        ax.plot(y[6, :j], y[3, :j] * 100, ".-", linewidth=2, markersize=8,
                label=f.stem.replace("study_", ""))
    ax.grid(alpha=0.2)
    ax.set_xlabel("speed (ms/img)")
    ax.set_ylabel("mAP@.5:.95 (%)")
    ax.legend(loc="lower right")
    save_path = save_path or study_dir / "study.png"
    fig.savefig(save_path, dpi=300)
    plt.close(fig)
    return str(save_path)


def plot_labels(labels, names=None, save_dir="."):
    """Class histogram and box centre and size distributions of a list of
    (n, 5) label arrays (plots.py:330-375); writes labels.png."""
    plt = _pyplot()
    rows = np.concatenate([l for l in labels if len(l)], 0)
    cls, boxes = rows[:, 0], rows[:, 1:5]
    nc = int(cls.max()) + 1
    fig, ax = plt.subplots(2, 2, figsize=(8, 8), tight_layout=True)
    ax = ax.ravel()
    ax[0].hist(cls, bins=np.arange(nc + 1) - 0.5, rwidth=0.8)
    ax[0].set_xlabel("class")
    if names and len(names) == nc:
        ax[0].set_xticks(range(nc))
        ax[0].set_xticklabels(names, rotation=90, fontsize=8)
    ax[1].scatter(boxes[:, 0], boxes[:, 1], c=cls, s=3, cmap="tab10")
    ax[1].set_xlabel("x")
    ax[1].set_ylabel("y")
    ax[2].scatter(boxes[:, 2], boxes[:, 3], c=cls, s=3, cmap="tab10")
    ax[2].set_xlabel("width")
    ax[2].set_ylabel("height")
    ax[3].hist2d(boxes[:, 2], boxes[:, 3], bins=50, cmap="Blues")
    ax[3].set_xlabel("width")
    ax[3].set_ylabel("height")
    out = Path(save_dir) / "labels.png"
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def plot_evolution(evolve_csv, save_path=None):
    """Each hyperparameter against fitness over an evolve log (plots.py:
    378-400, over the JAX package's evolve.csv: header `fitness,<hyp
    keys...>`), the best run's value marked in each panel."""
    plt = _pyplot()
    evolve_csv = Path(evolve_csv)
    keys = evolve_csv.read_text().splitlines()[0].split(",")[1:]
    x = np.loadtxt(evolve_csv, delimiter=",", skiprows=1, ndmin=2)
    if not len(x):
        return None
    f = x[:, 0]
    ncols = 5
    nrows = math.ceil(len(keys) / ncols)
    fig = plt.figure(figsize=(10, 2 * nrows), tight_layout=True)
    for i, k in enumerate(keys):
        y = x[:, i + 1]
        mu = y[f.argmax()]
        plt.subplot(nrows, ncols, i + 1)
        plt.scatter(y, f, c=f, cmap="viridis", alpha=0.8, edgecolors="none")
        plt.plot(mu, f.max(), "k+", markersize=15)
        plt.title(f"{k} = {mu:.3g}", fontdict={"size": 9})
        if i % ncols != 0:
            plt.yticks([])
    save_path = save_path or evolve_csv.with_suffix(".png")
    fig.savefig(save_path, dpi=200)
    plt.close(fig)
    return str(save_path)
