"""The evaluation and training-curve plots (a copy of those of the JAX
package's utils/plots.py; reference utils/plots.py and metrics.py):

- plot_results (plots.py:457-480): the results.csv curves;
- plot_pr_curve and plot_mc_curve (metrics.py:190-227): PR, F1, P and R
  curves per class;
- plot_confusion_matrix (metrics.py:164-181);
- plot_study_txt (plots.py:298-326): the speed/accuracy frontier of
  cli/val.py --task study;
- plot_mr_fppi (the KAIST evaluation script's MR-FPPI curve).

matplotlib is imported by each function when it draws, with the Agg
backend; where it is missing the call raises an ImportError that names it.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path

import numpy as np


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
