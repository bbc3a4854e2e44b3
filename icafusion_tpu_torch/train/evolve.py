"""Hyperparameter evolution: the genetic search of reference
train.py:590-670, the counterpart of the JAX package's train/evolve.py.

Each generation mutates a parent within the reference's per-key (gain,
min, max) bounds, trains a short run with the candidate and appends its
fitness to an evolve log; parents come from the log's top five by
fitness, chosen with fitness-weighted probability. Every draw comes from
one ``np.random.default_rng(seed)``, in the JAX package's order, so both
packages give the same candidates generation by generation.

As in the JAX package, ``select_parent`` rebuilds the HypConfig from the
27 META columns of the log alone: from the second generation on, keys
outside META (``label_smoothing``, ``anchors``) fall back to their
defaults.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from icafusion_tpu_torch.config import HypConfig

# key: (mutation gain, min, max), the reference's meta dict
# (train.py:597-625)
META = {
    "lr0": (1, 1e-5, 1e-1), "lrf": (1, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98), "weight_decay": (1, 0.0, 0.001),
    "warmup_epochs": (1, 0.0, 5.0), "warmup_momentum": (1, 0.0, 0.95),
    "warmup_bias_lr": (1, 0.0, 0.2), "box": (1, 0.02, 0.2),
    "cls": (1, 0.2, 4.0), "cls_pw": (1, 0.5, 2.0), "obj": (1, 0.2, 4.0),
    "obj_pw": (1, 0.5, 2.0), "iou_t": (0, 0.1, 0.7),
    "anchor_t": (1, 2.0, 8.0), "fl_gamma": (0, 0.0, 2.0),
    "hsv_h": (1, 0.0, 0.1), "hsv_s": (1, 0.0, 0.9), "hsv_v": (1, 0.0, 0.9),
    "degrees": (1, 0.0, 45.0), "translate": (1, 0.0, 0.9),
    "scale": (1, 0.0, 0.9), "shear": (1, 0.0, 10.0),
    "perspective": (0, 0.0, 0.001), "flipud": (1, 0.0, 1.0),
    "fliplr": (0, 0.0, 1.0), "mosaic": (1, 0.0, 1.0), "mixup": (1, 0.0, 1.0),
}


def mutate(hyp: HypConfig, rng: np.random.Generator,
           mp: float = 0.8, sigma: float = 0.2) -> HypConfig:
    """Multiplicative mutation within the bounds (train.py:629-644)."""
    keys = list(META)
    g = np.array([META[k][0] for k in keys])
    v = np.ones(len(keys))
    while (v == 1).all():
        v = (g * (rng.random(len(keys)) < mp) * rng.standard_normal(len(keys))
             * rng.random() * sigma + 1).clip(0.3, 3.0)
    out = {}
    for k, vi in zip(keys, v):
        _, lo, hi = META[k]
        out[k] = float(np.clip(getattr(hyp, k) * vi, lo, hi))
    return hyp.replace(**out)


@dataclasses.dataclass
class EvolveLog:
    """evolve.csv: a header ``fitness,<META keys>`` and one row a
    generation, each value with 6 significant digits."""
    path: Path

    def append(self, fitness: float, hyp: HypConfig):
        keys = list(META)
        vals = [fitness] + [getattr(hyp, k) for k in keys]
        header = not self.path.exists()
        with open(self.path, "a") as f:
            if header:
                f.write(",".join(["fitness"] + keys) + "\n")
            f.write(",".join(f"{v:.6g}" for v in vals) + "\n")

    def load(self) -> np.ndarray:
        if not self.path.exists():
            return np.zeros((0, len(META) + 1))
        rows = [l.split(",") for l in
                self.path.read_text().strip().splitlines()[1:]]
        return (np.array(rows, np.float64) if rows
                else np.zeros((0, len(META) + 1)))

    def select_parent(self, rng: np.random.Generator
                      ) -> Optional[HypConfig]:
        """One parent from the top five by fitness, with fitness-weighted
        probability (train.py:630-640); None for an empty log."""
        x = self.load()
        if not len(x):
            return None
        n = min(5, len(x))
        x = x[np.argsort(-x[:, 0])][:n]
        w = x[:, 0] - x[:, 0].min() + 1e-6
        row = x[rng.choice(n, p=w / w.sum())]
        return HypConfig(**{k: float(v) for k, v in zip(META, row[1:])})


def evolve(train_fn: Callable[[HypConfig], float], base_hyp: HypConfig,
           generations: int = 300, log_path: str = "evolve.csv",
           seed: int = 0) -> HypConfig:
    """train_fn(hyp) -> fitness, once a generation. Returns the best
    candidate found."""
    rng = np.random.default_rng(seed)
    log = EvolveLog(Path(log_path))
    best_hyp, best_fit = base_hyp, -1.0
    for gen in range(generations):
        parent = log.select_parent(rng) or base_hyp
        cand = mutate(parent, rng)
        fit = float(train_fn(cand))
        log.append(fit, cand)
        if fit > best_fit:
            best_fit, best_hyp = fit, cand
        print(f"evolve gen {gen}: fitness={fit:.4f} best={best_fit:.4f}")
    return best_hyp
