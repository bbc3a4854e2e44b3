"""A synthetic paired detection set on disk: coloured rectangles on dark
noise in RGB, the same boxes bright in IR, so that the class is the colour
and either stream locates the boxes (the generator of the JAX package's
examples/convergence_run.py, kept here so the port needs nothing of it).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

COLORS = [(255, 40, 40), (40, 255, 40), (40, 40, 255)]


def make_dataset(root: Path, n: int, rng: np.random.Generator, nc: int = 3,
                 hw=(256, 256)) -> Path:
    """n pairs under root/{visible,infrared,labels}/{train,val} (the first
    85% train), JPEG images of hw = (h, w) (FLIR-aligned frames are
    512 x 640), 1-3 boxes each. Returns the path of a data YAML naming
    them."""
    import cv2
    root = Path(root)
    for sub in ("visible/train", "infrared/train", "labels/train",
                "visible/val", "infrared/val", "labels/val"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    split_at = int(n * 0.85)
    h, w = hw
    for i in range(n):
        split = "train" if i < split_at else "val"
        rgb = rng.integers(0, 40, (h, w, 3), dtype=np.uint8)
        ir = rng.integers(0, 30, (h, w, 3), dtype=np.uint8)
        lines = []
        for _ in range(int(rng.integers(1, 4))):
            bw = int(rng.uniform(0.15, 0.4) * w)
            bh = int(rng.uniform(0.15, 0.4) * h)
            x1, y1 = int(rng.uniform(0, w - bw)), int(rng.uniform(0, h - bh))
            cls = int(rng.integers(0, nc))
            cv2.rectangle(rgb, (x1, y1), (x1 + bw, y1 + bh),
                          COLORS[cls % len(COLORS)], -1)
            cv2.rectangle(ir, (x1, y1), (x1 + bw, y1 + bh), (220, 220, 220),
                          -1)
            lines.append(f"{cls} {(x1 + bw / 2) / w:.6f} "
                         f"{(y1 + bh / 2) / h:.6f} {bw / w:.6f} {bh / h:.6f}")
        cv2.imwrite(str(root / f"visible/{split}" / f"i{i:04d}.jpg"),
                    rgb[:, :, ::-1])
        cv2.imwrite(str(root / f"infrared/{split}" / f"i{i:04d}.jpg"),
                    ir[:, :, ::-1])
        (root / f"labels/{split}" / f"i{i:04d}.txt").write_text(
            "\n".join(lines) + "\n")
    names = ", ".join(f"'c{k}'" for k in range(nc))
    data = root / "data.yaml"
    data.write_text(f"path: {root}\ntrain_rgb: visible/train\n"
                    "train_ir: infrared/train\nval_rgb: visible/val\n"
                    f"val_ir: infrared/val\nnc: {nc}\nnames: [{names}]\n")
    return data
