"""Dataset tools, the counterparts of the JAX package's data/tools.py
(reference utils/datasets.py:1687-1757):

- ``autosplit``: write autosplit_{train,val,test}.txt list files at the
  given ratios;
- ``extract_boxes``: crop every labelled box into a per-class folder (a
  classification dataset);
- ``flatten_recursive``: copy a nested tree's files into one folder.

Host-side only: numpy, the standard library, and cv2 inside
``extract_boxes``.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np

from icafusion_tpu_torch.data.datasets import (IMG_FORMATS, img2label_path,
                                               parse_label_file)


def autosplit(path: str, weights=(0.9, 0.1, 0.0),
              annotated_only: bool = False, seed: int = 0):
    """Assign each image under ``path`` to train, val or test with the
    given probabilities (np.random.default_rng(seed)) and write the
    autosplit_*.txt lists beside ``path`` (datasets.py:1733-1757)."""
    path = Path(path)
    files = sorted(p for p in path.rglob("*.*")
                   if p.suffix[1:].lower() in IMG_FORMATS)
    rng = np.random.default_rng(seed)
    idx = rng.choice(3, size=len(files), p=list(weights))
    names = ["autosplit_train.txt", "autosplit_val.txt", "autosplit_test.txt"]
    for n in names:
        (path.parent / n).unlink(missing_ok=True)
    for f, i in zip(files, idx):
        if annotated_only and not Path(img2label_path(str(f))).exists():
            continue
        with open(path.parent / names[i], "a") as fh:
            fh.write(f"./{f.relative_to(path.parent)}\n")


def extract_boxes(path: str, out_dir: str = None) -> int:
    """Crop the labelled boxes of the images under ``path``, padded by 2 %
    and 3 px (datasets.py:1705-1730), into <out_dir>/<class>/<stem>_<j>.jpg
    (default out_dir: <path>/../classifier). Returns the crops written."""
    import cv2
    path = Path(path)
    out = Path(out_dir) if out_dir else path.parent / "classifier"
    n = 0
    for img_path in sorted(path.rglob("*.*")):
        if img_path.suffix[1:].lower() not in IMG_FORMATS:
            continue
        lab = parse_label_file(img2label_path(str(img_path)))
        if not len(lab):
            continue
        im = cv2.imread(str(img_path))
        h, w = im.shape[:2]
        for j, (c, x, y, bw, bh) in enumerate(lab):
            d = out / str(int(c))
            d.mkdir(parents=True, exist_ok=True)
            b = np.array([x * w, y * h, bw * w, bh * h])
            b[2:] = b[2:] * 1.02 + 3
            x1 = int(max(b[0] - b[2] / 2, 0))
            y1 = int(max(b[1] - b[3] / 2, 0))
            x2 = int(min(b[0] + b[2] / 2, w))
            y2 = int(min(b[1] + b[3] / 2, h))
            crop = im[y1:y2, x1:x2]
            if crop.size:
                cv2.imwrite(str(d / f"{img_path.stem}_{j}.jpg"), crop)
                n += 1
    return n


def flatten_recursive(path: str, out_dir: str = None) -> Path:
    """Copy every file under ``path`` into one folder (default
    <path>_flat); a later file of the same name replaces an earlier one
    (datasets.py:1695-1702)."""
    path = Path(path)
    out = Path(out_dir) if out_dir else Path(str(path) + "_flat")
    out.mkdir(parents=True, exist_ok=True)
    for f in path.rglob("*.*"):
        if f.is_file():
            shutil.copyfile(f, out / f.name)
    return out
