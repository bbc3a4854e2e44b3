"""Paired RGB/IR detection data for evaluation (the val side of the JAX
package's data/datasets.py; reference utils/datasets.py:690-1057).

RGB and IR file lists are discovered separately (a directory, a txt list or
a glob) and paired by index. Labels come from the RGB side: the
'visible'/'infrared'/'images' path component becomes 'labels' and the
extension '.txt'. Each label file is (n, 5) [cls, x, y, w, h], normalised,
validated as the reference's cache_labels validates it. Images are decoded
with cv2, imported when an image is read.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from icafusion_tpu_torch.data.augment import letterbox

IMG_FORMATS = {"bmp", "jpg", "jpeg", "png", "tif", "tiff", "dng", "webp", "mpo"}


def discover_images(path: str) -> List[str]:
    """dir / txt-list / glob discovery (datasets.py:711-741)."""
    p = Path(path)
    if p.is_dir():
        files = sorted(str(x) for x in p.rglob("*.*"))
    elif p.is_file() and p.suffix == ".txt":
        parent = str(p.parent) + os.sep
        with open(p) as f:
            lines = [x.strip() for x in f.read().splitlines() if x.strip()]
        files = [x.replace("./", parent) if x.startswith("./") else x
                 for x in lines]
    else:
        files = sorted(glob.glob(path, recursive=True))
    files = [f for f in files if f.rsplit(".", 1)[-1].lower() in IMG_FORMATS]
    if not files:
        raise FileNotFoundError(f"no images found in {path}")
    return files


def img2label_path(img_path: str) -> str:
    """Replace the visible/infrared/images dir with labels, the extension
    with .txt (datasets.py:391-401); without such a dir, the label sits next
    to the image."""
    parts = img_path.split(os.sep)
    for src in ("visible", "infrared", "images"):
        if src in parts:
            path = img_path.replace(os.sep + src + os.sep,
                                    os.sep + "labels" + os.sep, 1)
            return str(Path(path).with_suffix(".txt"))
    return str(Path(img_path).with_suffix(".txt"))


def parse_label_file(path: str, nc: Optional[int] = None) -> np.ndarray:
    """(n, 5) [cls, x, y, w, h] normalised; validated as cache_labels
    validates (datasets.py:896-913), duplicate rows removed."""
    if not os.path.isfile(path):
        return np.zeros((0, 5), np.float32)
    with open(path) as f:
        rows = [x.split() for x in f.read().strip().splitlines() if len(x)]
    if not rows:
        return np.zeros((0, 5), np.float32)
    lab = np.array(rows, dtype=np.float32)
    assert lab.shape[1] == 5, f"labels require 5 columns each: {path}"
    assert (lab >= 0).all(), f"negative labels: {path}"
    assert (lab[:, 1:] <= 1).all(), (f"non-normalized or out of bounds "
                                     f"coordinates: {path}")
    uniq = np.unique(lab, axis=0)
    if len(uniq) < len(lab):
        lab = uniq
    if nc is not None:
        assert (lab[:, 0] < nc).all(), f"label class exceeds nc={nc}: {path}"
    return lab


class PairedDetectionDataset:
    """Index-aligned RGB/IR images and RGB-side labels, for evaluation.

    single_cls: every label becomes class 0 (the reference's
    --single-cls)."""

    def __init__(self, path_rgb: str, path_ir: str, img_size: int = 640,
                 nc: Optional[int] = None, single_cls: bool = False):
        self.img_size = img_size
        self.files_rgb = discover_images(path_rgb)
        self.files_ir = discover_images(path_ir)
        if len(self.files_rgb) != len(self.files_ir):
            raise ValueError(f"paired counts differ: {len(self.files_rgb)} "
                             f"rgb vs {len(self.files_ir)} ir")
        self.label_files = [img2label_path(p) for p in self.files_rgb]
        self.labels = [parse_label_file(p, None if single_cls else nc)
                       for p in self.label_files]
        if single_cls:
            for lab in self.labels:
                lab[:, 0] = 0

    def __len__(self):
        return len(self.files_rgb)

    def load_pair(self, index: int
                  ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
        """Decode one pair as HWC RGB uint8 and resize its longer side to
        img_size (datasets.py:1097-1125): INTER_AREA when shrinking, else
        INTER_LINEAR. Returns (rgb, ir, native (h0, w0))."""
        import cv2
        out = []
        for path in (self.files_rgb[index], self.files_ir[index]):
            img = cv2.imread(path)
            if img is None:
                raise FileNotFoundError(f"image not found or unreadable: "
                                        f"{path}")
            out.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        h0, w0 = out[0].shape[:2]
        r = self.img_size / max(h0, w0)
        if r != 1:
            interp = cv2.INTER_AREA if r < 1 else cv2.INTER_LINEAR
            size = (int(w0 * r), int(h0 * r))
            out = [cv2.resize(img, size, interpolation=interp) for img in out]
        return out[0], out[1], (h0, w0)

    def val_sample(self, index: int, canvas=None):
        """The letterboxed pair (scaleup=False) on canvas (default the
        img_size square), its labels and the shapes for rescaling to native
        coordinates: ((h0, w0), ((gain_h, gain_w), (pad_w, pad_h)))."""
        rgb, ir, (h0, w0) = self.load_pair(index)
        h, w = rgb.shape[:2]
        canvas = self.img_size if canvas is None else canvas
        rgb, ratio, pad = letterbox(rgb, canvas, scaleup=False)
        ir, _, _ = letterbox(ir, canvas, scaleup=False)
        shapes = ((h0, w0), ((h / h0 * ratio[0], w / w0 * ratio[1]), pad))
        return (np.ascontiguousarray(rgb), np.ascontiguousarray(ir),
                self.labels[index].copy(), shapes)
