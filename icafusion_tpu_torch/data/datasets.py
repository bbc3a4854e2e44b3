"""Paired RGB/IR detection data (the JAX package's data/datasets.py;
reference utils/datasets.py:690-1057).

RGB and IR file lists are discovered separately (a directory, a txt list or
a glob) and paired by index. Labels come from the RGB side: the
'visible'/'infrared'/'images' path component becomes 'labels' and the
extension '.txt'. Each label file is (n, 5) [cls, x, y, w, h], normalised,
validated as the reference's cache_labels validates it; with a cache_dir
the parsed labels are kept in one .npz keyed by a hash of the paths and
their mtimes. Train samples: mosaic (probability hyp.mosaic) or letterbox,
HSV jitter per modality, paired flips on one coin (datasets.py:948-1024).
Val samples: a square letterbox, scaleup=False. Images are decoded with
cv2, imported when an image is read.
"""

from __future__ import annotations

import glob
import hashlib
import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from icafusion_tpu_torch.config import HypConfig
from icafusion_tpu_torch.data.augment import (augment_hsv, letterbox,
                                              mosaic_pair, xywhn2xyxy,
                                              xyxy2xywhn)

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


def _list_hash(paths: Sequence[str]) -> str:
    h = hashlib.sha1()
    for p in paths:
        h.update(p.encode())
        try:
            h.update(str(os.path.getmtime(p)).encode())
        except OSError:
            pass
    return h.hexdigest()


class PairedDetectionDataset:
    """Index-aligned RGB/IR images and RGB-side labels.

    augment: train samples are augmented with ``hyp``; single_cls: every
    label becomes class 0 (the reference's --single-cls), after the cache,
    which stays class-full."""

    def __init__(self, path_rgb: str, path_ir: str, img_size: int = 640,
                 nc: Optional[int] = None, single_cls: bool = False,
                 hyp: Optional[HypConfig] = None, augment: bool = False,
                 cache_dir: Optional[str] = None):
        self.img_size = img_size
        self.nc, self.single_cls = nc, single_cls
        self.hyp = HypConfig() if hyp is None else hyp
        self.augment = augment
        self.files_rgb = discover_images(path_rgb)
        self.files_ir = discover_images(path_ir)
        if len(self.files_rgb) != len(self.files_ir):
            raise ValueError(f"paired counts differ: {len(self.files_rgb)} "
                             f"rgb vs {len(self.files_ir)} ir")
        self.label_files = [img2label_path(p) for p in self.files_rgb]
        self.labels = self._load_labels(cache_dir)
        if single_cls:
            for lab in self.labels:
                lab[:, 0] = 0
        self.indices = np.arange(len(self.files_rgb))

    def __len__(self):
        return len(self.files_rgb)

    def _load_labels(self, cache_dir: Optional[str]) -> List[np.ndarray]:
        """Parse (single_cls skips the class < nc check), or read the .npz
        cache and check the classes against this run's nc."""
        nc = None if self.single_cls else self.nc
        cache = None
        if cache_dir is not None:
            key = _list_hash(self.files_rgb + self.label_files)
            cache = Path(cache_dir) / f"labels_{key}.npz"
            if cache.is_file():
                with np.load(cache, allow_pickle=False) as z:
                    labels = [z[f"l{i}"] for i in range(len(self.files_rgb))]
                if nc is not None:
                    for lab, lp in zip(labels, self.label_files):
                        if len(lab) and lab[:, 0].max() >= nc:
                            raise ValueError(f"label class exceeds nc={nc} "
                                             f"in {lp} (cached labels)")
                return labels
        labels = [parse_label_file(p, nc) for p in self.label_files]
        if cache is not None:
            cache.parent.mkdir(parents=True, exist_ok=True)
            np.savez(cache, **{f"l{i}": l for i, l in enumerate(labels)})
        return labels

    def class_histogram(self) -> np.ndarray:
        nc = self.nc or int(max((l[:, 0].max() for l in self.labels
                                 if len(l)), default=0) + 1)
        h = np.zeros(nc, np.int64)
        for l in self.labels:
            if len(l):
                np.add.at(h, l[:, 0].astype(int), 1)
        return h

    def load_pair(self, index: int
                  ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
        """Decode one pair as HWC RGB uint8 and resize its longer side to
        img_size (datasets.py:1097-1125): INTER_AREA when shrinking without
        augmentation, else INTER_LINEAR. Returns (rgb, ir, native (h0,
        w0))."""
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
            interp = (cv2.INTER_AREA if r < 1 and not self.augment
                      else cv2.INTER_LINEAR)
            size = (int(w0 * r), int(h0 * r))
            out = [cv2.resize(img, size, interpolation=interp) for img in out]
        return out[0], out[1], (h0, w0)

    def train_sample(self, index: int, rng: np.random.Generator):
        """One pair as the reference's __getitem__ makes it
        (datasets.py:948-1024): (rgb, ir) HWC uint8 on the img_size square
        and labels (n, 5) [cls, xywh normalised]."""
        hyp = self.hyp
        if self.augment and rng.random() < hyp.mosaic:
            img_rgb, img_ir, t_xyxy = mosaic_pair(
                lambda i: self.load_pair(i)[:2], index, self.indices,
                self.img_size, lambda i: self.labels[i], rng, hyp)
        else:
            img_rgb, img_ir, _ = self.load_pair(index)
            h, w = img_rgb.shape[:2]
            img_rgb, ratio, pad = letterbox(img_rgb, self.img_size,
                                            scaleup=self.augment)
            img_ir, _, _ = letterbox(img_ir, self.img_size,
                                     scaleup=self.augment)
            lab = self.labels[index]
            t_xyxy = np.zeros((0, 5), np.float32)
            if lab.size:
                t_xyxy = np.empty_like(lab)
                t_xyxy[:, 0] = lab[:, 0]
                t_xyxy[:, 1:] = xywhn2xyxy(lab[:, 1:], ratio[0] * w,
                                           ratio[1] * h, padw=pad[0],
                                           padh=pad[1])
        if self.augment:
            augment_hsv(img_rgb, rng, hyp.hsv_h, hyp.hsv_s, hyp.hsv_v)
            augment_hsv(img_ir, rng, hyp.hsv_h, hyp.hsv_s, hyp.hsv_v)
        H, W = img_rgb.shape[:2]
        labels = np.zeros((len(t_xyxy), 5), np.float32)
        if len(t_xyxy):
            labels[:, 0] = t_xyxy[:, 0]
            labels[:, 1:] = xyxy2xywhn(t_xyxy[:, 1:], W, H)
        if self.augment:
            if rng.random() < hyp.flipud:
                img_rgb, img_ir = np.flipud(img_rgb), np.flipud(img_ir)
                if len(labels):
                    labels[:, 2] = 1 - labels[:, 2]
            if rng.random() < hyp.fliplr:
                img_rgb, img_ir = np.fliplr(img_rgb), np.fliplr(img_ir)
                if len(labels):
                    labels[:, 1] = 1 - labels[:, 1]
        return (np.ascontiguousarray(img_rgb), np.ascontiguousarray(img_ir),
                labels)

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
