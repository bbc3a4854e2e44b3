"""Host-side paired augmentation (numpy/cv2) with an explicit RNG: the
JAX package's data/augment.py (reference utils/datasets.py), kept in numpy,
so that the same np.random.Generator gives the same bytes.

Both modalities take one random draw (the multispectral invariant):

- letterbox                 (datasets.py:1404-1444)
- paired 4-mosaic geometry  (datasets.py:1208-1309)
- joint random perspective  (datasets.py:1535-1630: one matrix for both
                             images and one label set)
- HSV jitter                (datasets.py:1129-1140: a draw per modality)
- box_candidates filter     (datasets.py:1633-1638)

Images are HWC RGB uint8. cv2 is imported where an image is transformed.
"""

from __future__ import annotations

import math

import numpy as np


def xywhn2xyxy(x, w, h, padw=0.0, padh=0.0):
    """Normalised xywh (n, 4) -> pixel xyxy."""
    y = np.empty_like(x, dtype=np.float32)
    y[:, 0] = w * (x[:, 0] - x[:, 2] / 2) + padw
    y[:, 1] = h * (x[:, 1] - x[:, 3] / 2) + padh
    y[:, 2] = w * (x[:, 0] + x[:, 2] / 2) + padw
    y[:, 3] = h * (x[:, 1] + x[:, 3] / 2) + padh
    return y


def xyxy2xywhn(x, w, h):
    """Pixel xyxy (n, 4) -> normalised xywh."""
    y = np.empty_like(x, dtype=np.float32)
    y[:, 0] = ((x[:, 0] + x[:, 2]) / 2) / w
    y[:, 1] = ((x[:, 1] + x[:, 3]) / 2) / h
    y[:, 2] = (x[:, 2] - x[:, 0]) / w
    y[:, 3] = (x[:, 3] - x[:, 1]) / h
    return y


def letterbox(img, new_shape=640, color=(114, 114, 114), scaleup=True,
              auto=False, stride=32):
    """Aspect-preserving resize and centre pad of an HWC uint8 image to
    exactly new_shape (int or (h, w)), with the reference's +-0.1 rounding
    of the pad. auto=True pads only to the next stride multiple. Returns
    (image, (r, r), (dw, dh))."""
    import cv2
    shape = img.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    ratio = (r, r)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))
    pw, ph = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:
        pw, ph = pw % stride, ph % stride
    dw, dh = pw / 2, ph / 2
    if shape[::-1] != new_unpad:
        img = cv2.resize(img, new_unpad, interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    img = cv2.copyMakeBorder(img, top, bottom, left, right,
                             cv2.BORDER_CONSTANT, value=color)
    return img, ratio, (dw, dh)


def augment_hsv(img, rng: np.random.Generator, hgain=0.015, sgain=0.7,
                vgain=0.4):
    """In-place HSV LUT jitter of an HWC RGB uint8 image."""
    import cv2
    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    x = np.arange(0, 256, dtype=np.int16)
    lut_hue = ((x * r[0]) % 180).astype(np.uint8)
    lut_sat = np.clip(x * r[1], 0, 255).astype(np.uint8)
    lut_val = np.clip(x * r[2], 0, 255).astype(np.uint8)
    img_hsv = cv2.merge((cv2.LUT(hue, lut_hue), cv2.LUT(sat, lut_sat),
                         cv2.LUT(val, lut_val)))
    cv2.cvtColor(img_hsv, cv2.COLOR_HSV2RGB, dst=img)


def box_candidates(box1, box2, wh_thr=2, ar_thr=20, area_thr=0.1,
                   eps=1e-16):
    """Boxes that survive augmentation; box1, box2 (4, n)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr))


def random_perspective_pair(img_rgb, img_ir, targets, rng: np.random.Generator,
                            degrees=0.0, translate=0.1, scale=0.5, shear=0.0,
                            perspective=0.0, border=(0, 0)):
    """One sampled affine/perspective matrix applied to both modalities and
    the one label set. targets: (n, 5) [cls, x1, y1, x2, y2] pixels."""
    import cv2
    height = img_rgb.shape[0] + border[0] * 2
    width = img_rgb.shape[1] + border[1] * 2

    C = np.eye(3)
    C[0, 2] = -img_rgb.shape[1] / 2
    C[1, 2] = -img_rgb.shape[0] / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height
    M = T @ S @ R @ P @ C

    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        gray = (114, 114, 114)
        if perspective:
            img_rgb = cv2.warpPerspective(img_rgb, M, dsize=(width, height),
                                          borderValue=gray)
            img_ir = cv2.warpPerspective(img_ir, M, dsize=(width, height),
                                         borderValue=gray)
        else:
            img_rgb = cv2.warpAffine(img_rgb, M[:2], dsize=(width, height),
                                     borderValue=gray)
            img_ir = cv2.warpAffine(img_ir, M[:2], dsize=(width, height),
                                    borderValue=gray)

    n = len(targets)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = targets[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = box_candidates(box1=targets[:, 1:5].T * s, box2=new.T,
                              area_thr=0.10)
        targets = targets[keep].copy()
        targets[:, 1:5] = new[keep]
    return img_rgb, img_ir, targets


def _tile_span(center: int, extent: int, limit: int, after: bool):
    """1-D placement of one mosaic tile against the centre line: after=False
    ends the tile at the centre (source right/bottom-aligned), after=True
    starts it there (source left/top-aligned). Returns (canvas_lo,
    canvas_hi, src_lo, src_hi)."""
    if after:
        lo, hi = center, min(center + extent, limit)
        return lo, hi, 0, hi - lo
    lo, hi = max(center - extent, 0), center
    return lo, hi, extent - (hi - lo), extent


def mosaic_pair(load_fn, index, all_indices, img_size: int,
                labels_getter, rng: np.random.Generator, hyp):
    """Paired 4-tile mosaic and joint perspective. load_fn(i) -> (rgb, ir),
    HWC RGB uint8, longer side already img_size; labels_getter(i) -> (n, 5)
    [cls, xywh normalised]. Returns (rgb, ir, targets xyxy in pixels) on an
    img_size square."""
    s = img_size
    border = (-s // 2, -s // 2)
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    indices = [index] + [all_indices[rng.integers(len(all_indices))]
                         for _ in range(3)]
    labels4 = []
    img4_rgb = np.full((s * 2, s * 2, 3), 114, np.uint8)
    img4_ir = np.full((s * 2, s * 2, 3), 114, np.uint8)
    for i, idx in enumerate(indices):
        img_rgb, img_ir = load_fn(idx)
        h, w = img_rgb.shape[:2]
        # quadrant i: bit 0 = right of the centre, bit 1 = below it
        cx0, cx1, sx0, sx1 = _tile_span(xc, w, 2 * s, after=bool(i & 1))
        cy0, cy1, sy0, sy1 = _tile_span(yc, h, 2 * s, after=bool(i & 2))
        img4_rgb[cy0:cy1, cx0:cx1] = img_rgb[sy0:sy1, sx0:sx1]
        img4_ir[cy0:cy1, cx0:cx1] = img_ir[sy0:sy1, sx0:sx1]
        padw, padh = cx0 - sx0, cy0 - sy0
        lab = labels_getter(idx).copy()
        if lab.size:
            out = np.empty_like(lab, dtype=np.float32)
            out[:, 0] = lab[:, 0]
            out[:, 1:] = xywhn2xyxy(lab[:, 1:], w, h, padw, padh)
            labels4.append(out)
    targets = (np.concatenate(labels4, 0) if labels4
               else np.zeros((0, 5), np.float32))
    if targets.size:
        np.clip(targets[:, 1:], 0, 2 * s, out=targets[:, 1:])
    return random_perspective_pair(
        img4_rgb, img4_ir, targets, rng, degrees=hyp.degrees,
        translate=hyp.translate, scale=hyp.scale, shear=hyp.shear,
        perspective=hyp.perspective, border=border)


def shift_augment(img, rng: np.random.Generator, max_shift: int = 10,
                  fill: int = 114):
    """IR misalignment (datasets.py:1061-1078, shipped off): translate by
    0..max_shift px in a random diagonal direction, gray at the vacated
    edges."""
    dx = int(rng.integers(0, max_shift + 1)) * (1 if rng.random() < 0.5 else -1)
    dy = int(rng.integers(0, max_shift + 1)) * (1 if rng.random() < 0.5 else -1)
    h, w = img.shape[:2]
    out = np.full_like(img, fill)
    sy, sx = slice(max(dy, 0), h + min(dy, 0)), slice(max(dx, 0), w + min(dx, 0))
    ty, tx = slice(max(-dy, 0), h + min(-dy, 0)), slice(max(-dx, 0), w + min(-dx, 0))
    out[ty, tx] = img[sy, sx]
    return out


def hist_equalize(img, clahe: bool = True):
    """Equalise the luma channel of an HWC RGB uint8 image
    (datasets.py:1143-1151)."""
    import cv2
    yuv = cv2.cvtColor(img, cv2.COLOR_RGB2YUV)
    if clahe:
        c = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
        yuv[:, :, 0] = c.apply(yuv[:, :, 0])
    else:
        yuv[:, :, 0] = cv2.equalizeHist(yuv[:, :, 0])
    return cv2.cvtColor(yuv, cv2.COLOR_YUV2RGB)
