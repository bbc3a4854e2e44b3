"""Letterboxing of host images (the val side of the JAX package's
data/augment.py; reference utils/datasets.py:1404-1444). cv2 is imported
when an image is resized."""

from __future__ import annotations


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
