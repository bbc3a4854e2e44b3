"""Grad-CAM saliency for the two-stream detector.

Counterpart of the JAX package's models/gradcam.py (reference
models/gradcam.py:6-84, YOLOV5GradCAM): saliency = ReLU(sum_k alpha_k A_k)
with alpha_k the spatial mean of d(score)/d(A_k), where A is a chosen
layer's activation and the score is the raw class logit of each image's
strongest detection (Detect's logits stream). As in the JAX package, A is
captured on one forward, then re-enters the model through ``overrides``
on a second one, which is differentiated with respect to it.

On the card the gradient crosses the hand-written float kernels through
their autograd paths (kernels/cross_attention.py, kernels/packed_conv.py),
whose backward is the plain version's vjp. An int8 model has no gradient
(kernels/conv_int8.py raises).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from icafusion_tpu_torch.nn.fusion import resize_linear


def gradcam_saliency(model, rgb, ir, layer: int,
                     class_idx: Optional[int] = None,
                     upsample_to: Optional[Tuple[int, int]] = None):
    """Saliency maps (B, h, w) in [0, 1] of ``layer``'s NCHW activation for
    the strongest detection's class score (or ``class_idx``'s) of each
    image; ``upsample_to`` (H, W) resizes them as jax.image.resize
    "linear" does. rgb, ir: (B, 3, H, W) float in [0, 1]. ``model`` is in
    eval mode; its parameters get no gradient."""
    with torch.no_grad():
        _, caps = model(rgb, ir, capture=(layer,))
    act = caps[layer].detach().requires_grad_(True)
    with torch.enable_grad():
        pred, logits = model(rgb, ir, logits=True, overrides={layer: act})
        rows = torch.arange(pred.shape[0], device=pred.device)
        blog = logits[rows, pred[..., 4].argmax(dim=1)]      # (B, nc)
        cls = (blog.argmax(dim=-1) if class_idx is None
               else torch.full_like(rows, class_idx))
        (grads,) = torch.autograd.grad(blog[rows, cls].sum(), act)
    with torch.no_grad():
        alpha = grads.mean(dim=(2, 3), keepdim=True)          # GAP over h, w
        sal = torch.relu((alpha * act).sum(dim=1))            # (B, h, w)
        sal = sal / (sal.amax(dim=(1, 2), keepdim=True) + 1e-8)
        if upsample_to is not None:
            sal = resize_linear(sal[:, None], *upsample_to)[:, 0]
    return sal


def default_cam_layers(cfg) -> Tuple[int, ...]:
    """Detect's input layers: the three head C3s the reference visualises
    (gradcam_visual.py:10-12)."""
    from icafusion_tpu_torch.models.assembler import detect_layer
    return tuple(detect_layer(cfg).f)
