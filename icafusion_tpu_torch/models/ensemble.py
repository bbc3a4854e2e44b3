"""Inference over an ensemble of checkpoints.

Counterpart of the JAX package's models/ensemble.py (reference
models/experimental.py:98-134, Ensemble and attempt_load of a weights
list): each member's decoded predictions are concatenated along the
candidate axis, and NMS runs over the union.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def ensemble_predict(models: Sequence[torch.nn.Module], rgb, ir):
    """(pred (B, sum N, 5 + nc), logits (B, sum N, nc)) over all members,
    in member order; rgb, ir: (B, 3, H, W) float on the members' device."""
    outs = [m(rgb, ir, logits=True) for m in models]
    return (torch.cat([p for p, _ in outs], dim=1),
            torch.cat([l for _, l in outs], dim=1))


def load_ensemble(cfg_specs: List[str], weights_list: List[str], nc=None,
                  device: Optional[str] = None) -> List[torch.nn.Module]:
    """attempt_load for a weights list (experimental.py:113-134): each
    (config, checkpoint) pair through cli/_common.load_model_for_inference,
    in eval mode on ``device`` (default CUDA)."""
    from icafusion_tpu_torch.cli._common import load_model_for_inference
    from icafusion_tpu_torch.utils.general import resolve_device
    dev = resolve_device(device, "load_ensemble")
    return [load_model_for_inference(cfg, w, nc=nc)[1].eval().to(dev)
            for cfg, w in zip(cfg_specs, weights_list)]
