"""Conv + BatchNorm folding, a transform of an inference model.

Counterpart of the JAX package's ops/fuse.py (``fold_conv_bn``; reference
utils/torch_utils.py:182-202 fuse_conv_and_bn): each BatchNorm's affine is
absorbed into the conv before it, and the BatchNorm is set to an exact
identity, so the module graph stays as it is:

    s = gamma / sqrt(var + BN_EPS)
    conv.weight *= s (per output channel)
    gamma = 1, beta = beta - mean * s, mean = 0, var = 1 - BN_EPS

The arithmetic is the JAX package's, in numpy float32, so the folded
weights equal its folded variables. The pairs are found by name as there:
``conv``/``bn`` (Conv), ``conv1``/``bn1`` .. ``conv3``/``bn3``,
``stem_conv``/``stem_bn`` and ``shortcut_conv``/``shortcut_bn`` (the
ResNet50 tower). Not wired into serving, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from icafusion_tpu_torch.nn.layers import BN_EPS

PAIRS = {"bn": "conv", "bn1": "conv1", "bn2": "conv2", "bn3": "conv3",
         "stem_bn": "stem_conv", "shortcut_bn": "shortcut_conv"}


@torch.no_grad()
def fold_conv_bn(model: nn.Module) -> nn.Module:
    """Fold every (conv, BatchNorm) pair of ``model`` in place; returns it."""
    for m in model.modules():
        for bn_name, conv_name in PAIRS.items():
            bn, conv = getattr(m, bn_name, None), getattr(m, conv_name, None)
            if not (isinstance(bn, nn.BatchNorm2d)
                    and isinstance(conv, nn.Conv2d)):
                continue
            f32 = lambda t: t.detach().cpu().numpy().astype(np.float32)
            mean, var = f32(bn.running_mean), f32(bn.running_var)
            gamma, beta = f32(bn.weight), f32(bn.bias)
            s = gamma / np.sqrt(var + np.float32(BN_EPS))
            w = f32(conv.weight) * s[:, None, None, None]
            put = lambda t, v: t.copy_(torch.from_numpy(v))
            put(conv.weight, w)
            put(bn.weight, np.ones_like(gamma))
            put(bn.bias, beta - mean * s)
            put(bn.running_mean, np.zeros_like(mean))
            put(bn.running_var, np.ones_like(var) - np.float32(BN_EPS))
    return model
