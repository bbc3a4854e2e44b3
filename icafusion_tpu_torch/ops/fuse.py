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
ResNet50 tower). Not wired into serving, as in the JAX package: the conv
would take a bias, which cuDNN adds in a pass of its own.

``fold_bn_act`` is the serving engine's fold (serve/engine.py: _place): it
leaves the weights and the state_dict as they are and gives each float
``Conv`` a folded activation child holding the BatchNorm's float32 affine
(nn/layers.py: FoldedSiLU, FoldedIdentity). In eval mode such a Conv runs
its conv and then one in-place pass of the affine and the activation
(kernels/bn_act.py), or its fused 64-channel kernel on the same affine.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from icafusion_tpu_torch.kernels.bn_act import check_affine
from icafusion_tpu_torch.nn.layers import (BN_EPS, Conv, FoldedIdentity,
                                          FoldedSiLU, bn_affine)

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


FOLDED = (FoldedSiLU, FoldedIdentity)


@torch.no_grad()
def refold(conv: Conv, incompatible_keys=None) -> None:
    """A folded Conv's (scale, bias) anew from its BatchNorm, in place. The
    load_state_dict post-hook of every Conv that ``fold_bn_act`` folds."""
    if isinstance(conv.act, FOLDED):
        scale, bias = bn_affine(conv.bn)
        conv.act.scale.copy_(scale)
        conv.act.bias.copy_(bias)


@torch.no_grad()
def fold_bn_act(model: nn.Module) -> nn.Module:
    """Give every ``Conv`` of ``model`` off the int8 path (``w8`` unset)
    its BatchNorm's float32 (scale, bias), in a ``FoldedSiLU`` or
    ``FoldedIdentity`` in place of its activation; a Conv folded before
    takes them anew. In place; returns ``model``. Raises where a conv's
    dtype is one the epilogue does not take (kernels/bn_act.py:
    check_affine). Train mode is unchanged (the BatchNorm runs with batch
    statistics). The fold is made again when a folded Conv loads a
    state_dict (``refold``); a BatchNorm changed any other way (written in
    place, or by a train-mode forward) is seen in eval mode only once
    ``fold_bn_act`` runs again."""
    for m in model.modules():
        if not isinstance(m, Conv) or m.w8 is not None:
            continue
        if isinstance(m.act, FOLDED):
            refold(m)
            continue
        scale, bias = (t.contiguous() for t in bn_affine(m.bn))
        check_affine(scale, bias, m.conv.out_channels, m.conv.weight.dtype)
        folded = (FoldedSiLU if isinstance(m.act, nn.SiLU)
                  else FoldedIdentity)(scale, bias)
        folded.train(m.act.training)
        m.act = folded
        m.register_load_state_dict_post_hook(refold)
    return model
