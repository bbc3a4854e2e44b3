"""Carry a flax variable tree of the JAX package into the port's modules.

The port's modules carry the flax module names, so a flax leaf at
``params/m20/crosstransformer0/crossatt/q_vis/kernel`` fills the port tensor
``m20.crosstransformer0.crossatt.q_vis.weight``. Leaf names map as
kernel -> weight, scale -> weight, mean -> running_mean, var -> running_var;
the rest keep their names. Layouts change as the JAX package's
utils/torch_convert.py:177-185 changes them: conv kernels HWIO -> OIHW,
dense kernels (in, out) -> (out, in).
"""

from __future__ import annotations

from typing import Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
         "var": "running_var"}
COLLECTIONS = ("params", "batch_stats")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Fill every tensor of ``model``'s state dict from ``variables``
    ({"params": ..., "batch_stats": ...}, nested dicts of arrays). Strict:
    raises on an unknown collection, on a leaf with no port tensor or of the
    wrong shape, and on a port tensor left unfilled (BatchNorm's
    ``num_batches_tracked`` counter has no flax counterpart and is not
    counted)."""
    unknown = set(variables) - set(COLLECTIONS)
    if unknown:
        raise KeyError(f"unknown variable collections {sorted(unknown)}")
    targets = {k: v for k, v in model.state_dict(keep_vars=True).items()
               if not k.endswith("num_batches_tracked")}
    filled = set()
    for coll in COLLECTIONS:
        for path, arr in _leaves(variables.get(coll, {})):
            name = ".".join(path[:-1] + (_LEAF.get(path[-1], path[-1]),))
            if name not in targets:
                raise KeyError(f"flax leaf {coll}/{'/'.join(path)} has no "
                               f"port tensor {name!r}")
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            t = targets[name]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{name}: flax {arr.shape} vs port "
                                 f"{tuple(t.shape)}")
            with torch.no_grad():
                t.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            filled.add(name)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"{len(missing)} port tensors not filled, e.g. "
                       f"{missing[:5]}")
    return model
