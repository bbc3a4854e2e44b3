"""Carry flax variable trees of the JAX package into the port's modules and
back.

The port's modules carry the flax module names, so a flax leaf at
``params/m20/crosstransformer0/crossatt/q_vis/kernel`` fills the port tensor
``m20.crosstransformer0.crossatt.q_vis.weight``. ``flax_paths`` is the one
table of that correspondence: a conv or dense ``weight`` is a flax
``kernel``, a BatchNorm or LayerNorm ``weight`` a ``scale``,
``running_mean``/``running_var`` are ``batch_stats`` ``mean``/``var``, and
the rest keep their names. Layouts change as the JAX package's
utils/torch_convert.py:177-185 changes them: conv kernels HWIO <-> OIHW,
dense kernels (in, out) <-> (out, in), 3-D kernels (C3TR's attention)
unchanged. The same moves apply to any tensor
shaped like a parameter (an optimizer's momentum, Adam's m and v).

The optional ``quant`` collection (utils/quantize.py) sits on the modules
with int8 buffers: a Conv's ``w8`` is HWIO in flax and (Cout, kh, kw, Cin)
in the port, a QLinear's (in, out) and (out, in); ``s_w`` and ``s_in`` keep
their shapes.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

COLLECTIONS = ("params", "batch_stats")
QUANT = "quant"
FlaxPath = Tuple[str, Tuple[str, ...]]      # (collection, path)

_NORMS = (nn.BatchNorm2d, nn.LayerNorm)
_KERNELS = (nn.Conv2d, nn.Linear)


def flax_paths(model: nn.Module) -> Dict[str, FlaxPath]:
    """State-dict name -> (collection, flax path) of every parameter and
    BatchNorm statistic of ``model`` (``num_batches_tracked`` has no flax
    counterpart and is left out)."""
    table = {}
    for prefix, m in model.named_modules():
        path = tuple(prefix.split(".")) if prefix else ()
        for name, _ in m.named_parameters(recurse=False):
            leaf = name
            if name == "weight" and isinstance(m, _KERNELS):
                leaf = "kernel"
            elif name == "weight" and isinstance(m, _NORMS):
                leaf = "scale"
            table[".".join(path + (name,))] = ("params", path + (leaf,))
        if isinstance(m, nn.BatchNorm2d):
            for name, leaf in (("running_mean", "mean"),
                               ("running_var", "var")):
                table[".".join(path + (name,))] = ("batch_stats",
                                                   path + (leaf,))
    return table


def to_flax_layout(arr: np.ndarray, leaf: str) -> np.ndarray:
    """A port tensor's values in flax layout (conv and dense kernels
    transposed; the 3-D attention kernels of nn/layers.DenseGeneral are
    held in flax's layout already)."""
    if leaf == "kernel" and arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)
    if leaf == "kernel" and arr.ndim == 2:
        return arr.T
    return arr


def from_flax_layout(arr: np.ndarray, leaf: str) -> np.ndarray:
    if leaf == "kernel" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if leaf == "kernel" and arr.ndim == 2:
        return arr.T
    return arr


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _set(tree: dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def flax_tree(model: nn.Module, tensors: Mapping[str, torch.Tensor],
              collection: str = "params") -> dict:
    """Nested dict of float32 numpy arrays in flax layout, one leaf for each
    tensor of ``tensors`` (state-dict name -> tensor shaped like that
    entry) whose name lies in ``collection``."""
    out: dict = {}
    for name, (coll, path) in flax_paths(model).items():
        if coll == collection:
            # a copy: the tensor may change after (in-place optimizer
            # steps, a checkpoint written on a thread)
            arr = tensors[name].detach().to("cpu", torch.float32,
                                            copy=True).numpy()
            _set(out, path, np.ascontiguousarray(to_flax_layout(arr,
                                                                path[-1])))
    return out


def torch_tensors(model: nn.Module, tree: Mapping,
                  collection: str = "params") -> Dict[str, np.ndarray]:
    """The inverse of flax_tree: state-dict name -> numpy array in the port's
    layout. Strict: raises on a leaf with no port tensor, on a wrong shape
    and on a port tensor the tree does not fill."""
    by_path = {p: n for n, (c, p) in flax_paths(model).items()
               if c == collection}
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    out = {}
    for path, arr in _leaves(tree):
        if path not in by_path:
            raise KeyError(f"flax leaf {collection}/{'/'.join(path)} has no "
                           "port tensor")
        name = by_path[path]
        arr = from_flax_layout(arr, path[-1])
        if tuple(arr.shape) != shapes[name]:
            raise ValueError(f"{name}: flax {arr.shape} vs port "
                             f"{shapes[name]}")
        out[name] = arr
    missing = sorted(set(by_path.values()) - set(out))
    if missing:
        raise KeyError(f"{len(missing)} port tensors not filled, e.g. "
                       f"{missing[:5]}")
    return out


def _quant_modules(model: nn.Module) -> Dict[Tuple[str, ...], nn.Module]:
    """Flax path -> module, for every module that can hold int8 weights
    (a Conv or a QLinear: a ``w8`` buffer slot)."""
    return {tuple(name.split(".")) if name else (): m
            for name, m in model.named_modules() if "w8" in m._buffers}


def quant_tree(model: nn.Module) -> dict:
    """The ``quant`` collection of ``model`` in flax layout (numpy): {path:
    {"w8", "s_w", "s_in"}} for each int8 Conv, {path: {"w8", "s_w"}} for
    each int8 QLinear; {} for a float model."""
    out: dict = {}
    for path, m in _quant_modules(model).items():
        if m.w8 is None:
            continue
        w8 = m.w8.cpu().numpy()
        leaves = {"w8": w8.transpose(1, 2, 3, 0) if w8.ndim == 4 else w8.T,
                  "s_w": m.s_w.cpu().numpy()}
        if getattr(m, "s_in", None) is not None:
            leaves["s_in"] = m.s_in.cpu().numpy()
        for k, v in leaves.items():     # (np.ascontiguousarray makes 0-d 1-d)
            _set(out, path + (k,), np.array(v, order="C"))
    return out


def load_quant_tree(model: nn.Module, tree: Mapping) -> nn.Module:
    """Set ``model``'s int8 buffers from a flax ``quant`` collection; every
    other module's are cleared. Strict: raises on a path that is no Conv
    or QLinear, on missing or unknown leaves and on wrong shapes."""
    mods = _quant_modules(model)
    by_module: Dict[Tuple[str, ...], dict] = {}
    for path, arr in _leaves(tree):
        by_module.setdefault(path[:-1], {})[path[-1]] = arr
    for path in by_module:
        if path not in mods:
            raise KeyError(f"quant/{'/'.join(path)} has no int8 module in "
                           "the port")
    for path, m in mods.items():
        leaves = by_module.get(path)
        conv = getattr(m, "conv", None)
        want = ("s_in", "s_w", "w8") if conv is not None else ("s_w", "w8")
        if leaves is not None and tuple(sorted(leaves)) != want:
            raise KeyError(f"quant/{'/'.join(path)}: leaves {sorted(leaves)}"
                           f", want {list(want)}")
        if conv is not None:
            weight = conv.weight
            shape = (weight.shape[2], weight.shape[3], weight.shape[1],
                     weight.shape[0])
        else:
            weight = m.weight
            shape = (weight.shape[1], weight.shape[0])
        dev = weight.device
        if leaves is None:
            m.w8 = m.s_w = None
            if conv is not None:
                m.s_in = None
            continue
        w8 = np.asarray(leaves["w8"])
        if w8.shape != shape or w8.dtype != np.int8:
            raise ValueError(f"quant/{'/'.join(path)}/w8: {w8.shape} "
                             f"{w8.dtype}, want {shape} int8")
        w8 = w8.transpose(3, 0, 1, 2) if w8.ndim == 4 else w8.T
        m.w8 = torch.from_numpy(np.ascontiguousarray(w8)).to(dev)
        m.s_w = torch.from_numpy(np.asarray(leaves["s_w"], np.float32)
                                 .reshape(shape[-1]).copy()).to(dev)
        if conv is not None:
            s_in = np.asarray(leaves["s_in"], np.float32)
            if s_in.shape not in ((), (shape[2],)):
                raise ValueError(f"quant/{'/'.join(path)}/s_in: {s_in.shape}")
            m.s_in = torch.from_numpy(s_in.copy()).to(dev)
    return model


def to_jax_variables(model: nn.Module) -> dict:
    """{"params": ..., "batch_stats": ...} of ``model`` as the JAX package
    holds them: nested dicts of float32 numpy arrays in flax layout, and
    "quant" where the model holds int8 weights. The inverse of
    load_jax_variables."""
    sd = model.state_dict()
    out = {c: flax_tree(model, sd, c) for c in COLLECTIONS}
    quant = quant_tree(model)
    if quant:
        out[QUANT] = quant
    return out


def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Fill every tensor of ``model``'s state dict from ``variables``
    ({"params": ..., "batch_stats": ...}, nested dicts of arrays, and
    optionally "quant", which sets the int8 buffers: load_quant_tree).
    Strict: raises on an unknown collection, on a leaf with no port tensor
    or of the wrong shape, and on a port tensor left unfilled (BatchNorm's
    ``num_batches_tracked`` counter has no flax counterpart and is not
    counted)."""
    unknown = set(variables) - set(COLLECTIONS) - {QUANT}
    if unknown:
        raise KeyError(f"unknown variable collections {sorted(unknown)}")
    targets = model.state_dict(keep_vars=True)
    with torch.no_grad():
        for coll in COLLECTIONS:
            for name, arr in torch_tensors(model, variables.get(coll, {}),
                                           coll).items():
                targets[name].copy_(torch.tensor(np.ascontiguousarray(arr)))
    return load_quant_tree(model, variables.get(QUANT, {}))
