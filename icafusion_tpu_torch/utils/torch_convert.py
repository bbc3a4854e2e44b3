"""Reference checkpoints in and out: the original PyTorch ICAFusion's
``.pt`` state dicts onto the port's modules, and the port's weights back
under the reference's names.

Counterpart of the JAX package's utils/torch_convert.py. The bridge is
utils/convert.flax_paths: a port tensor -> its flax path -> ``_translate``
-> the reference key, e.g. ``m20.crosstransformer0.crossatt.q_vis.weight``
-> ``model.20.crosstransformer.0.crossatt.que_proj_vis.weight``. The
reference and the port both hold conv kernels OIHW and linear weights
(out, in), so no value is transposed, only reshaped to the port tensor's
shape (a scalar gain stored as (1,)). The fusion block's ``coefficients``
(8,) are the reference's eight ``coefficient{1..8}.bias``. C3TR's 3-D
attention kernels have no reference counterpart in this table; they travel
in flax's layout, which is the port's (nn/layers.DenseGeneral), as the JAX
converter writes them.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from icafusion_tpu_torch.utils.convert import flax_paths

# child-name translations (flax name -> reference)
_NAME_MAP = {
    "q_vis": "que_proj_vis", "k_vis": "key_proj_vis", "v_vis": "val_proj_vis",
    "q_ir": "que_proj_ir", "k_ir": "key_proj_ir", "v_ir": "val_proj_ir",
    "out_vis": "out_proj_vis", "out_ir": "out_proj_ir",
    "ln_vis": "LN1", "ln_ir": "LN2",
    "mlp_ln": "LN2",
    "mlp_vis_fc1": "mlp_vis.0", "mlp_vis_fc2": "mlp_vis.2",
    "mlp_ir_fc1": "mlp_ir.0", "mlp_ir_fc2": "mlp_ir.2",
    "stem_conv": "layer.0", "stem_bn": "layer.1",
    "shortcut_conv": "shortcut.0", "shortcut_bn": "shortcut.1",
}
_LEAF_MAP = {"kernel": "weight", "scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}
_COEFFICIENTS = 8

# reference parameters that exist but are dead in its forward pass
# (yolo_test.py graphs never call them): CrossTransformerBlock's
# ln_input/ln_output/LN1 and its third unused `mlp` (common.py:701-724),
# plus torch bookkeeping buffers
_REF_DEAD_KEY = re.compile(
    r"(ln_input|ln_output|\.LN1\.|crosstransformer\.\d+\.mlp\.)|"
    r"num_batches_tracked$|anchors$|anchor_grid$")


def _translate(path: Tuple[str, ...]) -> str:
    """A flax path ('m20', 'crosstransformer0', 'crossatt', 'q_vis',
    'kernel') -> the reference key
    'model.20.crosstransformer.0.crossatt.que_proj_vis.weight'."""
    out = []
    for depth, tok in enumerate(path[:-1]):
        if depth == 0:
            m = re.fullmatch(r"m(\d+)", tok)
            if not m:
                raise ValueError(f"unexpected top-level token {tok}")
            out.append(f"model.{m.group(1)}")
            continue
        if tok in _NAME_MAP:
            out.append(_NAME_MAP[tok])
            continue
        m = re.fullmatch(r"crosstransformer(\d+)", tok)
        if m:
            out.append(f"crosstransformer.{m.group(1)}")
            continue
        m = re.fullmatch(r"m(\d+)", tok)
        if m:  # C3/CSP inner bottlenecks and Detect's conv list
            out.append(f"m.{m.group(1)}")
            continue
        m = re.fullmatch(r"r(\d+)", tok)
        if m:  # a repeated module (nn.Sequential)
            out.append(m.group(1))
            continue
        m = re.fullmatch(r"conv(\d+)", tok)
        if m and depth == 1:  # VGGblock convs: vggblock.{i}.0
            out.append(f"vggblock.{m.group(1)}.0")
            continue
        m = re.fullmatch(r"blk(\d+)", tok)
        if m:  # ResNet stage blocks
            out.append(f"layer.{m.group(1)}")
            continue
        out.append(tok)
    out.append(_LEAF_MAP.get(path[-1], path[-1]))
    return ".".join(out)


def _coefficient_keys(path: Tuple[str, ...]) -> List[str]:
    prefix = _translate(path[:-1] + ("x",)).rsplit(".", 1)[0]
    return [f"{prefix}.coefficient{k}.bias"
            for k in range(1, _COEFFICIENTS + 1)]


def convert_state_dict(state_dict: Dict[str, np.ndarray], model: nn.Module,
                       strict: bool = True) -> Tuple[nn.Module, List[str]]:
    """Fill ``model`` in place from a reference state dict (reference names
    -> arrays or tensors). Returns (model, the reference keys left unused,
    BatchNorm counters and Detect's anchors not counted). strict: raise on
    a port tensor whose reference key is missing; otherwise that tensor
    keeps its value (the fusion gains too, where the JAX converter
    raises)."""
    sd = {k: np.asarray(v.detach().cpu().float() if torch.is_tensor(v)
                        else v) for k, v in state_dict.items()}
    targets = model.state_dict(keep_vars=True)
    used = set()
    with torch.no_grad():
        for name, (_, path) in flax_paths(model).items():
            t = targets[name]
            coef = path[-1] == "coefficients"
            keys = _coefficient_keys(path) if coef else [_translate(path)]
            missing = [k for k in keys if k not in sd]
            if missing:
                # (the JAX converter raises on missing coefficients even
                # when not strict; a single-stream .pt has none)
                if strict:
                    raise KeyError(f"reference key {missing[0]} (for "
                                   f"{'/'.join(path)}) missing")
                continue
            if coef:
                v = np.asarray([np.asarray(sd[k], np.float32).reshape(())
                                for k in keys], np.float32)
            else:
                v = np.asarray(sd[keys[0]], np.float32)
            if v.size != t.numel():
                raise ValueError(f"{keys[0]}: {v.shape} does not fit "
                                 f"{name} {tuple(t.shape)}")
            used.update(keys)
            t.copy_(torch.from_numpy(np.ascontiguousarray(
                v.reshape(tuple(t.shape)))))
    unused = [k for k in sd if k not in used
              and not k.endswith("num_batches_tracked")
              and not k.endswith(("anchors", "anchor_grid"))]
    return model, unused


def remap_single_stream_to_two_stream(state_dict: Dict[str, np.ndarray],
                                      stream_offset: int = 10):
    """Copy the backbone keys model.{0..offset-1} to
    model.{offset..2*offset-1}, so that both towers start from the same
    single-stream weights (reference train.py:94-99)."""
    out = dict(state_dict)
    pat = re.compile(r"^model\.(\d+)\.(.+)$")
    for k, v in list(state_dict.items()):
        m = pat.match(k)
        if m and int(m.group(1)) < stream_offset:
            out[f"model.{int(m.group(1)) + stream_offset}.{m.group(2)}"] = v
    return out


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A reference .pt as {name: numpy array}, float tensors in float32
    (reference checkpoints hold float16). The EMA comes first, as in the
    reference's attempt_load (experimental.py:119): ckpt["ema"], else
    ckpt["model"], else the file itself. Takes the reference's full
    checkpoint dict, a bare nn.Module pickle or a plain state dict.

    torch.load runs with weights_only=False: the reference's checkpoint
    pickles its nn.Module and a hyp dict, which the weights-only unpickler
    refuses. Unpickling runs code, so load only files you trust. A pickled
    module unpickles only where the reference's own package imports."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model = ckpt
    if isinstance(ckpt, dict):
        # the full checkpoint layout; a plain state dict has neither key
        model = ckpt.get("ema") or ckpt.get("model") or ckpt
    sd = model.float().state_dict() if hasattr(model, "state_dict") else model
    out = {}
    for k, v in sd.items():
        if torch.is_tensor(v):
            v = v.detach().cpu()
            v = v.float() if v.is_floating_point() else v
            out[k] = v.numpy()
        else:
            out[k] = np.asarray(v)
    return out


def reverse_convert(model: nn.Module,
                    like: Optional[Dict[str, np.ndarray]] = None
                    ) -> Dict[str, np.ndarray]:
    """convert_state_dict's inverse: ``model``'s weights as a
    reference-named state dict of float32 numpy arrays (OIHW convs,
    (out, in) linears), which ``torch.save({"model": sd}, path)`` writes as
    a .pt that this package and the JAX package both read. ``like``: a
    reference state dict (e.g. of a freshly built reference model) to take
    shapes from and to check coverage against; its dead keys (_REF_DEAD_KEY)
    are copied from it, so that a strict load_state_dict there round-trips.
    """
    tensors = model.state_dict()
    sd: Dict[str, np.ndarray] = {}
    for name, (_, path) in flax_paths(model).items():
        v = tensors[name].detach().to("cpu", torch.float32).numpy()
        if path[-1] == "coefficients":
            for k, key in enumerate(_coefficient_keys(path)):
                sd[key] = v[k].reshape(1).copy()
            continue
        sd[_translate(path)] = v.copy()
    if like is not None:
        missing = []
        for k, tmpl in like.items():
            if k in sd:
                if sd[k].shape != tuple(np.shape(tmpl)):
                    sd[k] = sd[k].reshape(np.shape(tmpl))
            elif _REF_DEAD_KEY.search(k):
                sd[k] = np.asarray(tmpl, np.float32).copy()
            else:
                missing.append(k)
        if missing:
            raise KeyError(f"reverse_convert did not produce {missing[:5]} "
                           f"(+{max(0, len(missing) - 5)} more)")
    return sd
