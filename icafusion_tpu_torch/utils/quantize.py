"""Post-training int8 W8A8 quantization for serving.

Counterpart of the JAX package's utils/quantize.py, with the same scheme
and the same numbers:

- per-Conv static symmetric quantization (zero point 0): int8 weights with
  per-output-channel scales, int8 activations with per-input-channel scales
  folded into the weights before their own quantization, calibrated from
  representative batches (absmax of each Conv input);
- quantize and dequantize happen inside each Conv (nn/layers.py: Conv, its
  int8 path runs kernels/conv_int8.py), so Concat, Add, SPPF, the fusion
  blocks and Detect stay in the model's float dtype;
- optional weight-only int8 for the fusion transformer's output
  projections and MLPs (nn/fusion.py: QLinear).

    calib = calibrate(model, [(rgb1, ir1), (rgb2, ir2), ...])
    quantize_model(model, calib, skip=detect_feeder_skip(model.cfg))

``calibrate`` runs the model where it lies, in its own dtype; its result is
a nested dict keyed by the flax module path (``{"m3": {"cv1": {"absmax":
...}}}``), the JAX package's calib collection. ``quantize_model`` computes
from the float32 weights in numpy, step by step as the JAX
``quantize_variables`` does, so that ``w8`` equals the JAX ``w8``, and fills
each eligible Conv's buffers in place. ``save_calibration`` and
``load_calibration`` read and write the JAX package's ``.calib`` artifact
(flax msgpack of ``{"key": json, "calib": tree}``) with the port's own
msgpack code, so a file written by either package loads in the other.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from icafusion_tpu_torch.nn.fusion import QLinear
from icafusion_tpu_torch.nn.layers import Conv
from icafusion_tpu_torch.utils.convert import _set
from icafusion_tpu_torch.utils.convert import quant_tree  # noqa: F401
from icafusion_tpu_torch.utils.general import not_ported

# the JAX package's version string: a .calib of another version is ignored
QUANT_SCHEME_VERSION = "2-perchannel-fold"


def _path(name: str) -> Tuple[str, ...]:
    return tuple(name.split(".")) if name else ()


def _get(tree, path):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _nhwc(a, device, dtype) -> torch.Tensor:
    """An (n, H, W, 3) float batch in [0, 1] as the model's NCHW input on
    its device and in its dtype (channels_last, as the engine feeds it)."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(device).permute(
        0, 3, 1, 2).to(dtype)


@torch.inference_mode()
def calibrate(model, batches: Iterable[Tuple]) -> dict:
    """Run eval forwards of ``model`` on (rgb, ir) batches, (n, H, W, 3)
    float in [0, 1] (numpy or tensors), recording each float Conv's input
    per-channel max |x| in fp32, reduced by max over the batches. A Conv
    already quantized records nothing (its int8 path runs), as in the JAX
    package. Returns the calib tree of numpy float32 arrays."""
    p = next(m.weight for m in model.modules()
             if isinstance(m, torch.nn.Conv2d))
    convs = [(name, m) for name, m in model.named_modules()
             if isinstance(m, Conv)]
    was_training = model.training
    model.eval()
    for _, m in convs:
        m.record, m.absmax = True, None
    try:
        n = 0
        for rgb, ir in batches:
            model(_nhwc(rgb, p.device, p.dtype), _nhwc(ir, p.device, p.dtype))
            n += 1
        if n == 0:
            raise ValueError("calibrate() needs at least one batch")
        tree: dict = {}
        for name, m in convs:
            if m.absmax is not None:
                _set(tree, _path(name) + ("absmax",),
                     m.absmax.cpu().numpy().astype(np.float32))
    finally:
        for _, m in convs:
            m.record, m.absmax = False, None
        model.train(was_training)
    return tree


def calibration_key(ckpt_path: Optional[str] = None, merge: int = 0,
                    extra: Optional[dict] = None) -> dict:
    """Identity of a calibration artifact: scheme version, the checkpoint
    file's sha1, the stream-merge count, and caller entries (canvas,
    calibration set), as the JAX package keys it."""
    key = {"scheme": QUANT_SCHEME_VERSION, "merge": int(merge)}
    if ckpt_path:
        h = hashlib.sha1()
        with open(ckpt_path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        key["ckpt_sha1"] = h.hexdigest()
    if extra:
        key.update(extra)
    return key


def save_calibration(path, calib: dict, key: dict) -> None:
    """Write the versioned artifact: msgpack of {key json, absmax tree}."""
    from icafusion_tpu_torch.utils.checkpoint import msgpack_serialize
    payload = {"key": json.dumps(key, sort_keys=True), "calib": calib}
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(p.suffix + ".tmp")
    tmp.write_bytes(msgpack_serialize(payload))
    tmp.replace(p)


def load_calibration(path, key: dict) -> Optional[dict]:
    """The artifact's calib tree if the file exists, reads, and carries
    exactly ``key``; None otherwise (the caller calibrates afresh)."""
    from icafusion_tpu_torch.utils.checkpoint import msgpack_restore
    p = Path(path)
    if not p.is_file():
        return None
    try:
        payload = msgpack_restore(p.read_bytes())
    except Exception:
        return None
    if not isinstance(payload, dict) or payload.get("key") != json.dumps(
            key, sort_keys=True):
        return None
    return payload.get("calib")


def calibrate_cached(model, batches_fn: Callable[[], Iterable], cache_path,
                     key: dict) -> Tuple[dict, bool]:
    """(calib, hit): the artifact at ``cache_path`` when its key matches,
    else calibrate on ``batches_fn()`` (called only on a miss) and write
    it."""
    calib = load_calibration(cache_path, key)
    if calib is not None:
        return calib, True
    calib = calibrate(model, batches_fn())
    save_calibration(cache_path, calib, key)
    return calib, False


def _mse_scales(w2d: np.ndarray, absmax: np.ndarray, min_scale: float,
                ratios=np.linspace(0.5, 1.0, 21)) -> np.ndarray:
    """Per-out-channel MSE-optimal symmetric clip: scale = r * absmax / 127
    for r over ``ratios``, keeping the one of least int8 reconstruction
    error (the JAX package's search)."""
    best_s = np.maximum(absmax / 127.0, min_scale)
    best_err = np.full(w2d.shape[1], np.inf)
    for r in ratios:
        s = np.maximum(absmax * r / 127.0, min_scale)
        q = np.clip(np.round(w2d / s), -127, 127) * s
        err = ((q - w2d) ** 2).sum(axis=0)
        better = err < best_err
        best_s = np.where(better, s, best_s)
        best_err = np.minimum(err, best_err)
    return best_s


def detect_feeder_skip(cfg) -> Tuple[str, ...]:
    """The convs feeding Detect, left in float: for a C3 feeder its cv3
    (``m30/cv3``), for another module the whole block (``m30``). The JAX
    package measured that skipping them recovers the int8 cost on its
    trained instrument (ACCURACY.md)."""
    from icafusion_tpu_torch.models.assembler import (detect_layer,
                                                      resolve_model)
    resolved, _ = resolve_model(cfg)
    by_i = {r.i: r for r in resolved}
    return tuple(f"m{i}/cv3" if by_i[i].module in ("C3", "C3TR") else f"m{i}"
                 for i in detect_layer(cfg).f)


def _skipped(path: Tuple[str, ...], skip: Tuple[str, ...]) -> bool:
    """The JAX walk's rule, applied at every ancestor of the module: a skip
    entry equal to the path, a prefix of it ending at a '/', or equal to
    its first component."""
    for n in range(1, len(path) + 1):
        p = "/".join(path[:n])
        if any(p == s or p.startswith(s + "/") or s == path[0]
               for s in skip):
            return True
    return False


def int8_conv_names(model, skip: Tuple[str, ...] = ()) -> list:
    """Names of the Conv modules of ``model`` outside ``skip``: the ones
    quantize_model fills when every Conv was calibrated and min_ch is 0."""
    skip = (skip,) if isinstance(skip, str) else tuple(skip)
    return [n for n, m in model.named_modules()
            if isinstance(m, Conv) and not _skipped(_path(n), skip)]


_FUSION_DENSE_LEAVES = ("out_vis", "out_ir")
_FUSION_DENSE_SUFFIXES = ("_fc1", "_fc2")


def _quantize_fusion_dense(model, min_scale: float) -> int:
    """Weight-only int8 for the fusion transformer's output projections and
    MLPs: per-out-channel symmetric w8 and s_w of the (in, out) kernel, no
    activation scale. Returns the number of layers filled."""
    n = 0
    for name, m in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if not isinstance(m, QLinear) or not (
                leaf in _FUSION_DENSE_LEAVES
                or leaf.endswith(_FUSION_DENSE_SUFFIXES)):
            continue
        w = m.weight.detach().cpu().numpy().astype(np.float32).T   # (in, out)
        s_w = np.maximum(np.abs(w).max(axis=0) / 127.0, min_scale)
        w8 = np.clip(np.round(w / s_w), -127, 127).astype(np.int8)
        dev = m.weight.device
        m.w8 = torch.from_numpy(np.ascontiguousarray(w8.T)).to(dev)
        m.s_w = torch.from_numpy(s_w.astype(np.float32)).to(dev)
        n += 1
    return n


def quantize_model(model, calib: dict, min_scale: float = 1e-8,
                   min_ch: int = 0, skip: Tuple[str, ...] = (),
                   weight_clip: str = "absmax", fusion_dense: bool = False):
    """Fill the int8 buffers of every Conv of the float32 ``model`` that has
    an ``absmax`` in ``calib`` (in place; returns the model), as the JAX
    package's quantize_variables builds its quant collection:

        s_in = max(absmax / 127, min_scale)            per input channel
        w_eff = w * s_in                               (HWIO, numpy fp32)
        s_w = max(max|w_eff| / 127, min_scale)         per output channel
              (or the MSE search with weight_clip='mse')
        w8 = clip(round(w_eff / s_w), -127, 127)

    min_ch: leave convs with fewer input or output channels in float.
    skip: flax module paths ('m0', 'm30/cv3') left in float, with the JAX
    package's matching rule. fusion_dense: also the fusion transformer's
    weight-only int8 (QLinear). Raises where nothing was quantized."""
    if weight_clip not in ("absmax", "mse"):
        raise ValueError(f"weight_clip must be 'absmax' or 'mse', got "
                         f"{weight_clip!r}")
    n = 0
    for name in int8_conv_names(model, skip):
        m = model.get_submodule(name)
        absmax = _get(calib, _path(name) + ("absmax",))
        if absmax is None:
            continue
        if m.conv.weight.dtype != torch.float32:
            raise ValueError("quantize_model reads float32 weights: quantize "
                             "the float32 model, then cast it")
        if m.conv.groups != 1:
            # the JAX package quantizes a grouped conv with a per-tensor
            # input scale (its utils/quantize.py:263); the int8 kernel
            # takes ungrouped convs only
            not_ported(f"{name}: the int8 conv of a grouped conv", "A10")
        w = m.conv.weight.detach().cpu().numpy().transpose(2, 3, 1, 0)  # HWIO
        if w.shape[2] < min_ch or w.shape[3] < min_ch:
            continue
        absmax = np.asarray(absmax, np.float32).reshape(-1)
        if absmax.shape[0] != w.shape[2]:
            raise ValueError(f"{name}: absmax has {absmax.shape[0]} channels, "
                             f"the conv {w.shape[2]}")
        s_in = np.maximum(absmax / 127.0, min_scale)
        w_eff = w * np.reshape(s_in, (1, 1, -1, 1))
        absmax_w = np.abs(w_eff).max(axis=(0, 1, 2))
        if weight_clip == "mse":
            s_w = _mse_scales(w_eff.reshape(-1, w_eff.shape[3]), absmax_w,
                              min_scale)
        else:
            s_w = np.maximum(absmax_w / 127.0, min_scale)
        w8 = np.clip(np.round(w_eff / s_w), -127, 127).astype(np.int8)
        dev = m.conv.weight.device
        m.w8 = torch.from_numpy(np.ascontiguousarray(
            w8.transpose(3, 0, 1, 2))).to(dev)
        m.s_w = torch.from_numpy(s_w.astype(np.float32)).to(dev)
        m.s_in = torch.from_numpy(s_in.astype(np.float32)).to(dev)
        n += 1
    if not n:
        raise ValueError("no quantizable convs found (empty calibration?)")
    if fusion_dense:
        _quantize_fusion_dense(model, min_scale)
    return model


def is_quantized(model) -> bool:
    """Whether any Conv or QLinear of ``model`` holds int8 weights."""
    return any(getattr(m, "w8", None) is not None for m in model.modules())
