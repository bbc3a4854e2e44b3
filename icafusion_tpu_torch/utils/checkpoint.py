"""Read and write the JAX package's checkpoints (its utils/checkpoint.py)
without msgpack, flax or jax.

A checkpoint is one msgpack document written by
``flax.serialization.msgpack_serialize``: nested maps with string keys,
arrays as msgpack ext type 1 holding the msgpack array ``[shape, dtype
name, raw bytes]`` (C order), numpy scalars as ext type 3 in the same
encoding, and plain ints, floats, strings and bools for the rest. (flax
splits an array over 1 GiB into chunks; no checkpoint of the JAX package
has one, and this reader does not join them.)

``load_inference_variables`` applies the JAX package's rule: EMA weights
first, ``meta`` dropped, every leaf cast to float32, ready for
``utils/convert.load_jax_variables``.

The writer emits what flax's msgpack_serialize emits for such a tree (map
keys sorted, as a flax tree is; ints in their smallest encoding, floats as
float64), so that the JAX package's load_checkpoint and
restore_train_state read the port's training checkpoints:
{params, batch_stats, opt_momentum, opt_step, ema_tree, ema_updates, rng,
meta}, every tree in flax layout (utils/convert.py).
"""

from __future__ import annotations

import os
import struct
import threading
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from icafusion_tpu_torch.utils.convert import flax_tree, torch_tensors

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
# type byte -> value, or (length format, reader method), or number format
_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_SIZED = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
          0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"),
          0xDE: (">H", "map"), 0xDF: (">I", "map"),
          0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    """A msgpack decoder for the types a flax checkpoint holds."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated document")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:                               # positive fixint
            return b
        if b >= 0xE0:                               # negative fixint
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b in _FIXED:
            return _FIXED[b]
        if b in _SIZED:
            fmt, kind = _SIZED[b]
            return getattr(self, kind)(self.unpack(fmt))
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        body = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported ext type {code}")
        inner = _Reader(body)
        shape, dtype, raw = inner.value()
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def msgpack_restore(data: bytes) -> Any:
    """The tree of a flax msgpack document, arrays as numpy arrays."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes after the document")
    return tree


def _header(out: bytearray, n: int, small: Optional[int], fixmask: int,
            codes) -> None:
    """A length header: the fix form below ``small``, else the 8/16/32-bit
    form of ``codes`` (None where msgpack has no such form)."""
    if small is not None and n < small:
        out.append(fixmask | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF),
             (0xCE, ">I", 0, 0xFFFFFFFF), (0xCF, ">Q", 0, 2 ** 64 - 1),
             (0xD0, ">b", -0x80, 0x7F), (0xD1, ">h", -0x8000, 0x7FFF),
             (0xD2, ">i", -2 ** 31, 2 ** 31 - 1),
             (0xD3, ">q", -2 ** 63, 2 ** 63 - 1))
    for code, fmt, lo, hi in forms:
        if lo <= v <= hi and (v >= 0) == (lo == 0):
            out.append(code)
            out += struct.pack(fmt, v)
            return
    raise ValueError(f"msgpack: int {v} out of range")


def _pack_ext(out: bytearray, code: int, body: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(body) in fixed:
        out.append(fixed[len(body)])
    else:
        _header(out, len(body), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += body


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _header(out, len(raw), 32, 0xA0, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        _header(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)      # tobytes('C') orders the bytes
        body = bytearray()
        _pack(body, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
        _pack_ext(out, _EXT_NDARRAY if isinstance(obj, np.ndarray)
                  else _EXT_NPSCALAR, bytes(body))
    elif isinstance(obj, Mapping):
        _header(out, len(obj), 16, 0x80, (None, 0xDE, 0xDF))
        for k in sorted(obj):
            _pack(out, k)
            _pack(out, obj[k])
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 16, 0x90, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def msgpack_serialize(tree: Any) -> bytes:
    """A flax msgpack document of ``tree`` (nested str-keyed maps; numpy
    arrays and scalars, ints, floats, strings, bools)."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def load_checkpoint(path) -> Dict[str, Any]:
    return msgpack_restore(Path(path).read_bytes())


# background writers by destination; a newer save to one path joins the
# previous writer first, so the writes to a path stay in order
_PENDING_SAVES: Dict[str, threading.Thread] = {}


def _train_payload(state) -> Dict[str, Any]:
    """The flax-layout trees of a train/trainer.Trainer's state."""
    model = state.model
    sd = model.state_dict()
    mom = state.opt.momentum
    if state.adam:
        opt = {k: flax_tree(model, mom[k]) for k in ("m", "v")}
    else:
        opt = flax_tree(model, mom)
    ema = state.ema.tree
    return {"params": flax_tree(model, sd, "params"),
            "batch_stats": flax_tree(model, sd, "batch_stats"),
            "opt_momentum": opt, "opt_step": int(state.opt.step),
            "ema_tree": {"params": flax_tree(model, ema, "params"),
                         "batch_stats": flax_tree(model, ema, "batch_stats")},
            "ema_updates": int(state.ema.updates),
            "rng": np.asarray(state.rng, np.uint32)}


def save_checkpoint(path, state, epoch: int, best_fitness: float,
                    extra: Optional[Dict[str, Any]] = None,
                    background: bool = False):
    """Write the state of a Trainer to <path> atomically, in the JAX
    package's format. The copy to the host is synchronous; with
    background=True the encoding and the disk write run on a thread (call
    wait_pending_saves() before reading the file)."""
    payload = _train_payload(state)
    payload["meta"] = {"epoch": int(epoch), "best_fitness": float(best_fitness),
                       **(extra or {})}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    def write():
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_bytes(msgpack_serialize(payload))
        os.replace(tmp, path)

    if not background:
        write()
        return
    prev = _PENDING_SAVES.pop(str(path), None)
    if prev is not None:
        prev.join()
    t = threading.Thread(target=write, daemon=True)
    t.start()
    _PENDING_SAVES[str(path)] = t


def wait_pending_saves():
    """Join every background checkpoint writer."""
    while _PENDING_SAVES:
        _, t = _PENDING_SAVES.popitem()
        t.join()


@torch.no_grad()
def restore_train_state(ckpt: Mapping[str, Any], state):
    """Load a checkpoint (of either package) into a Trainer in place:
    weights, BatchNorm statistics, optimizer buffers and step, EMA and the
    key its dropout generator is seeded from. Strict on names and shapes
    (resume semantics, train.py:157-183). Returns the Trainer."""
    model = state.model

    def fill(dst: Dict[str, torch.Tensor], tree, coll="params"):
        for name, arr in torch_tensors(model, tree, coll).items():
            dst[name].copy_(torch.from_numpy(np.array(arr, np.float32)))

    sd = model.state_dict()
    fill(sd, ckpt["params"])
    fill(sd, ckpt["batch_stats"], "batch_stats")
    mom = state.opt.momentum
    if state.adam:
        for k in ("m", "v"):
            fill(mom[k], ckpt["opt_momentum"][k])
    else:
        fill(mom, ckpt["opt_momentum"])
    state.opt.step = int(ckpt["opt_step"])
    fill(state.ema.tree, ckpt["ema_tree"]["params"])
    fill(state.ema.tree, ckpt["ema_tree"]["batch_stats"], "batch_stats")
    state.ema.updates = int(ckpt["ema_updates"])
    state.rng = np.asarray(ckpt["rng"], np.uint32).reshape(-1)
    state.reseed()
    return state


def strip_checkpoint(ckpt_path, out_path):
    """The inference artifact: the EMA variables only, float16, and meta
    (general.py:610-623)."""
    ckpt = load_checkpoint(ckpt_path)
    half = lambda t: {k: half(v) if isinstance(v, Mapping)
                      else np.asarray(v, np.float16) for k, v in t.items()}
    ema = ckpt["ema_tree"]
    slim = {"params": half(ema["params"]),
            "batch_stats": half(ema["batch_stats"]), "meta": ckpt["meta"]}
    Path(out_path).write_bytes(msgpack_serialize(slim))


def _to_float32(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _to_float32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def load_inference_variables(path) -> Dict[str, Any]:
    """Variables for inference from a stripped or full checkpoint: the EMA
    tree where there is one (the JAX package's utils/checkpoint.py:131-141),
    without ``meta``, every leaf float32."""
    ckpt = load_checkpoint(path)
    if "ema_tree" in ckpt:
        tree = ckpt["ema_tree"]
    elif "params" in ckpt and "meta" in ckpt and "ema" not in ckpt:
        tree = {"params": ckpt["params"],
                "batch_stats": ckpt.get("batch_stats", {})}
    else:
        tree = {k: v for k, v in ckpt.items() if k != "meta"}
    return _to_float32(tree)
