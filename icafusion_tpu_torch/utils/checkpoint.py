"""Read the JAX package's checkpoints (the reading half of its
utils/checkpoint.py) without msgpack, flax or jax.

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
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np

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


def load_checkpoint(path) -> Dict[str, Any]:
    return msgpack_restore(Path(path).read_bytes())


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
