"""Dependency-free ONNX protobuf writer + reader.

The port's own copy of the JAX package's export/onnx_proto.py (the port
imports nothing of that package); its models name the producer
"icafusion_tpu_torch". The reference exports ONNX through the `onnx`
package (models/export.py:85-107), which neither the CPU container nor the
card has. ONNX files are plain protobuf, so this module
implements the protobuf wire format directly (varint + length-delimited fields)
against the stable onnx.proto field numbers (ModelProto/GraphProto/NodeProto/
TensorProto/AttributeProto — unchanged since IR version 3). The writer emits
ir_version 7 / default opset 13 models; the reader parses them back for the
round-trip + numpy-execution validation (export/onnx_numpy.py).

Scope: exactly the subset of ONNX this framework's exporter emits — tensors as
raw_data, attributes of type FLOAT/INT/STRING/TENSOR/FLOATS/INTS/STRINGS,
static tensor shapes. Not a general ONNX library.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

# --- TensorProto.DataType enum (onnx.proto) ---
FLOAT, UINT8, INT8, INT32, INT64, BOOL, FLOAT16, DOUBLE = 1, 2, 3, 6, 7, 9, 10, 11
_NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT, np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8, np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64, np.dtype(np.bool_): BOOL,
    np.dtype(np.float16): FLOAT16, np.dtype(np.float64): DOUBLE,
}
_ONNX_TO_NP = {v: k for k, v in _NP_TO_ONNX.items()}

# --- AttributeProto.AttributeType enum ---
A_FLOAT, A_INT, A_STRING, A_TENSOR = 1, 2, 3, 4
A_FLOATS, A_INTS, A_STRINGS = 6, 7, 8


# ---------------------------------------------------------------------------
# wire-format primitives
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _ld(field: int, payload: bytes) -> bytes:
    """Length-delimited field (wire type 2)."""
    return _tag(field, 2) + _varint(len(payload)) + payload


def _vint(field: int, value: int) -> bytes:
    """Varint field (wire type 0); negative ints use 64-bit two's complement."""
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _f32(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _packed_varints(field: int, values: Iterable[int]) -> bytes:
    body = b"".join(_varint(v & 0xFFFFFFFFFFFFFFFF) for v in values)
    return _ld(field, body)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, raw_data=9, name=8."""
    arr = np.ascontiguousarray(arr)
    dt = _NP_TO_ONNX[arr.dtype]
    out = _packed_varints(1, arr.shape) if arr.ndim else b""
    out += _vint(2, dt)
    out += _ld(8, name.encode())
    out += _ld(9, arr.tobytes())
    return out


def _attr(name: str, value: Any) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8,
    strings=9, type=20."""
    out = _ld(1, name.encode())
    if isinstance(value, bool):
        out += _vint(3, int(value)) + _vint(20, A_INT)
    elif isinstance(value, int):
        out += _vint(3, value) + _vint(20, A_INT)
    elif isinstance(value, float):
        out += _f32(2, value) + _vint(20, A_FLOAT)
    elif isinstance(value, str):
        out += _ld(4, value.encode()) + _vint(20, A_STRING)
    elif isinstance(value, np.ndarray):
        out += _ld(5, tensor_proto("", value)) + _vint(20, A_TENSOR)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, int) for v in value):
            out += b"".join(_vint(8, v) for v in value) + _vint(20, A_INTS)
        elif all(isinstance(v, float) for v in value):
            out += b"".join(_f32(7, v) for v in value) + _vint(20, A_FLOATS)
        elif all(isinstance(v, str) for v in value):
            out += b"".join(_ld(9, v.encode()) for v in value) + _vint(20, A_STRINGS)
        else:
            raise TypeError(f"mixed attribute list for {name!r}")
    else:
        raise TypeError(f"unsupported attribute {name!r}: {type(value)}")
    return out


def node_proto(op_type: str, inputs: List[str], outputs: List[str],
               name: str = "", attrs: Optional[Dict[str, Any]] = None) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    out = b"".join(_ld(1, i.encode()) for i in inputs)
    out += b"".join(_ld(2, o.encode()) for o in outputs)
    if name:
        out += _ld(3, name.encode())
    out += _ld(4, op_type.encode())
    for k, v in (attrs or {}).items():
        out += _ld(5, _attr(k, v))
    return out


def value_info(name: str, elem_type: int, shape: Tuple[Union[int, str], ...]) -> bytes:
    """ValueInfoProto{name=1,type=2} / TypeProto{tensor_type=1} /
    Tensor{elem_type=1,shape=2} / TensorShapeProto{dim=1} /
    Dim{dim_value=1, dim_param=2}. A str dim emits dim_param (dynamic —
    used for the data-dependent NonMaxSuppression output count)."""
    dims = b"".join(
        _ld(1, _ld(2, d.encode()) if isinstance(d, str) else _vint(1, d))
        for d in shape)
    tensor = _vint(1, elem_type) + _ld(2, dims)
    return _ld(1, name.encode()) + _ld(2, _ld(1, tensor))


def graph_proto(nodes: List[bytes], name: str, initializers: List[bytes],
                inputs: List[bytes], outputs: List[bytes]) -> bytes:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    out = b"".join(_ld(1, n) for n in nodes)
    out += _ld(2, name.encode())
    out += b"".join(_ld(5, t) for t in initializers)
    out += b"".join(_ld(11, i) for i in inputs)
    out += b"".join(_ld(12, o) for o in outputs)
    return out


def model_proto(graph: bytes, opset: int = 13,
                producer: str = "icafusion_tpu_torch",
                ir_version: int = 7, doc: str = "") -> bytes:
    """ModelProto: ir_version=1, producer_name=2, producer_version=3,
    doc_string=6, graph=7, opset_import=8; OperatorSetId{domain=1,version=2}."""
    out = _vint(1, ir_version)
    out += _ld(2, producer.encode())
    out += _ld(3, b"0")
    if doc:
        out += _ld(6, doc.encode())
    out += _ld(7, graph)
    out += _ld(8, _ld(1, b"") + _vint(2, opset))
    return out


# ---------------------------------------------------------------------------
# reader (for round-trip validation and the numpy evaluator)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def parse_fields(buf: bytes) -> Dict[int, list]:
    """Parse a protobuf message into {field_number: [raw values]} — bytes for
    length-delimited fields, ints for varints, 4/8-byte chunks for fixed."""
    fields: Dict[int, list] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            v = buf[pos:pos + n]
            pos += n
        elif wire == 5:
            v = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            v = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(v)
    return fields


def _scalar(fields, num, default=None):
    return fields[num][0] if num in fields else default


def parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    f = parse_fields(buf)
    dims = []
    for raw in f.get(1, []):
        if isinstance(raw, int):
            dims.append(raw)
        else:  # packed
            pos = 0
            while pos < len(raw):
                v, pos = _read_varint(raw, pos)
                dims.append(v)
    dt = _scalar(f, 2, FLOAT)
    name = _scalar(f, 8, b"").decode()
    raw_data = _scalar(f, 9)
    if raw_data is None:
        raise ValueError(f"tensor {name!r}: only raw_data encoding supported")
    arr = np.frombuffer(raw_data, dtype=_ONNX_TO_NP[dt]).reshape(dims)
    return name, arr


def parse_attr(buf: bytes) -> Tuple[str, Any]:
    f = parse_fields(buf)
    name = _scalar(f, 1, b"").decode()
    atype = _scalar(f, 20, 0)
    if atype == A_INT:
        v = _scalar(f, 3, 0)
        if v >= 1 << 63:
            v -= 1 << 64
        return name, v
    if atype == A_FLOAT:
        return name, struct.unpack("<f", _scalar(f, 2))[0]
    if atype == A_STRING:
        return name, _scalar(f, 4, b"").decode()
    if atype == A_TENSOR:
        return name, parse_tensor(_scalar(f, 5))[1]
    if atype == A_INTS:
        return name, [v - (1 << 64) if v >= 1 << 63 else v for v in f.get(8, [])]
    if atype == A_FLOATS:
        return name, [struct.unpack("<f", v)[0] for v in f.get(7, [])]
    if atype == A_STRINGS:
        return name, [v.decode() for v in f.get(9, [])]
    raise ValueError(f"attribute {name!r}: unsupported type {atype}")


class Node:
    def __init__(self, buf: bytes):
        f = parse_fields(buf)
        self.inputs = [v.decode() for v in f.get(1, [])]
        self.outputs = [v.decode() for v in f.get(2, [])]
        self.name = _scalar(f, 3, b"").decode()
        self.op_type = _scalar(f, 4, b"").decode()
        self.attrs = dict(parse_attr(a) for a in f.get(5, []))


class OnnxModel:
    """Parsed model: .graph_name, .nodes, .initializers {name: array},
    .inputs / .outputs [(name, elem_type, shape)]."""

    def __init__(self, buf: bytes):
        mf = parse_fields(buf)
        self.ir_version = _scalar(mf, 1, 0)
        ops = parse_fields(_scalar(mf, 8))
        self.opset = _scalar(ops, 2, 0)
        gf = parse_fields(_scalar(mf, 7))
        self.graph_name = _scalar(gf, 2, b"").decode()
        self.nodes = [Node(n) for n in gf.get(1, [])]
        self.initializers = dict(parse_tensor(t) for t in gf.get(5, []))
        self.inputs = [self._vi(v) for v in gf.get(11, [])]
        self.outputs = [self._vi(v) for v in gf.get(12, [])]

    @staticmethod
    def _vi(buf: bytes):
        f = parse_fields(buf)
        name = _scalar(f, 1, b"").decode()
        tt = parse_fields(parse_fields(_scalar(f, 2))[1][0])
        elem = _scalar(tt, 1, FLOAT)
        shape = []
        for d in parse_fields(_scalar(tt, 2, b"")).get(1, []):
            df = parse_fields(d)
            shape.append(_scalar(df, 1, -1))
        return name, elem, tuple(shape)


def load(path_or_bytes: Union[str, bytes]) -> OnnxModel:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return OnnxModel(bytes(path_or_bytes))
    with open(path_or_bytes, "rb") as fh:
        return OnnxModel(fh.read())
