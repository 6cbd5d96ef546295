"""Minimal self-contained ONNX file reader (no `onnx` package, no protoc); a
copy of the JAX package's `preproc/onnx_reader.py`, which imports no JAX.

Parses the protobuf wire format directly and extracts the inference graph:
nodes (op_type, inputs, outputs, attributes), initializers (numpy arrays),
and graph inputs/outputs. Covers everything needed to load the reference's
preprocessing models (YOLOX-L, RTMPose dw-ll_ucoco_384, SCRFD, ArcFace
glintr100, BiSeNet — SURVEY.md §2.3) for execution by onnx_to_torch.py.

Supports ONNX's external-data convention (raw tensor payloads in a
side-car file) and the standard packed/raw tensor encodings.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# --- protobuf wire-format primitives ---------------------------------------


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over a serialized message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            val = buf[pos:pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _fields_dict(buf: memoryview) -> Dict[int, list]:
    out: Dict[int, list] = {}
    for field, wire, val in _parse_fields(buf):
        out.setdefault(field, []).append((wire, val))
    return out


def _sint(v) -> int:
    """Interpret a varint as a signed 64-bit integer."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _packed_varints(entries) -> List[int]:
    vals = []
    for wire, v in entries:
        if wire == 0:
            vals.append(_sint(v))
        else:  # packed
            pos = 0
            while pos < len(v):
                x, pos = _read_varint(v, pos)
                vals.append(_sint(x))
    return vals


def _packed_f32(entries) -> np.ndarray:
    chunks = []
    for wire, v in entries:
        if wire == 5:
            chunks.append(np.frombuffer(v, dtype="<f4"))
        else:
            chunks.append(np.frombuffer(bytes(v), dtype="<f4"))
    return np.concatenate(chunks) if chunks else np.zeros((0,), np.float32)


# --- ONNX message extraction ------------------------------------------------

_ONNX_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


@dataclasses.dataclass
class Attribute:
    name: str
    value: Any


@dataclasses.dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str
    attrs: Dict[str, Any]


@dataclasses.dataclass
class Graph:
    nodes: List[Node]
    initializers: Dict[str, np.ndarray]
    inputs: List[Tuple[str, Optional[List[int]]]]   # (name, shape or None)
    outputs: List[str]
    name: str = ""


def _parse_tensor(buf: memoryview, base_dir: str = "") -> Tuple[str, np.ndarray]:
    f = _fields_dict(buf)
    dims = _packed_varints(f.get(1, []))
    dtype_code = f[2][0][1] if 2 in f else 1
    dtype = _ONNX_DTYPES.get(dtype_code)
    if dtype is None:
        raise ValueError(f"unsupported tensor dtype code {dtype_code}")
    name = bytes(f[8][0][1]).decode() if 8 in f else ""

    data: Optional[np.ndarray] = None
    if 9 in f:  # raw_data
        data = np.frombuffer(bytes(f[9][0][1]), dtype=dtype)
    elif 4 in f and dtype == np.float32:
        data = _packed_f32(f[4])
    elif 7 in f:  # int64_data
        data = np.asarray(_packed_varints(f[7]), dtype=np.int64)
    elif 5 in f:  # int32_data (also carries (u)int8/16, bool, fp16 payloads)
        raw = np.asarray(_packed_varints(f[5]), dtype=np.int64)
        if dtype == np.float16:
            data = raw.astype(np.uint16).view(np.float16)
        else:
            data = raw.astype(dtype)
    elif 10 in f:  # double_data
        chunks = [np.frombuffer(bytes(v) if w != 1 else v, dtype="<f8")
                  for w, v in f[10]]
        data = np.concatenate(chunks).astype(np.float64)
    elif 13 in f:  # external data: key/value StringStringEntryProto list
        location, offset, length = None, 0, None
        for _, entry in f[13]:
            ef = _fields_dict(entry)
            k = bytes(ef[1][0][1]).decode()
            v = bytes(ef[2][0][1]).decode()
            if k == "location":
                location = v
            elif k == "offset":
                offset = int(v)
            elif k == "length":
                length = int(v)
        if location is None:
            raise ValueError(f"tensor {name}: external data without location")
        path = os.path.join(base_dir, location)
        with open(path, "rb") as fh:
            fh.seek(offset)
            payload = fh.read(length) if length is not None else fh.read()
        data = np.frombuffer(payload, dtype=dtype)
    else:
        data = np.zeros((0,), dtype=dtype)

    return name, data.reshape(dims) if dims else data.reshape(())


def _parse_attribute(buf: memoryview, base_dir: str) -> Attribute:
    f = _fields_dict(buf)
    name = bytes(f[1][0][1]).decode()
    atype = f[20][0][1] if 20 in f else None
    # AttributeProto.AttributeType: 1 FLOAT, 2 INT, 3 STRING, 4 TENSOR,
    # 6 FLOATS, 7 INTS, 8 STRINGS
    if atype == 1 or (atype is None and 2 in f):
        return Attribute(name, struct.unpack("<f", f[2][0][1])[0])
    if atype == 2 or (atype is None and 3 in f):
        return Attribute(name, _sint(f[3][0][1]))
    if atype == 3 or (atype is None and 4 in f):
        return Attribute(name, bytes(f[4][0][1]).decode(errors="replace"))
    if atype == 4 or (atype is None and 5 in f):
        return Attribute(name, _parse_tensor(f[5][0][1], base_dir)[1])
    if atype == 6 or (atype is None and 7 in f):
        return Attribute(name, _packed_f32(f[7]).tolist())
    if atype == 7 or (atype is None and 8 in f):
        return Attribute(name, _packed_varints(f[8]))
    if atype == 8 or (atype is None and 9 in f):
        return Attribute(name, [bytes(v).decode(errors="replace") for _, v in f[9]])
    return Attribute(name, None)


def _parse_node(buf: memoryview, base_dir: str) -> Node:
    f = _fields_dict(buf)
    return Node(
        op_type=bytes(f[4][0][1]).decode() if 4 in f else "",
        inputs=[bytes(v).decode() for _, v in f.get(1, [])],
        outputs=[bytes(v).decode() for _, v in f.get(2, [])],
        name=bytes(f[3][0][1]).decode() if 3 in f else "",
        attrs={a.name: a.value for a in
               (_parse_attribute(v, base_dir) for _, v in f.get(5, []))},
    )


def _parse_value_info(buf: memoryview) -> Tuple[str, Optional[List[int]]]:
    f = _fields_dict(buf)
    name = bytes(f[1][0][1]).decode()
    shape = None
    if 2 in f:  # TypeProto
        tf = _fields_dict(f[2][0][1])
        if 1 in tf:  # tensor_type
            tt = _fields_dict(tf[1][0][1])
            if 2 in tt:  # shape
                sf = _fields_dict(tt[2][0][1])
                shape = []
                for _, dim_buf in sf.get(1, []):
                    df = _fields_dict(dim_buf)
                    shape.append(_sint(df[1][0][1]) if 1 in df else -1)
    return name, shape


def _parse_graph(buf: memoryview, base_dir: str) -> Graph:
    f = _fields_dict(buf)
    initializers = {}
    for _, t in f.get(5, []):
        name, arr = _parse_tensor(t, base_dir)
        initializers[name] = arr
    inputs = [_parse_value_info(v) for _, v in f.get(11, [])]
    inputs = [(n, s) for n, s in inputs if n not in initializers]
    outputs = [_parse_value_info(v)[0] for _, v in f.get(12, [])]
    return Graph(
        nodes=[_parse_node(v, base_dir) for _, v in f.get(1, [])],
        initializers=initializers,
        inputs=inputs,
        outputs=outputs,
        name=bytes(f[2][0][1]).decode() if 2 in f else "",
    )


def load_onnx(path: str) -> Graph:
    """Parse an .onnx file into a Graph IR."""
    with open(path, "rb") as fh:
        data = fh.read()
    f = _fields_dict(memoryview(data))
    if 7 not in f:
        raise ValueError(f"{path}: no graph found (not an ONNX model?)")
    return _parse_graph(f[7][0][1], os.path.dirname(os.path.abspath(path)))
