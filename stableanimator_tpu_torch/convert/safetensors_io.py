"""`.safetensors` files read and written with the standard library and numpy.

The format: an unsigned 64-bit little-endian header length n, then n bytes
of JSON, `{name: {"dtype", "shape", "data_offsets": [begin, end]}}` plus an
optional `"__metadata__"` of strings, then the data, in which each tensor's
bytes (little-endian, row-major) lie at its offsets, counted from the end of
the header.

`read_safetensors` gives what `safetensors.safe_open(path, framework="np")`
gives, tensor by tensor: F16 stays float16, F32 / F64 / I8-I64 / U8-U64 /
BOOL keep their numpy types, and BF16 and the F8 types raise TypeError
(numpy has no such type; safe_open refuses them too, so no value is upcast
here). The tensors are views of one read-only `numpy.memmap` of the file:
nothing is read until a value is used, and a 3 GB file is not copied twice
on its way to an `.npz`. `write_safetensors` writes the same format; the
tests and chip_smoke.py build their fixture trees with it.
"""

from __future__ import annotations

import json
import os

import numpy as np

DTYPES = {"F16": "<f2", "F32": "<f4", "F64": "<f8", "I8": "i1", "I16": "<i2", "I32": "<i4",
          "I64": "<i8", "U8": "u1", "U16": "<u2", "U32": "<u4", "U64": "<u8", "BOOL": "?"}
# the types numpy has no counterpart of
UNREADABLE = ("BF16", "F8_E4M3", "F8_E5M2")
_NAMES = {np.dtype(v): k for k, v in DTYPES.items()}
# a header larger than this is not a header (the format's own limit is 100 MB)
MAX_HEADER_BYTES = 100 * 1000 * 1000


def read_header(path: str) -> tuple[dict, dict, int]:
    """(tensors {name: {"dtype", "shape", "data_offsets"}}, metadata, the
    data's first byte) of the file at `path`, checked against its size:
    every tensor's offsets inside the data, its byte count equal to its
    shape times its type's width, and the tensors laid end to end over the
    whole data, without a gap or an overlap. A bad file raises ValueError
    naming the tensor; a type numpy lacks raises TypeError."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
        n = int.from_bytes(head, "little")
        if n > MAX_HEADER_BYTES or 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes in a file of {size}")
        try:
            header = json.loads(f.read(n).decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: the header is not JSON ({e})") from e
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    metadata = header.pop("__metadata__", None) or {}
    data_bytes = size - 8 - n
    spans = []
    for name, info in header.items():
        if not (isinstance(info, dict) and set(info) == {"dtype", "shape", "data_offsets"}):
            raise ValueError(f"{path}: tensor {name!r}: entry {info!r} is not "
                             "{dtype, shape, data_offsets}")
        dtype, shape, offsets = info["dtype"], info["shape"], info["data_offsets"]
        if dtype in UNREADABLE:
            raise TypeError(f"{path}: tensor {name!r} is {dtype}, which numpy has no type for")
        if dtype not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has an unknown dtype {dtype!r}")
        if not (isinstance(shape, list) and all(isinstance(d, int) and d >= 0 for d in shape)):
            raise ValueError(f"{path}: tensor {name!r} has a bad shape {shape!r}")
        if not (isinstance(offsets, list) and len(offsets) == 2
                and all(isinstance(o, int) for o in offsets)
                and 0 <= offsets[0] <= offsets[1]):
            raise ValueError(f"{path}: tensor {name!r} has bad offsets {offsets!r}")
        begin, end = offsets
        want = int(np.prod(shape, dtype=np.int64)) * np.dtype(DTYPES[dtype]).itemsize
        if end - begin != want:
            raise ValueError(f"{path}: tensor {name!r} spans {end - begin} bytes; its shape "
                             f"{shape} of {dtype} needs {want}")
        if end > data_bytes:
            raise ValueError(f"{path}: tensor {name!r} ends at byte {end} of data that holds "
                             f"{data_bytes} (a truncated file?)")
        spans.append((begin, end, name))
    at = 0
    for begin, end, name in sorted(spans):
        if begin != at:
            raise ValueError(f"{path}: tensor {name!r} begins at byte {begin} of the data, "
                             f"where the tensors before it end at {at} "
                             f"({'an overlap' if begin < at else 'a gap'})")
        at = end
    if at != data_bytes:
        raise ValueError(f"{path}: the tensors end at byte {at} of data that holds {data_bytes}")
    return header, metadata, 8 + n


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """Every tensor of the file, by name, as read-only views of one memmap
    (`read_header` checks the file first)."""
    header, _, start = read_header(path)
    if os.path.getsize(path) == start:          # no data: numpy cannot map 0 bytes
        data = np.zeros(0, np.uint8)
    else:
        data = np.memmap(path, dtype=np.uint8, mode="r", offset=start)
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        out[name] = data[begin:end].view(DTYPES[info["dtype"]]).reshape(info["shape"])
    return out


def write_safetensors(path: str, tensors: dict, metadata: dict | None = None) -> int:
    """Write `tensors` ({name: numpy array}), the widest types first and then
    by name (so that every tensor is aligned to its type's width, as the
    safetensors package lays them out), with `metadata` ({str: str}) as
    `__metadata__`; returns the bytes written. A type the format has no
    name for raises TypeError."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    coded = {}
    for name, value in tensors.items():
        arr = np.asarray(value)
        code = _NAMES.get(arr.dtype.newbyteorder("<") if arr.dtype.byteorder == ">"
                          else arr.dtype)
        if code is None:
            raise TypeError(f"tensor {name!r}: no safetensors dtype for {arr.dtype}")
        coded[name] = (code, np.require(arr, DTYPES[code], "C"))
    arrays, at = [], 0
    for name in sorted(coded, key=lambda k: (-coded[k][1].itemsize, k)):
        code, arr = coded[name]
        header[name] = {"dtype": code, "shape": list(arr.shape),
                        "data_offsets": [at, at + arr.nbytes]}
        arrays.append(arr)
        at += arr.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)              # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for arr in arrays:
            f.write(arr.tobytes())
    return 8 + len(raw) + at
