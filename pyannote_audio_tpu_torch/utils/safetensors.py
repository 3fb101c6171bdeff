"""Read and write the safetensors format with numpy alone.

The card machine has no ``safetensors`` package, and ``Calibration``
stores its breakpoints in this format, so the package carries the format
itself: an 8-byte little-endian header length, a JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` (with an
optional ``"__metadata__"`` of strings) padded with spaces to a multiple
of 8 bytes, then the tensors' raw little-endian bytes, back to back.
Files written here load with ``safetensors.numpy.load_file``, and files
it writes load here.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Mapping, Optional, Union

import numpy as np

PathLike = Union[str, Path]

_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8",
           "I32": "<i4", "I16": "<i2", "I8": "i1", "U64": "<u8",
           "U32": "<u4", "U16": "<u2", "U8": "u1", "BOOL": "?"}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}
# a header larger than this is not a safetensors file
_MAX_HEADER = 100 << 20


def save_file(tensors: Mapping[str, np.ndarray], path: PathLike,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (name -> array) to ``path``, in name order."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name in sorted(tensors):
        array = np.asarray(tensors[name])
        dtype = array.dtype.newbyteorder("<") if array.dtype.byteorder == ">" \
            else array.dtype
        if dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {array.dtype} has no "
                             f"safetensors name")
        blob = np.ascontiguousarray(array, dtype=dtype).tobytes()
        header[name] = {"dtype": _NAMES[dtype], "shape": list(array.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for blob in blobs:
            f.write(blob)


def load_file(path: PathLike) -> Dict[str, np.ndarray]:
    """Read every tensor of a safetensors file into numpy arrays."""
    data = Path(path).read_bytes()
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (size,) = struct.unpack("<Q", data[:8])
    if size > min(_MAX_HEADER, len(data) - 8):
        raise ValueError(f"{path}: header length {size} does not fit the "
                         f"file")
    header = json.loads(data[8:8 + size])
    body = memoryview(data)[8 + size:]
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"which numpy cannot hold")
        dtype = np.dtype(_DTYPES[info["dtype"]])
        begin, end = info["data_offsets"]
        shape = tuple(int(n) for n in info["shape"])
        if not 0 <= begin <= end <= len(body) or \
                end - begin != dtype.itemsize * int(np.prod(shape)):
            raise ValueError(f"{path}: {name}'s offsets [{begin}, {end}) do "
                             f"not match its shape {shape} and dtype")
        out[name] = np.frombuffer(body[begin:end], dtype=dtype).reshape(
            shape).astype(dtype.newbyteorder("="))
    return out
