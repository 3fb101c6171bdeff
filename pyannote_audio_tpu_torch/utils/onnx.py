"""Dependency-free ONNX weight reader, and a writer of such files.

Counterpart of pyannote_audio_tpu/utils/onnx.py. A WeSpeaker ``.onnx``
file is read for its weights only: ``torch.onnx.export`` keeps parameter
names as graph initializers ("layer1.0.conv1.weight",
"bn1.running_mean", ...), which map one to one onto the reference
``resnet.*`` state dict that models/embedding/wespeaker.py loads. The
port runs the network itself, so neither onnxruntime nor the ``onnx``
package is needed (the card machine has neither).

ONNX is protobuf; this module parses the wire format for the subset it
needs: ModelProto.graph(7) -> GraphProto.initializer(5) ->
TensorProto{dims(1), data_type(2), float_data(4), int64_data(7), name(8),
raw_data(9), double_data(10)}. ``write_onnx_initializers`` writes a
ModelProto whose graph holds only initializers, which is what
``read_onnx_initializers`` needs.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Iterator, Tuple, Union

import numpy as np

_FLOAT, _INT64, _DOUBLE, _FLOAT16 = 1, 7, 11, 10
# TensorProto.DataType values used by exported speaker models
_DTYPES = {1: np.float32, 6: np.int32, 7: np.int64, 10: np.float16,
           11: np.float64}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """Yield (field_number, wire_type, value) for one protobuf message."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:                     # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 1:                   # 64-bit
            value = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:                   # length-delimited
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:                   # 32-bit
            value = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, value


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims, name = [], ""
    data_type = _FLOAT
    raw = None
    floats, int64s, doubles = [], [], []
    for field, wire, value in _fields(buf):
        if field == 1:                    # dims (varint or packed)
            if wire == 0:
                dims.append(value)
            else:
                pos = 0
                while pos < len(value):
                    d, pos = _read_varint(value, pos)
                    dims.append(d)
        elif field == 2:
            data_type = value
        elif field == 4:                  # float_data (packed)
            floats.extend(struct.unpack(f"<{len(value) // 4}f", value))
        elif field == 7:                  # int64_data (packed varints)
            pos = 0
            while pos < len(value):
                d, pos = _read_varint(value, pos)
                # protobuf int64 varints are two's complement: reinterpret
                # the unsigned decode as signed 64-bit (a -1 Reshape dim
                # would otherwise decode as 2**64-1 and overflow numpy)
                if d >= 1 << 63:
                    d -= 1 << 64
                int64s.append(d)
        elif field == 8:
            name = value.decode("utf-8")
        elif field == 9:
            raw = value
        elif field == 10:                 # double_data (packed)
            doubles.extend(struct.unpack(f"<{len(value) // 8}d", value))
    dtype = _DTYPES.get(data_type)
    if dtype is None:
        raise ValueError(
            f"initializer {name!r} has unsupported ONNX data type "
            f"{data_type}")
    if raw is not None:
        array = np.frombuffer(raw, dtype=dtype)
    elif floats:
        array = np.asarray(floats, dtype=np.float32)
    elif doubles:
        array = np.asarray(doubles, dtype=np.float64)
    else:
        array = np.asarray(int64s, dtype=np.int64)
    return name, array.reshape(dims) if dims else array


def read_onnx_initializers(path: Union[str, Path]
                           ) -> Dict[str, np.ndarray]:
    """All named graph initializers (weights) of an ONNX file."""
    buf = Path(path).read_bytes()
    weights: Dict[str, np.ndarray] = {}
    for field, _, value in _fields(buf):
        if field != 7:                    # ModelProto.graph
            continue
        for gfield, _, gvalue in _fields(value):
            if gfield == 5:               # GraphProto.initializer
                name, array = _parse_tensor(gvalue)
                weights[name] = array
    return weights


# -- writer ---------------------------------------------------------------

def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_field(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def write_onnx_initializers(path: Union[str, Path],
                            weights: Dict[str, np.ndarray]) -> None:
    """Write a minimal ModelProto whose graph holds only initializers,
    which :func:`read_onnx_initializers` reads back."""
    graph = bytearray()
    for name, array in weights.items():
        array = np.asarray(array)
        code = {np.dtype(np.float32): 1, np.dtype(np.int64): 7,
                np.dtype(np.float64): 11,
                np.dtype(np.float16): 10}[array.dtype]
        tensor = bytearray()
        for d in array.shape:
            tensor += _varint(1 << 3 | 0) + _varint(d)
        tensor += _varint(2 << 3 | 0) + _varint(code)
        tensor += _len_field(8, name.encode("utf-8"))
        tensor += _len_field(9, array.tobytes())
        graph += _len_field(5, bytes(tensor))
    model = _varint(1 << 3 | 0) + _varint(8)          # ir_version
    model += _len_field(7, bytes(graph))
    Path(path).write_bytes(bytes(model))
