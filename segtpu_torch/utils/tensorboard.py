"""TensorBoard event files for scalars and images, written without
tensorboardX or tensorboard.

The trainer's transport for segtpu's events (``segtpu/trainer.py`` writes
them through tensorboardX's ``SummaryWriter``). The file is TFRecord
framing, each record a little-endian uint64 length, the masked CRC-32C of
those 8 bytes, the data, and the masked CRC-32C of the data; each record is
an ``Event`` protobuf encoded here by hand:

* ``Event``: ``wall_time`` (1, double), ``step`` (2, int64),
  ``file_version`` (3, string; the first record's only payload),
  ``summary`` (5);
* ``Summary``: ``value`` (1, repeated);
* ``Summary.Value``: ``tag`` (1), ``simple_value`` (2, float), ``image``
  (4);
* ``Summary.Image``: ``height`` (1), ``width`` (2), ``colorspace`` (3, the
  channel count), ``encoded_image_string`` (4, PNG bytes through PIL).

The file is named ``events.out.tfevents.<time>.<host>``, as tensorboardX
names it, and written as the events come; :meth:`SummaryWriter.flush`
pushes it to the disk. :func:`read_events` reads such a file back, checking
both CRCs of every record.

CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) is not zlib's CRC-32.
It is table-driven; a long buffer (a PNG of the val grid) is cut into
blocks whose registers are advanced together, one byte position at a time
across all blocks, then chained, each block's register carried over the
next block's length by four tables of the same linear map.
"""

from __future__ import annotations

import functools
import os
import socket
import struct
import time
from typing import Dict, Iterator, List, Tuple

import numpy as np

_POLY = 0x82F63B78
_BLOCK = 1024  # bytes a block, for the blocked form of a long buffer


def _byte_table() -> np.ndarray:
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        table = np.where(table & 1, (table >> 1) ^ np.uint32(_POLY), table >> 1)
    return table.astype(np.uint32)


_TABLE = _byte_table()
_TABLE_LIST = [int(v) for v in _TABLE]


def _crc_bytes(reg: int, data) -> int:
    table = _TABLE_LIST
    for b in data:
        reg = table[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


@functools.lru_cache(maxsize=None)
def _shift_tables() -> List[List[int]]:
    """``tables[i][v]``: the register that ``v << 8 i`` becomes over
    ``_BLOCK`` zero bytes (a linear map, so a state is carried over by the
    XOR of its four bytes' entries)."""
    basis = np.uint32(1) << np.arange(32, dtype=np.uint32)
    for _ in range(_BLOCK):
        basis = _TABLE[basis & 0xFF] ^ (basis >> 8)
    basis = [int(v) for v in basis]
    tables = []
    for i in range(4):
        t = [0] * 256
        for v in range(1, 256):
            low = v & -v
            t[v] = t[v ^ low] ^ basis[8 * i + low.bit_length() - 1]
        tables.append(t)
    return tables


def crc32c(data: bytes) -> int:
    """CRC-32C of ``data``."""
    n_blocks = len(data) // _BLOCK
    if n_blocks < 8:
        return _crc_bytes(0xFFFFFFFF, data) ^ 0xFFFFFFFF
    blocks = np.frombuffer(data, np.uint8, n_blocks * _BLOCK).reshape(n_blocks, _BLOCK)
    regs = np.zeros(n_blocks, np.uint32)
    for j in range(_BLOCK):  # every block's register, from 0, one byte at a time
        regs = _TABLE[(regs ^ blocks[:, j]) & 0xFF] ^ (regs >> 8)
    t0, t1, t2, t3 = _shift_tables()
    reg = 0xFFFFFFFF
    for block_reg in regs.tolist():
        reg = (t0[reg & 0xFF] ^ t1[(reg >> 8) & 0xFF] ^ t2[(reg >> 16) & 0xFF]
               ^ t3[reg >> 24] ^ block_reg)
    return _crc_bytes(reg, data[n_blocks * _BLOCK:]) ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte, n = n & 0x7F, n >> 7
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(number: int, wire: int, payload: bytes) -> bytes:
    """One protobuf field: wire 0 (varint, ``payload`` already encoded), 1
    (8 bytes), 2 (length-delimited) or 5 (4 bytes)."""
    key = _varint(number << 3 | wire)
    return key + (_varint(len(payload)) + payload if wire == 2 else payload)


def _event(wall_time: float, step: int = 0, file_version: str = None,
           values: List[bytes] = ()) -> bytes:
    out = _field(1, 1, struct.pack("<d", wall_time))
    if step:
        out += _field(2, 0, _varint(step))
    if file_version is not None:
        out += _field(3, 2, file_version.encode())
    if values:
        out += _field(5, 2, b"".join(_field(1, 2, v) for v in values))
    return out


def _encode_png(hwc_uint8: np.ndarray) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(hwc_uint8).save(buf, format="PNG")
    return buf.getvalue()


class SummaryWriter:
    """Writes scalars and images to a new event file in ``logdir``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, f"events.out.tfevents.{str(time.time())[:10]}."
                                         f"{socket.gethostname()}")
        self._file = open(self.path, "wb")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._file.write(header + struct.pack("<I", masked_crc32c(header)) + data
                         + struct.pack("<I", masked_crc32c(data)))

    def add_scalar(self, tag: str, value: float, step: int):
        self._write(_event(time.time(), step, values=[
            _field(1, 2, tag.encode()) + _field(2, 5, struct.pack("<f", float(value)))]))

    def add_image(self, tag: str, image_chw: np.ndarray, step: int):
        """``image_chw``: uint8, or float in [0, 1] scaled by 255 and cast
        to uint8 (tensorboardX's rule)."""
        hwc = np.asarray(image_chw).transpose(1, 2, 0)
        if hwc.dtype != np.uint8:
            hwc = (hwc * 255.0).astype(np.uint8)
        h, w, c = hwc.shape
        image = (_field(1, 0, _varint(h)) + _field(2, 0, _varint(w))
                 + _field(3, 0, _varint(c)) + _field(4, 2, _encode_png(hwc)))
        self._write(_event(time.time(), step, values=[
            _field(1, 2, tag.encode()) + _field(4, 2, image)]))

    def flush(self):
        self._file.flush()

    def close(self):
        if not self._file.closed:
            self._file.close()


def _parse(data: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of a protobuf message: an int for
    wire 0, bytes for 1, 2 and 5."""
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(data, pos)
        elif wire == 2:
            n, pos = _read_varint(data, pos)
            value, pos = data[pos:pos + n], pos + n
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            value, pos = data[pos:pos + n], pos + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield number, wire, value


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return result, pos


def read_events(path: str) -> List[Dict]:
    """The events of a file that :class:`SummaryWriter` wrote, each
    ``{"wall_time", "step", "file_version"?, "values": [{"tag",
    "simple_value" | "image": {"height", "width", "colorspace", "png"}}]}``;
    raises ``ValueError`` on a bad length or data CRC."""
    with open(path, "rb") as f:
        blob = f.read()
    events, pos = [], 0
    while pos < len(blob):
        header = blob[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        if struct.unpack("<I", blob[pos + 8:pos + 12])[0] != masked_crc32c(header):
            raise ValueError(f"{path}: bad length CRC at byte {pos}")
        data = blob[pos + 12:pos + 12 + length]
        (crc,) = struct.unpack("<I", blob[pos + 12 + length:pos + 16 + length])
        if len(data) != length or crc != masked_crc32c(data):
            raise ValueError(f"{path}: bad data CRC at byte {pos}")
        pos += 16 + length
        event = {"step": 0, "values": []}
        for number, _, value in _parse(data):
            if number == 1:
                event["wall_time"] = struct.unpack("<d", value)[0]
            elif number == 2:
                event["step"] = value
            elif number == 3:
                event["file_version"] = value.decode()
            elif number == 5:
                event["values"] += [_value(v) for n, _, v in _parse(value) if n == 1]
        events.append(event)
    return events


def _value(data: bytes) -> Dict:
    out = {}
    for number, _, value in _parse(data):
        if number == 1:
            out["tag"] = value.decode()
        elif number == 2:
            out["simple_value"] = struct.unpack("<f", value)[0]
        elif number == 4:
            fields = {n: v for n, _, v in _parse(value)}
            out["image"] = {"height": fields.get(1, 0), "width": fields.get(2, 0),
                            "colorspace": fields.get(3, 0), "png": fields.get(4, b"")}
    return out
