"""TensorBoard scalar events in pure Python: a port-local copy of
vqcpcb_tpu/training/tb_writer.py, so the metrics path needs neither
tensorflow nor torch's tensorboard writer (which imports the tensorboard
package).

It hand-encodes the two protos TensorBoard reads for scalars:

  TFRecord framing: [len u64][masked crc32c(len)][payload][masked crc32c(payload)]
  Event proto     : 1=wall_time double, 2=step int64, 3=file_version string,
                    5=Summary{ 1=Value{ 1=tag string, 2=simple_value float } }

(format per tensorflow/core/util/event.proto + record_writer.cc; the
"brain.Event:2" header is that version marker).
"""
from __future__ import annotations

import os
import socket
import struct
import time

# ---- crc32c (Castagnoli, reflected poly 0x82F63B78) --------------------------

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _crc = _i
    for _ in range(8):
        _crc = (_crc >> 1) ^ (_POLY if _crc & 1 else 0)
    _TABLE.append(_crc)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---- minimal protobuf encoding ------------------------------------------------

def _varint(n: int) -> bytes:
    if n < 0:
        # proto varints encode negative int64 as 10-byte two's complement;
        # Python's arithmetic right shift would otherwise never terminate
        n += 1 << 64
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def encode_scalar_summary(tag: str, value: float) -> bytes:
    t = tag.encode("utf-8")
    val = (_key(1, 2) + _varint(len(t)) + t
           + _key(2, 5) + struct.pack("<f", float(value)))
    return _key(1, 2) + _varint(len(val)) + val


def encode_event(wall_time: float, step: int = 0,
                 file_version: str = "", summary: bytes = b"") -> bytes:
    out = _key(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _key(2, 0) + _varint(step)
    if file_version:
        fv = file_version.encode("utf-8")
        out += _key(3, 2) + _varint(len(fv)) + fv
    if summary:
        out += _key(5, 2) + _varint(len(summary)) + summary
    return out


# ---- writer -------------------------------------------------------------------

class SummaryWriter:
    """The add_scalar / flush / close subset of a TensorBoard
    SummaryWriter, writing TensorBoard-readable event files."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}.v2")
        self._path = os.path.join(log_dir, fname)
        self._file = open(self._path, "ab")
        self._write_record(encode_event(time.time(),
                                        file_version="brain.Event:2"))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._file.write(header)
        self._file.write(struct.pack("<I", masked_crc(header)))
        self._file.write(payload)
        self._file.write(struct.pack("<I", masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, global_step: int = 0) -> None:
        self._write_record(encode_event(
            time.time(), step=global_step,
            summary=encode_scalar_summary(tag, value)))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self._file.flush()
            self._file.close()


def read_scalars(path: str):
    """Decode an event file back to [(step, tag, value)] — the inverse of the
    writer, used by tests and for headless inspection."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f"truncated record header at byte {pos}")
        (length,) = struct.unpack_from("<Q", data, pos)
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        if hcrc != masked_crc(data[pos:pos + 8]):
            raise ValueError(f"header crc mismatch at byte {pos}")
        if pos + 12 + length + 4 > len(data):
            raise ValueError(f"truncated record payload at byte {pos}")
        payload = data[pos + 12:pos + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        if pcrc != masked_crc(payload):
            raise ValueError(f"payload crc mismatch at byte {pos}")
        pos += 12 + length + 4
        out.extend(_decode_event_scalars(payload))
    return out


def _decode_varint(buf: bytes, pos: int):
    n = shift = 0
    while True:
        b = buf[pos]
        n |= (b & 0x7F) << shift
        pos += 1
        if not b & 0x80:
            return n, pos
        shift += 7


def _decode_fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        key, pos = _decode_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _decode_varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            ln, pos = _decode_varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        elif wire == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, val


def _decode_event_scalars(payload: bytes):
    step = 0
    values = []
    for field, wire, val in _decode_fields(payload):
        if field == 2 and wire == 0:
            step = val
        elif field == 5 and wire == 2:              # Summary
            for f2, w2, v2 in _decode_fields(val):
                if f2 == 1 and w2 == 2:             # Summary.Value
                    tag, scalar = None, None
                    for f3, w3, v3 in _decode_fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag = v3.decode("utf-8")
                        elif f3 == 2 and w3 == 5:
                            (scalar,) = struct.unpack("<f", v3)
                    if tag is not None and scalar is not None:
                        values.append((tag, scalar))
    return [(step, tag, scalar) for tag, scalar in values]
