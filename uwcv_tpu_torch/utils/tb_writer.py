"""Minimal TensorBoard event-file writer — no TensorFlow dependency (the
port's own copy of ``uwcv_tpu/utils/tb_writer.py``)
(SURVEY.md C17: the reference's Colab workflow tails Detectron2's
``output/`` event stream with ``%tensorboard --logdir output``,
COLAB_PORT.py; Detectron2's trainer writes scalars via its EventStorage).

TensorBoard's on-disk format is a TFRecord stream of serialized ``Event``
protos.  Both layers are tiny and stable, so they are hand-rolled here:

- TFRecord framing: ``len:u64le | masked_crc32c(len):u32le | payload |
  masked_crc32c(payload):u32le`` with the Castagnoli polynomial and TF's
  mask ``((crc >> 15 | crc << 17) + 0xa282ead8)``;
- protobuf wire format for the 3 message types needed:
  ``Event{wall_time=1:double, step=2:int64, file_version=3:string,
  summary=5:msg}`` and ``Summary{value=1:repeated Value}``,
  ``Value{tag=1:string, simple_value=2:float}``.

Files named ``events.out.tfevents.<ts>.<host>`` are recognized by any
stock TensorBoard.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# protobuf wire-format encoding (just what Event needs)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _scalar_event(step: int, scalars: Dict[str, float],
                  wall_time: Optional[float] = None) -> bytes:
    summary = b"".join(
        _bytes(1, _bytes(1, tag.encode()) + _float(2, float(v)))
        for tag, v in scalars.items())
    return (_double(1, wall_time if wall_time is not None else time.time())
            + _int64(2, step) + _bytes(5, summary))


def _version_event() -> bytes:
    return _double(1, time.time()) + _bytes(3, b"brain.Event:2")


class SummaryWriter:
    """writer = SummaryWriter(logdir); writer.add_scalars(step, {...})"""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}")
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._write_record(_version_event())

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header
                      + struct.pack("<I", _masked_crc(header))
                      + payload
                      + struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.add_scalars(step, {tag: value})

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        self._write_record(_scalar_event(step, scalars))
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# reader (for tests and offline inspection without TensorBoard)
# ---------------------------------------------------------------------------

def read_scalars(path: str):
    """Parse an event file back into [(step, {tag: value})] — validates
    framing CRCs, used by tests as the roundtrip oracle."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == _masked_crc(header), "header CRC mismatch"
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            assert pcrc == _masked_crc(payload), "payload CRC mismatch"
            step, scalars = _parse_event(payload)
            if scalars:
                out.append((step, scalars))
    return out


def _parse(buf: bytes):
    """Yield (field, wire, value) triples of one message."""
    i = 0
    while i < len(buf):
        key = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wire = key >> 3, key & 7
        if wire == 0:
            v = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
        elif wire == 1:
            v = buf[i:i + 8]
            i += 8
        elif wire == 5:
            v = buf[i:i + 4]
            i += 4
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            v = buf[i:i + ln]
            i += ln
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, v


def _parse_event(payload: bytes):
    step, scalars = 0, {}
    for field, wire, v in _parse(payload):
        if field == 2 and wire == 0:
            step = v
        elif field == 5 and wire == 2:        # summary
            for f2, w2, v2 in _parse(v):
                if f2 == 1 and w2 == 2:       # value
                    tag, val = None, None
                    for f3, w3, v3 in _parse(v2):
                        if f3 == 1 and w3 == 2:
                            tag = v3.decode()
                        elif f3 == 2 and w3 == 5:
                            (val,) = struct.unpack("<f", v3)
                    if tag is not None and val is not None:
                        scalars[tag] = val
    return step, scalars
