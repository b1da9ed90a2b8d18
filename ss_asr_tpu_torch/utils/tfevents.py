"""Copied from ``ss_asr_tpu/utils/tfevents.py``.

Native TensorBoard event-file writer — no tensorboardX/tensorflow needed.

Writes scalar summaries in the tfevents format TensorBoard reads: protobuf
Event messages (hand-encoded wire format — the schema is three nested
messages) inside TFRecord framing (length + masked CRC32C). Used by
``utils.logging.MetricLogger`` as the fallback when tensorboardX is absent,
so TensorBoard observability is a zero-dependency guarantee of the
framework rather than an optional extra.

Wire schema (tensorflow/core/util/event.proto):
    Event  { 1: double wall_time; 2: int64 step; 3: bytes file_version;
             5: Summary summary }
    Summary{ 1: repeated Value value }
    Value  { 1: string tag; 2: float simple_value }
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Iterator, List, Tuple

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven — TFRecord's integrity checksum
# ---------------------------------------------------------------------------

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire encoding
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, v: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", v)


def _field_float(num: int, v: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", v)


def _field_varint(num: int, v: int) -> bytes:
    return _varint(num << 3) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           summary: bytes | None = None) -> bytes:
    out = _field_double(1, wall_time)
    if step is not None:
        out += _field_varint(2, step)
    if file_version is not None:
        out += _field_bytes(3, file_version.encode())
    if summary is not None:
        out += _field_bytes(5, summary)
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    return _field_bytes(1, val)


# ---------------------------------------------------------------------------
# Writer / reader
# ---------------------------------------------------------------------------

class EventWriter:
    """Append-only tfevents file with scalar support."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._f = open(os.path.join(logdir, name), "ab")
        self._record(_event(time.time(), file_version="brain.Event:2"))

    def _record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))
        self._f.flush()

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_event(time.time(), step=step,
                            summary=_scalar_summary(tag, value)))

    def close(self) -> None:
        self._f.close()


def read_records(path: str, verify: bool = True) -> Iterator[bytes]:
    """TFRecord stream reader (for tests / inspection)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if verify:
                assert hcrc == _masked_crc(header), "header CRC mismatch"
                assert dcrc == _masked_crc(data), "data CRC mismatch"
            yield data


def _read_fields(data: bytes) -> Iterator[Tuple[int, int, bytes | int]]:
    """Decode top-level (field_num, wire_type, value) triples."""
    i = 0

    def varint():
        nonlocal i
        n = shift = 0
        while True:
            b = data[i]
            i += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7

    while i < len(data):
        key = varint()
        num, wt = key >> 3, key & 7
        if wt == 0:
            yield num, wt, varint()
        elif wt == 1:
            yield num, wt, data[i : i + 8]
            i += 8
        elif wt == 2:
            ln = varint()
            yield num, wt, data[i : i + ln]
            i += ln
        elif wt == 5:
            yield num, wt, data[i : i + 4]
            i += 4
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wt}")


def read_scalars(path: str) -> List[Tuple[str, float, int]]:
    """Parse (tag, value, step) scalars back out of a tfevents file."""
    out: List[Tuple[str, float, int]] = []
    for rec in read_records(path):
        step, summary = 0, None
        for num, wt, val in _read_fields(rec):
            if num == 2 and wt == 0:
                step = int(val)
            elif num == 5 and wt == 2:
                summary = val
        if summary is None:
            continue
        for num, wt, val in _read_fields(summary):
            if num != 1 or wt != 2:
                continue
            tag, simple = None, None
            for n2, w2, v2 in _read_fields(val):
                if n2 == 1 and w2 == 2:
                    tag = v2.decode()
                elif n2 == 2 and w2 == 5:
                    (simple,) = struct.unpack("<f", v2)
            if tag is not None and simple is not None:
                out.append((tag, simple, step))
    return out
