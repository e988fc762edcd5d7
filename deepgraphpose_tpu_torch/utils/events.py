"""TensorBoard-compatible scalar event files, dependency-free.

The port's own copy of ``deepgraphpose_tpu/utils/events.py``: for the same
scalars, step and wall time it writes the same bytes. The reference logs
per-term losses as TF summaries during training
(ref: deeplabcut/pose_estimation_tensorflow/train.py:131-133;
src/deepgraphpose/models/fitdgp.py:128-130). This writer produces the same
``events.out.tfevents.*`` files TensorBoard reads, encoding the Event
protobuf and TFRecord framing by hand, so training never imports
TensorFlow.

Wire format notes:
* TFRecord framing: u64 length | masked crc32c(length) | payload |
  masked crc32c(payload); mask(c) = ((c >> 15 | c << 17) + 0xa282ead8).
* Event proto: wall_time(1,double) step(2,int64) file_version(3,string)
  summary(5,message); Summary.value(1,repeated) { tag(1,string)
  simple_value(2,float) }.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path

# --- crc32c (Castagnoli), table-driven ------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    tbl = _crc_table()
    c = 0xFFFFFFFF
    for b in data:
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return ((c >> 15) | (c << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# --- minimal protobuf encoding ---------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _pb_string(field: int, s: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(s)) + s


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _event(step: int | None = None, file_version: str | None = None,
           scalars: dict | None = None, wall_time: float | None = None) -> bytes:
    msg = _pb_double(1, time.time() if wall_time is None else wall_time)
    if step is not None:
        msg += _pb_int64(2, int(step))
    if file_version is not None:
        msg += _pb_string(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _pb_string(1, _pb_string(1, tag.encode()) +
                       _pb_float(2, float(val)))
            for tag, val in scalars.items())
        msg += _pb_string(5, summary)
    return msg


class ScalarEventWriter:
    """Append-only scalar summary writer (TensorBoard event file)."""

    _seq = 0  # distinguishes writers created within the same second

    def __init__(self, logdir: str | Path, filename_suffix: str = ""):
        logdir = Path(logdir)
        logdir.mkdir(parents=True, exist_ok=True)
        host = socket.gethostname()
        ScalarEventWriter._seq += 1
        self.path = logdir / (
            f"events.out.tfevents.{int(time.time())}.{host}.{os.getpid()}"
            f".{ScalarEventWriter._seq}{filename_suffix}")
        self._f = open(self.path, "wb")
        self._write(_event(file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalars(self, step: int, scalars: dict) -> None:
        """Write {tag: value} at one global step (one Event record)."""
        self._write(_event(step=step, scalars=scalars))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.add_scalars(step, {tag: value})

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
