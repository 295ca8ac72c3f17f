"""Dependency-free TensorBoard scalar event writer.

The port's copy of next3d_tpu/utils/tensorboard.py (stdlib only). The
reference logs per-tick stats to TensorBoard via torch.utils.tensorboard
(training_avatar_texture/training_loop.py:510-517). Neither tensorflow nor
tensorboard is available in this environment, so this module writes the
TFRecord-framed Event protobufs by hand — scalars only, which is all the
reference writes. Files are readable by standard TensorBoard.

Format: each record is
  uint64 length | uint32 masked_crc32c(length) | data | uint32 masked_crc32c(data)
with Event { double wall_time = 1; int64 step = 2;
             Summary summary = 5 { repeated Value value = 1
               { string tag = 1; float simple_value = 2; } } }.
"""

from __future__ import annotations

import os
import struct
import time

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        table = []
        for n in range(256):
            c = n
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
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b''
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _scalar_event(tag: str, value: float, step: int,
                  wall_time: float) -> bytes:
    t = tag.encode('utf-8')
    val = (_tag(1, 2) + _varint(len(t)) + t
           + _tag(2, 5) + struct.pack('<f', float(value)))
    summary = _tag(1, 2) + _varint(len(val)) + val
    return (_tag(1, 1) + struct.pack('<d', wall_time)
            + _tag(2, 0) + _varint(int(step))
            + _tag(5, 2) + _varint(len(summary)) + summary)


def _file_version_event(wall_time: float) -> bytes:
    v = b'brain.Event:2'
    return (_tag(1, 1) + struct.pack('<d', wall_time)
            + _tag(3, 2) + _varint(len(v)) + v)  # file_version = field 3


class SummaryWriter:
    """Minimal scalar-only drop-in for torch.utils.tensorboard's writer."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        fname = f'events.out.tfevents.{int(time.time())}.{os.getpid()}'
        self._f = open(os.path.join(log_dir, fname), 'wb')
        self._write_record(_file_version_event(time.time()))

    def _write_record(self, data: bytes):
        header = struct.pack('<Q', len(data))
        self._f.write(header)
        self._f.write(struct.pack('<I', _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack('<I', _masked_crc(data)))

    def add_scalar(self, tag, value, global_step=0, walltime=None):
        self._write_record(_scalar_event(
            tag, value, global_step, walltime or time.time()))

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def read_scalars(path):
    """Parse an event file written by SummaryWriter back into
    [(step, tag, value)] — used by tests and debugging (not a general
    protobuf parser; handles exactly the records this module writes)."""
    out = []
    with open(path, 'rb') as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from('<Q', data, pos)
        pos += 12  # header + header crc
        rec = data[pos:pos + length]
        pos += length + 4

        # decode the Event message
        def rd_varint(buf, p):
            n = shift = 0
            while True:
                b = buf[p]
                p += 1
                n |= (b & 0x7F) << shift
                if not b & 0x80:
                    return n, p
                shift += 7

        p = 0
        step = 0
        summary = None
        while p < len(rec):
            key, p = rd_varint(rec, p)
            field, wire = key >> 3, key & 7
            if wire == 1:
                val = rec[p:p + 8]
                p += 8
            elif wire == 5:
                val = rec[p:p + 4]
                p += 4
            elif wire == 0:
                val, p = rd_varint(rec, p)
            else:
                ln, p = rd_varint(rec, p)
                val = rec[p:p + ln]
                p += ln
            if field == 2 and wire == 0:
                step = val
            elif field == 5 and wire == 2:
                summary = val
        if summary is None:
            continue
        p = 0
        while p < len(summary):
            key, p = rd_varint(summary, p)
            ln, p = rd_varint(summary, p)
            value_msg = summary[p:p + ln]
            p += ln
            q = 0
            tag = None
            sv = None
            while q < len(value_msg):
                key, q = rd_varint(value_msg, q)
                field, wire = key >> 3, key & 7
                if wire == 2:
                    ln2, q = rd_varint(value_msg, q)
                    payload = value_msg[q:q + ln2]
                    q += ln2
                    if field == 1:
                        tag = payload.decode('utf-8')
                elif wire == 5:
                    if field == 2:
                        (sv,) = struct.unpack_from('<f', value_msg, q)
                    q += 4
                elif wire == 0:
                    _, q = rd_varint(value_msg, q)
                elif wire == 1:
                    q += 8
            if tag is not None and sv is not None:
                out.append((step, tag, sv))
    return out
