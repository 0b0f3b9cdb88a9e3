"""Windowed meters and tensorboard event files (reference
utils/metric_logger.py:7-83, utils/misc.py:11-12).

The port's own copy of `SmoothedValue`, `MetricLogger`, `prefix_dict` and
`TensorboardWriter` from epipolar_transformers_tpu/utils/metric_logger.py;
the train loop logs the window values and the eval engine averages its
per-group metrics with them.  The JAX writer goes through tensorboardX and
writes nothing where that package is missing; the port writes the event
files itself, with no dependency: records of a little-endian u64 length,
its masked CRC-32C, an `Event` protobuf and the data's masked CRC-32C
(tensorboard's TFRecord framing), the first holding the file version, each
other one a scalar `Summary` (tag, simple_value) at its step.
`read_scalars` reads them back, checking every CRC.
"""

from __future__ import annotations

import glob
import os
import socket
import struct
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, List, Tuple

import numpy as np


class SmoothedValue:
    """Track a series of values and provide access to smoothed values over a
    window (20) plus the global average."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value):
        value = float(value)
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if hasattr(v, "item"):
                v = float(v)
            self.meters[k].update(v)

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})" for name, m in self.meters.items()
        )

    def get_all_avg(self):
        return {name: m.global_avg for name, m in self.meters.items()}


def prefix_dict(d: dict, prefix: str) -> dict:
    """reference utils/misc.py:11-12."""
    return {f"{prefix}/{k}": v for k, v in d.items()}


def _crc32c_table() -> List[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def masked_crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of `data`, masked as TFRecord masks it."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # a negative int64 as protobuf writes it
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, file_version: str = "",
           scalars: Tuple[Tuple[str, float], ...] = ()) -> bytes:
    """An `Event` protobuf: wall_time (1, double), step (2, int64),
    file_version (3) or summary (5) of Summary.Value{tag (1),
    simple_value (2, float)}."""
    out = b"\x09" + struct.pack("<d", wall_time)
    if step:
        out += b"\x10" + _varint(step)
    if file_version:
        out += _field(3, file_version.encode())
    if scalars:
        values = b"".join(_field(1, _field(1, tag.encode()) + b"\x15" + struct.pack("<f", v))
                          for tag, v in scalars)
        out += _field(5, values)
    return out


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data
            + struct.pack("<I", masked_crc32c(data)))


class TensorboardWriter:
    """Scalar writer with the reference's train//test tag convention
    (reference utils/metric_logger.py:52-60): one event file in `log_dir`,
    `events.out.tfevents.<time>.<host>`, flushed after each `write`."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self.file = None
        if enabled and log_dir:
            os.makedirs(log_dir, exist_ok=True)
            now = time.time()
            self.path = os.path.join(
                log_dir, f"events.out.tfevents.{int(now)}.{socket.gethostname()}")
            self.file = open(self.path, "ab")
            self.file.write(_record(_event(now, file_version="brain.Event:2")))
            self.file.flush()

    def write(self, metrics: dict, step: int, tag: str = "train"):
        if self.file is None:
            return
        scalars = []
        for k, v in metrics.items():
            try:
                scalars.append((f"{tag}/{k}", float(v)))
            except (TypeError, ValueError):
                continue
        self.file.write(b"".join(_record(_event(time.time(), step, scalars=(s,)))
                                 for s in scalars))
        self.file.flush()

    def close(self):
        if self.file is not None:
            self.file.close()
            self.file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of a protobuf message."""
    i = 0

    def varint():
        nonlocal i
        shift = n = 0
        while True:
            b = buf[i]
            i += 1
            n |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return n

    while i < len(buf):
        key = varint()
        number, wire = key >> 3, key & 7
        if wire == 0:
            yield number, wire, varint()
        elif wire == 1:
            yield number, wire, buf[i:i + 8]
            i += 8
        elif wire == 5:
            yield number, wire, buf[i:i + 4]
            i += 4
        elif wire == 2:
            n = varint()
            yield number, wire, buf[i:i + n]
            i += n
        else:
            raise ValueError(f"protobuf wire type {wire} is not read here")


def read_records(path: str) -> Iterator[bytes]:
    """The records of a TFRecord file, each CRC checked."""
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        if struct.unpack("<I", data[i + 8:i + 12])[0] != masked_crc32c(header):
            raise ValueError(f"{path}: a record's length fails its CRC at byte {i}")
        body = data[i + 12:i + 12 + n]
        if struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] != masked_crc32c(body):
            raise ValueError(f"{path}: a record fails its CRC at byte {i}")
        yield body
        i += 16 + n


def read_scalars(log_dir: str) -> Dict[str, List[Tuple[int, float]]]:
    """{tag: [(step, value), ...]} of the scalar summaries in the event files
    of `log_dir`, in the order written."""
    out: Dict[str, List[Tuple[int, float]]] = defaultdict(list)
    for path in sorted(glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))):
        for record in read_records(path):
            event = {number: value for number, _, value in _fields(record)}
            step = event.get(2, 0)
            for number, _, value in _fields(event.get(5, b"")):
                if number != 1:
                    continue
                v = dict((n, x) for n, _, x in _fields(value))
                if 2 in v:
                    out[v[1].decode()].append((step, struct.unpack("<f", v[2])[0]))
    return dict(out)
