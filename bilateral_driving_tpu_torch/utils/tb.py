"""TensorBoard event files without the tensorboard package: port of
bilateral_driving_tpu/utils/tb.py.

The JAX package writes through torch.utils.tensorboard, which needs the
`tensorboard` package; the card has none, so `TBWriter` encodes the file
itself. An event file is a sequence of TFRecords (little-endian uint64
length, its masked CRC-32C, the payload, the payload's masked CRC-32C),
each payload an `Event` protocol buffer: first one with `file_version`
"brain.Event:2", then one per scalar (`Summary.Value.simple_value`) or
image (`Summary.Image`, PNG from utils/visualization.png_bytes)
with its wall time and step, as torch's SummaryWriter writes them.
`read_events` reads such a file back, checking every CRC. `WandbWriter`
is the JAX package's: a no-op unless wandb is installed and enabled.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, Optional

import numpy as np

from . import visualization

FILE_VERSION = "brain.Event:2"


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord frames its records."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame_record(payload: bytes) -> bytes:
    """One TFRecord: length, masked CRC of the length, payload, masked CRC
    of the payload."""
    head = struct.pack("<Q", len(payload))
    return (head + struct.pack("<I", masked_crc(head)) + payload
            + struct.pack("<I", masked_crc(payload)))


# -- protocol buffer encoding (the few fields an event file needs) --------

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1          # int64: negatives as 10-byte two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _event(wall_time: float, step: int, body: bytes) -> bytes:
    """Event: wall_time (1, double), step (2, int64), then the oneof."""
    head = _key(1, 1) + struct.pack("<d", wall_time)
    if step:
        head += _key(2, 0) + _varint(step)
    return head + body


def _scalar_value(tag: str, value: float) -> bytes:
    """Summary.Value: tag (1), simple_value (2, float)."""
    return (_bytes_field(1, tag.encode()) + _key(2, 5)
            + struct.pack("<f", value))


def _image_value(tag: str, height: int, width: int, png: bytes) -> bytes:
    """Summary.Value: tag (1), image (4): Summary.Image height (1), width
    (2), colorspace (3; 3 = RGB), encoded_image_string (4)."""
    img = (_key(1, 0) + _varint(height) + _key(2, 0) + _varint(width)
           + _key(3, 0) + _varint(3) + _bytes_field(4, png))
    return _bytes_field(1, tag.encode()) + _bytes_field(4, img)


def _summary(values) -> bytes:
    """Event.summary (5): Summary of repeated Value (1)."""
    return _bytes_field(5, b"".join(_bytes_field(1, v) for v in values))


class TBWriter:
    """Scalars and images into `<log_dir>/events.out.tfevents.*`; each
    record is encoded whole and written with one write, then flushed, so
    a failure leaves no partial record."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time()):010d}."
            f"{socket.gethostname()}.{os.getpid()}.{id(self)}")
        self._f = open(self.path, "wb")
        self._write(_event(time.time(), 0,
                           _bytes_field(3, FILE_VERSION.encode())))

    def _write(self, payload: bytes) -> None:
        self._f.write(frame_record(payload))
        self._f.flush()

    def scalars(self, metrics: Dict[str, float], step: int) -> None:
        """One event per tag; values that are not numbers (lpips=None) are
        left out, as the JAX package's writer leaves them."""
        for k, v in metrics.items():
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            self._write(_event(time.time(), int(step),
                               _summary([_scalar_value(k, v)])))

    def image(self, tag: str, img_hwc: np.ndarray, step: int) -> None:
        arr = np.asarray(img_hwc, np.float32)
        png = visualization.png_bytes(arr)
        self._write(_event(time.time(), int(step), _summary(
            [_image_value(tag, arr.shape[0], arr.shape[1], png)])))

    def close(self) -> None:
        self._f.close()


# -- reading -------------------------------------------------------------

def _fields(buf: bytes) -> Iterator[tuple]:
    """(field number, wire type, value) of a protocol buffer message;
    length-delimited values as bytes, varints as ints, fixed64 / fixed32
    as their 8 / 4 raw bytes."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = _read_varint(buf, i)
            val, i = buf[i:i + n], i + n
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"wire type {wire} at byte {i}")
        yield field, wire, val


def _read_varint(buf: bytes, i: int):
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _parse_event(payload: bytes) -> dict:
    ev = {"wall_time": None, "step": 0, "file_version": None, "values": []}
    for field, _, val in _fields(payload):
        if field == 1:
            ev["wall_time"] = struct.unpack("<d", val)[0]
        elif field == 2:
            ev["step"] = val - (1 << 64) if val >= 1 << 63 else val
        elif field == 3:
            ev["file_version"] = val.decode()
        elif field == 5:
            for f, _, v in _fields(val):
                if f == 1:
                    ev["values"].append(_parse_value(v))
    return ev


def _parse_value(buf: bytes) -> dict:
    out = {}
    for field, _, val in _fields(buf):
        if field == 1:
            out["tag"] = val.decode()
        elif field == 2:
            out["simple_value"] = struct.unpack("<f", val)[0]
        elif field == 4:
            img = {}
            for f, _, v in _fields(val):
                img[{1: "height", 2: "width", 3: "colorspace",
                     4: "encoded_image_string"}.get(f, f)] = v
            out["image"] = img
    return out


def read_events(path: str) -> list:
    """Every event of an event file as a dict (wall_time, step,
    file_version, values: [{tag, simple_value | image}]); raises on a
    truncated record or a CRC that does not match."""
    with open(path, "rb") as f:
        data = f.read()
    events, i = [], 0
    while i < len(data):
        if i + 12 > len(data):
            raise ValueError(f"{path}: truncated record header at {i}")
        head = data[i:i + 8]
        (n,) = struct.unpack("<Q", head)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        if crc != masked_crc(head):
            raise ValueError(f"{path}: length CRC mismatch at {i}")
        payload = data[i + 12:i + 12 + n]
        if len(payload) != n or i + 16 + n > len(data):
            raise ValueError(f"{path}: truncated record at {i}")
        (crc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if crc != masked_crc(payload):
            raise ValueError(f"{path}: payload CRC mismatch at {i}")
        events.append(_parse_event(payload))
        i += 16 + n
    return events


class WandbWriter:
    """wandb adapter (reference tools/train.py:64-80 inits wandb with a
    retry loop). A no-op unless `enable` and the `wandb` package imports;
    offline mode when no API key is set, so a run never waits on a
    network."""

    def __init__(self, enable: bool, project: str, run_name: str,
                 config: Optional[dict] = None, log_dir: Optional[str] = None):
        self._run = None
        if not enable:
            return
        try:
            import wandb
        except ImportError:
            return
        if not os.environ.get("WANDB_API_KEY"):
            os.environ.setdefault("WANDB_MODE", "offline")
        for _ in range(3):   # retry loop (train.py:66-76)
            try:
                self._run = wandb.init(project=project, name=run_name,
                                       config=config, dir=log_dir,
                                       reinit=True)
                break
            except Exception:
                continue

    @property
    def active(self) -> bool:
        return self._run is not None

    def scalars(self, metrics: Dict[str, float], step: int) -> None:
        if self._run is None:
            return
        clean = {}
        for k, v in metrics.items():
            try:
                clean[k] = float(v)
            except (TypeError, ValueError):
                continue   # non-numeric markers (lpips=None)
        self._run.log(clean, step=step)

    def image(self, tag: str, img_hwc: np.ndarray, step: int) -> None:
        if self._run is None:
            return
        import wandb

        arr = np.clip(np.asarray(img_hwc, np.float32), 0, 1)
        self._run.log({tag: wandb.Image(arr)}, step=step)

    def close(self) -> None:
        if self._run is not None:
            self._run.finish()
