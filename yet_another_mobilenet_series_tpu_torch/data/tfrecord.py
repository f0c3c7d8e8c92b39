"""TFRecord shards and ``tf.train.Example`` records without TensorFlow or
protobuf (the card's machine has neither).

A record on disk is framed as TensorFlow frames it: a little-endian u64
length, the masked CRC-32C of those 8 bytes, the data, and the masked CRC-32C
of the data (masked: rotated right by 15 bits, plus 0xa282ead8). The reader
checks both CRCs (the CRC is ``yamt_crc32c`` of the host library) and raises
:class:`CorruptRecord` on a mismatch or a torn frame.

An ``Example`` is parsed from its wire format by hand: ``Features`` (field
1) holds map entries (field 1) of a string key (1) and a ``Feature`` (2),
whose ``bytes_list`` (1), ``float_list`` (2) or ``int64_list`` (3) holds
repeated values (field 1; numbers packed or not). Only what the ImageNet
shards carry is needed: ``image/encoded`` and ``image/class/label`` (1..1000,
so the label is that minus 1, as the JAX package reads it). The writer makes
records TensorFlow reads (``tests/test_torch_port_data.py`` holds both
directions against TensorFlow).

``_tfrecord_files``, ``_count_tfrecord_records`` and
``_host_records_per_epoch`` are the JAX package's
(``data/pipeline.py``), with the same results.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Iterator

import numpy as np

from ..config import DataConfig
from ..obs.registry import get_registry
from ..ops import host_build
from ..utils.logging import emit

_MASK_DELTA = 0xA282EAD8
IMAGE_KEY = "image/encoded"
LABEL_KEY = "image/class/label"


class CorruptRecord(ValueError):
    """A record whose framing or CRC is wrong, or whose Example does not parse."""


def crc32c(data: bytes) -> int:
    return int(host_build.load().yamt_crc32c(data, len(data), 0))


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + _MASK_DELTA) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


class TFRecordWriter:
    """Writes framed records to ``path`` (``with TFRecordWriter(p) as w:
    w.write(example_bytes)``)."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header + struct.pack("<I", masked_crc(header)) + data + struct.pack("<I", masked_crc(data)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "TFRecordWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def record_index(path: str) -> np.ndarray:
    """(n, 2) int64: each record's data offset and length, by walking the
    framing (8 bytes read and one seek per record). Raises
    :class:`CorruptRecord` when a length overruns the file."""
    out = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos < size:
            header = f.read(8)
            if len(header) < 8:
                raise CorruptRecord(f"truncated TFRecord framing in {path} at byte {pos}")
            (length,) = struct.unpack("<Q", header)
            if pos + 16 + length > size:
                raise CorruptRecord(f"TFRecord length field overruns {path} at byte {pos}")
            out.append((pos + 12, length))
            pos += 16 + length
            f.seek(pos)
    return np.asarray(out, dtype=np.int64).reshape(-1, 2)


def read_record(fd: int, offset: int, length: int) -> bytes:
    """The data of the record at ``offset`` (from :func:`record_index`) of
    the open file ``fd``, its two CRCs checked."""
    raw = os.pread(fd, length + 16, offset - 12)
    if len(raw) != length + 16:
        raise CorruptRecord(f"short read of a {length}-byte record at byte {offset - 12}")
    header, data = raw[:8], raw[12:12 + length]
    (len_crc,) = struct.unpack("<I", raw[8:12])
    (data_crc,) = struct.unpack("<I", raw[12 + length:])
    if struct.unpack("<Q", header)[0] != length or masked_crc(header) != len_crc:
        raise CorruptRecord(f"bad length CRC of the record at byte {offset - 12}")
    if masked_crc(data) != data_crc:
        raise CorruptRecord(f"bad data CRC of the record at byte {offset - 12}")
    return data


def iter_records(path: str) -> Iterator[bytes]:
    """Every record of one shard, in order, CRCs checked."""
    index = record_index(path)
    fd = os.open(path, os.O_RDONLY)
    try:
        for offset, length in index:
            yield read_record(fd, int(offset), int(length))
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# tf.train.Example wire format
# ---------------------------------------------------------------------------


def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise CorruptRecord("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise CorruptRecord("varint longer than 10 bytes")


def _fields(buf: bytes) -> Iterator[tuple[int, int, object]]:
    """(field number, wire type, value) of each field of a message: an int
    for varints and fixed widths, a bytes slice for length-delimited ones."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire in (1, 5):
            width = 8 if wire == 1 else 4
            if pos + width > len(buf):
                raise CorruptRecord("fixed-width field overruns its message")
            value, pos = int.from_bytes(buf[pos:pos + width], "little"), pos + width
        elif wire == 2:
            n, pos = _varint(buf, pos)
            if pos + n > len(buf):
                raise CorruptRecord("length-delimited field overruns its message")
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise CorruptRecord(f"unsupported wire type {wire}")
        yield field, wire, value


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _feature_values(buf: bytes) -> list:
    for kind, wire, lst in _fields(buf):
        if wire != 2:
            continue
        values = []
        for f, w, v in _fields(lst):
            if f != 1:
                continue
            if kind == 1 and w == 2:
                values.append(bytes(v))
            elif kind == 3 and w == 0:
                values.append(_signed64(v))
            elif kind == 3 and w == 2:  # packed int64
                pos = 0
                while pos < len(v):
                    x, pos = _varint(v, pos)
                    values.append(_signed64(x))
            elif kind == 2 and w == 5:
                values.append(struct.unpack("<f", struct.pack("<I", v))[0])
            elif kind == 2 and w == 2:  # packed float
                values.extend(struct.unpack(f"<{len(v) // 4}f", v))
        return values
    return []


def parse_example(data: bytes) -> dict[str, list]:
    """Every feature of a serialized ``tf.train.Example``, key -> values."""
    out: dict[str, list] = {}
    for field, wire, features in _fields(data):
        if field != 1 or wire != 2:
            continue
        for f, w, entry in _fields(features):
            if f != 1 or w != 2:
                continue
            key, value = None, b""
            for ef, ew, ev in _fields(entry):
                if ef == 1 and ew == 2:
                    key = bytes(ev).decode()
                elif ef == 2 and ew == 2:
                    value = ev
            if key is not None:
                out[key] = _feature_values(value)
    return out


def parse_image_example(data: bytes) -> tuple[bytes, int]:
    """(JPEG bytes, label) of an ImageNet record: ``image/encoded`` and
    ``image/class/label`` minus 1 (the shards store 1..1000)."""
    feats = parse_example(data)
    image, label = feats.get(IMAGE_KEY), feats.get(LABEL_KEY)
    if not image or not label:
        raise CorruptRecord(f"an Example without {IMAGE_KEY!r} and {LABEL_KEY!r}")
    return image[0], int(label[0]) - 1


def _key(field: int, wire: int) -> bytes:
    return _encode_varint((field << 3) | wire)


def _encode_varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _delimited(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _encode_varint(len(payload)) + payload


def build_example(features: dict) -> bytes:
    """A serialized ``tf.train.Example`` of ``{key: list of bytes or of ints}``
    (int64 lists packed, as TensorFlow writes them)."""
    entries = b""
    for key, values in features.items():
        if all(isinstance(v, (bytes, bytearray)) for v in values):
            lst = b"".join(_delimited(1, bytes(v)) for v in values)
            feature = _delimited(1, lst)
        elif all(isinstance(v, (int, np.integer)) for v in values):
            feature = _delimited(3, _delimited(1, b"".join(_encode_varint(int(v)) for v in values)))
        else:
            raise TypeError(f"feature {key!r}: values must be all bytes or all ints")
        entries += _delimited(1, _delimited(1, key.encode()) + _delimited(2, feature))
    return _delimited(1, entries)


def image_example(jpeg: bytes, label: int) -> bytes:
    """An ImageNet record: the JPEG and ``label + 1``."""
    return build_example({IMAGE_KEY: [jpeg], LABEL_KEY: [int(label) + 1]})


# ---------------------------------------------------------------------------
# shards and counts (the JAX package's functions)
# ---------------------------------------------------------------------------


def _tfrecord_files(cfg: DataConfig, split: str) -> list[str]:
    # shard names are {split}-00000-of-00128; the -of- keeps sidecars like
    # {split}-classes.txt out of the match
    pattern = os.path.join(cfg.data_dir, f"{split}-*-of-*")
    files = sorted(glob.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no TFRecord shards matching {pattern}")
    return files


# (path, size, mtime_ns) -> record count; survives repeated resumes within a
# process. A JSON sidecar next to the shards persists counts across processes
# (best-effort: data_dir may be read-only).
_RECORD_COUNT_CACHE: dict = {}


def _count_tfrecord_records(path: str) -> int:
    """Exact record count by walking the TFRecord wire framing — per record:
    u64 length, u32 masked-crc(length), data[length], u32 masked-crc(data).
    Reads 8 bytes + one seek per record (no decode, no crc check)."""
    n = 0
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos < size:
            header = f.read(8)
            if len(header) < 8:
                raise ValueError(f"truncated TFRecord framing in {path} at byte {pos}")
            (length,) = struct.unpack("<Q", header)
            pos += 8 + 4 + length + 4
            if pos > size:
                raise ValueError(f"TFRecord length field overruns {path} at byte {pos}")
            f.seek(pos)
            n += 1
    return n


def _host_records_per_epoch(cfg: DataConfig, host_files: list[str], files: list[str]) -> int:
    """THIS host's exact records-per-epoch, from actual per-shard counts
    (cached in-process and in a ``.record_counts.json`` sidecar beside the
    shards); the equal-shards estimate, counted in
    ``data.record_count_fallbacks`` and logged, only when a shard cannot be
    walked."""
    sidecar = os.path.join(cfg.data_dir, ".record_counts.json")
    disk: dict = {}
    try:
        with open(sidecar) as f:
            disk = json.load(f)
    except (OSError, ValueError):
        pass
    dirty = False
    total = 0
    try:
        for path in host_files:
            st = os.stat(path)
            key = (path, st.st_size, st.st_mtime_ns)
            skey = f"{os.path.basename(path)}:{st.st_size}:{st.st_mtime_ns}"
            if key in _RECORD_COUNT_CACHE:
                n = _RECORD_COUNT_CACHE[key]
            elif skey in disk:
                n = int(disk[skey])
                _RECORD_COUNT_CACHE[key] = n
            else:
                n = _count_tfrecord_records(path)
                _RECORD_COUNT_CACHE[key] = n
                disk[skey] = n
                dirty = True
            total += n
    except (OSError, ValueError) as e:
        est = max(-(-cfg.num_train_examples * len(host_files) // len(files)), 1)
        get_registry().counter("data.record_count_fallbacks").inc()
        emit(f"[data] WARNING: could not count TFRecord shards ({e}); resume "
             f"arithmetic falls back to the equal-shards estimate "
             f"({est} records/epoch) — exact resume is NOT guaranteed if "
             f"shards are uneven")
        return est
    if dirty:
        tmp = sidecar + f".tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(disk, f)
            os.replace(tmp, sidecar)
        except OSError:
            # read-only data_dir: in-process cache still holds
            try:
                os.unlink(tmp)
            except OSError:
                pass
    est = -(-cfg.num_train_examples * len(host_files) // len(files))
    get_registry().gauge("data.host_records_per_epoch").set(max(total, 1))
    if total != est:
        emit(f"[data] host shard records/epoch = {total} (counted; equal-shards "
             f"estimate was {est}) — using the exact count")
    return max(total, 1)
