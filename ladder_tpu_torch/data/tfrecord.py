"""TFRecord I/O without TensorFlow: record framing, a minimal
tf.train.Example wire-format codec, and an indexed random-access reader.

The port's copy of ``ladder_tpu/data/tfrecord.py``; a file written by
either package is byte-identical to the other's, and both read the same
files. The reference streams CelebA from TFRecord files through tf.data
(its codes/models.py:346-390: TFRecordDataset -> parse 'X' bytes feature ->
reshape [128,128,3] -> /255). These files are read directly:

  record frame: [len: uint64 LE][masked crc32c(len): 4B]
                [payload: len bytes][masked crc32c(payload): 4B]
  payload: tf.train.Example proto; feature map entry 'X' -> BytesList with
  one raw uint8 buffer of dx*dy*dc bytes.

Images stay uint8 up to the device; the train step divides by 255 there.
The reader mmaps the file and builds an offset index once, giving O(1)
random access for shuffled epochs. The C++ reader (ladder_tpu_torch/
runtime) does the same indexing and batch assembly with a thread pool; this
module is the plain Python version beside it and the writer that builds
datasets.
"""

from __future__ import annotations

import mmap
import os
import struct

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (Castagnoli); readers skip verification, as tf.data does by default
# ---------------------------------------------------------------------------

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = np.zeros(256, dtype=np.uint32)
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table[i] = crc
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c_reference(data: bytes) -> int:
    """The table loop: the plain version of ``crc32c``."""
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ int(table[(crc ^ b) & 0xFF])
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    """CRC32C through the native library's hardware crc32 (about 1000x the
    table loop: 9 ms -> ~10 us per 48 KiB image record, which dominated
    TFRecord writing). Raises when the library cannot be built; the values
    equal crc32c_reference's."""
    from ladder_tpu_torch.runtime import native_crc32c

    return native_crc32c(data)


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# minimal protobuf wire helpers (only what tf.train.Example needs)
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


def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _ld_field(field_no: int, payload: bytes) -> bytes:
    """length-delimited field (wire type 2)."""
    return _varint((field_no << 3) | 2) + _varint(len(payload)) + payload


def encode_example_bytes(key: str, raw: bytes) -> bytes:
    """tf.train.Example{features{feature{key -> bytes_list{value: raw}}}}."""
    bytes_list = _ld_field(1, raw)              # BytesList.value
    feature = _ld_field(1, bytes_list)          # Feature.bytes_list
    entry = _ld_field(1, key.encode()) + _ld_field(2, feature)  # map entry
    features = _ld_field(1, entry)              # Features.feature
    return _ld_field(1, features)               # Example.features


def parse_example_bytes(buf: bytes, key: str = "X") -> bytes:
    """Extract the first bytes value of `key` from a serialized Example."""
    def walk_ld(buf, pos, end):
        """yield (field_no, start, stop) for length-delimited fields."""
        while pos < end:
            tag, pos = _read_varint(buf, pos)
            wire = tag & 7
            field = tag >> 3
            if wire == 2:
                ln, pos = _read_varint(buf, pos)
                yield field, pos, pos + ln
                pos += ln
            elif wire == 0:
                _, pos = _read_varint(buf, pos)
            elif wire == 5:
                pos += 4
            elif wire == 1:
                pos += 8
            else:
                raise ValueError(f"unsupported wire type {wire}")

    for f1, s1, e1 in walk_ld(buf, 0, len(buf)):          # Example.features
        if f1 != 1:
            continue
        for f2, s2, e2 in walk_ld(buf, s1, e1):           # Features.feature*
            if f2 != 1:
                continue
            entry_key = None
            feat_span = None
            for f3, s3, e3 in walk_ld(buf, s2, e2):       # map entry
                if f3 == 1:
                    entry_key = bytes(buf[s3:e3]).decode()
                elif f3 == 2:
                    feat_span = (s3, e3)
            if entry_key != key or feat_span is None:
                continue
            for f4, s4, e4 in walk_ld(buf, *feat_span):   # Feature.bytes_list
                if f4 != 1:
                    continue
                for f5, s5, e5 in walk_ld(buf, s4, e4):   # BytesList.value
                    if f5 == 1:
                        return bytes(buf[s5:e5])
    raise KeyError(f"feature {key!r} not found in Example")


# ---------------------------------------------------------------------------
# record-level I/O
# ---------------------------------------------------------------------------

def write_tfrecords(path, payloads):
    """Write serialized payloads as a TFRecord file (with valid CRCs)."""
    with open(path, "wb") as f:
        for payload in payloads:
            length = struct.pack("<Q", len(payload))
            f.write(length)
            f.write(struct.pack("<I", masked_crc32c(length)))
            f.write(payload)
            f.write(struct.pack("<I", masked_crc32c(payload)))


def write_image_tfrecords(path, images_uint8, key="X"):
    """images_uint8 [N,H,W,C] -> TFRecord of Examples with raw-bytes feature
    `key` (the reference's CelebA layout, models.py:354-367)."""
    imgs = np.ascontiguousarray(images_uint8, dtype=np.uint8)
    write_tfrecords(
        path, (encode_example_bytes(key, img.tobytes()) for img in imgs))


def index_tfrecords(path):
    """One pass over the record framing; returns [N,2] int64 (offset, length)
    of each payload."""
    offsets = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        pos = 0
        while pos + 12 <= size:
            (length,) = struct.unpack_from("<Q", mm, pos)
            payload_start = pos + 12
            offsets.append((payload_start, length))
            pos = payload_start + length + 4
        mm.close()
    return np.asarray(offsets, dtype=np.int64).reshape(-1, 2)


class ImageRecordReader:
    """Indexed random-access reader for image TFRecords.

    Decodes payload -> raw uint8 image [H,W,C]. Thread-safe for reads (mmap).
    """

    def __init__(self, path, shape, key="X"):
        self.path = path
        self.shape = tuple(shape)
        self.key = key
        self.index = index_tfrecords(path)
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self.n = len(self.index)

    def __len__(self):
        return self.n

    def read(self, i):
        off, ln = self.index[i]
        payload = self._mm[off:off + ln]
        raw = parse_example_bytes(payload, self.key)
        return np.frombuffer(raw, dtype=np.uint8).reshape(self.shape)

    def read_batch(self, idxs, out=None):
        """uint8 [n, *shape] of the records ``idxs``, into ``out`` when it
        is given (as the native reader's read_batch)."""
        return np.stack([self.read(int(i)) for i in idxs], out=out)

    def close(self):
        self._mm.close()
        self._file.close()
