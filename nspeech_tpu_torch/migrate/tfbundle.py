"""From-spec reader for TensorFlow V2 checkpoint bundles — no TF import.

The reference trains with ``tf.train.Saver`` and restores with
``saver.restore`` (reference: neural_speech/synthesizer.py:37-38,
train.py / train_wavenet.py save paths), which writes the *tensor
bundle* format: a ``<prefix>.index`` table mapping variable names to
(shard, offset, size) plus ``<prefix>.data-00000-of-NNNNN`` shards of
raw little-endian tensor bytes.

This module implements that on-disk format from its public
specification so trained reference checkpoints can be imported into
the port without TensorFlow installed (a copy of the JAX package's
``nspeech_tpu/migrate/tfbundle.py``; the port imports nothing of it):

* ``.index`` is an SSTable (LevelDB table format): prefix-compressed
  key/value blocks, each followed by a 1-byte compression type and a
  masked CRC32C; a footer holding BlockHandles for the metaindex and
  index blocks and the magic ``0xdb4775248b80fb57``.
* Values are protobuf messages: the empty key maps to
  ``BundleHeaderProto`` (num_shards, endianness) and every other key is
  a variable name mapping to ``BundleEntryProto`` (dtype, shape,
  shard_id, offset, size, crc32c). A minimal hand-rolled protobuf
  wire-format decoder below covers exactly those messages.
* Tensor payloads are raw C-order little-endian bytes in the data
  shard, integrity-checked with the same masked CRC32C.

Both block and payload checksums are verified. Snappy block
decompression is implemented (also from spec) in case a table writer
compressed its blocks; TF's bundle writer emits uncompressed blocks.

The port's tests hold this reader bit for bit against checkpoints
written by the installed TensorFlow and against the JAX package's reader
(``tests/test_torch_migrate.py``).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_SIZE = 48  # 2 BlockHandles (max 20 bytes each) padded + 8-byte magic

# TF DataType enum -> numpy dtype (numeric types a Saver checkpoint can
# hold; DT_STRING tensors are not needed for weight import).
_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 9: np.int64, 10: np.bool_, 14: np.uint16,  # DT_BFLOAT16 bits
    17: np.uint16, 19: np.float16, 22: np.uint32, 23: np.uint64,
}
_DT_BFLOAT16 = 14


class BundleError(ValueError):
    """Malformed or corrupt checkpoint bundle."""


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven, with TF/LevelDB masking.
# ---------------------------------------------------------------------------

def _crc32c_table() -> List[int]:
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    tab = _CRC_TABLE
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """LevelDB/TF rotate-and-add masking of the raw CRC."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Varint / protobuf wire format primitives
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise BundleError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise BundleError("varint too long")


def _walk_proto(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message.

    value is int for varint/fixed, bytes for length-delimited.
    """
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # fixed64
            if pos + 8 > len(buf):
                raise BundleError("truncated fixed64")
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:  # length-delimited
            n, pos = _read_varint(buf, pos)
            if pos + n > len(buf):
                raise BundleError("truncated bytes field")
            val = buf[pos:pos + n]
            pos += n
        elif wire == 5:  # fixed32
            if pos + 4 > len(buf):
                raise BundleError("truncated fixed32")
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise BundleError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_shape(buf: bytes) -> Tuple[int, ...]:
    """TensorShapeProto: repeated Dim dim = 2 {int64 size = 1;}."""
    dims = []
    for field, _, val in _walk_proto(buf):
        if field == 2:  # dim
            size = 0
            for f2, _, v2 in _walk_proto(val):
                if f2 == 1:
                    size = v2
            dims.append(size)
        elif field == 3 and val:  # unknown_rank
            raise BundleError("unknown-rank tensor in bundle")
    return tuple(dims)


class BundleEntry:
    __slots__ = ("dtype_enum", "shape", "shard_id", "offset", "size",
                 "crc32c", "sliced")

    def __init__(self, buf: bytes):
        self.dtype_enum = 0
        self.shape: Tuple[int, ...] = ()
        self.shard_id = 0
        self.offset = 0
        self.size = 0
        self.crc32c: Optional[int] = None
        self.sliced = False
        for field, _, val in _walk_proto(buf):
            if field == 1:
                self.dtype_enum = val
            elif field == 2:
                self.shape = _parse_shape(val)
            elif field == 3:
                self.shard_id = val
            elif field == 4:
                self.offset = val
            elif field == 5:
                self.size = val
            elif field == 6:
                self.crc32c = val
            elif field == 7:
                self.sliced = True


def _parse_header(buf: bytes) -> int:
    """BundleHeaderProto -> num_shards (field 1). Big-endian bundles
    (field 2 == 1) are rejected; TF only writes them on BE hosts."""
    num_shards = 1
    for field, _, val in _walk_proto(buf):
        if field == 1:
            num_shards = val
        elif field == 2 and val == 1:
            raise BundleError("big-endian checkpoint bundles not supported")
    return num_shards


# ---------------------------------------------------------------------------
# Snappy block decompression (format spec: snappy/format_description.txt)
# ---------------------------------------------------------------------------

def snappy_decompress(buf: bytes) -> bytes:
    total, pos = _read_varint(buf, 0)
    if total > (1 << 31):
        raise BundleError("snappy block too large")
    out = bytearray()
    while pos < len(buf):
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            n = tag >> 2
            if n >= 60:
                extra = n - 59
                if pos + extra > len(buf):
                    raise BundleError("truncated snappy literal length")
                n = int.from_bytes(buf[pos:pos + extra], "little")
                pos += extra
            n += 1
            if pos + n > len(buf):
                raise BundleError("truncated snappy literal")
            out += buf[pos:pos + n]
            pos += n
            continue
        if kind == 1:  # copy, 1-byte offset
            length = ((tag >> 2) & 7) + 4
            if pos + 1 > len(buf):
                raise BundleError("truncated snappy copy1")
            offset = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            if pos + 2 > len(buf):
                raise BundleError("truncated snappy copy2")
            offset = int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            if pos + 4 > len(buf):
                raise BundleError("truncated snappy copy4")
            offset = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise BundleError("bad snappy copy offset")
        for _ in range(length):  # may overlap — byte-at-a-time is correct
            out.append(out[-offset])
    if len(out) != total:
        raise BundleError("snappy length mismatch")
    return bytes(out)


# ---------------------------------------------------------------------------
# SSTable block / footer parsing
# ---------------------------------------------------------------------------

def _decode_handle(buf: bytes, pos: int) -> Tuple[int, int, int]:
    offset, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return offset, size, pos


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    """Return verified, decompressed block contents."""
    end = offset + size
    if end + 5 > len(data):
        raise BundleError("block overruns file")
    contents = data[offset:end]
    ctype = data[end]
    stored = struct.unpack_from("<I", data, end + 1)[0]
    if stored != masked_crc32c(data[offset:end + 1]):
        raise BundleError("block checksum mismatch")
    if ctype == 0:
        return contents
    if ctype == 1:
        return snappy_decompress(contents)
    raise BundleError(f"unknown block compression type {ctype}")


def _block_entries(contents: bytes) -> List[Tuple[bytes, bytes]]:
    """Decode all (key, value) pairs of a prefix-compressed block."""
    if len(contents) < 4:
        raise BundleError("block too small")
    num_restarts = struct.unpack_from("<I", contents, len(contents) - 4)[0]
    data_end = len(contents) - 4 - 4 * num_restarts
    if data_end < 0:
        raise BundleError("bad restart array")
    entries = []
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _read_varint(contents, pos)
        non_shared, pos = _read_varint(contents, pos)
        value_len, pos = _read_varint(contents, pos)
        if shared > len(key) or pos + non_shared + value_len > data_end:
            raise BundleError("corrupt block entry")
        key = key[:shared] + contents[pos:pos + non_shared]
        pos += non_shared
        entries.append((key, contents[pos:pos + value_len]))
        pos += value_len
    return entries


class TFBundleReader:
    """Random-access reader over a ``tf.train.Saver`` checkpoint.

    >>> reader = TFBundleReader("/path/model.ckpt-5000")
    >>> reader.variable_names()
    ['wavenet/causal_layer/filter', ...]
    >>> w = reader.get_tensor("wavenet/causal_layer/filter")
    """

    def __init__(self, prefix: str):
        index_path = prefix + ".index"
        if not os.path.exists(index_path):
            raise FileNotFoundError(index_path)
        with open(index_path, "rb") as f:
            data = f.read()
        if len(data) < FOOTER_SIZE:
            raise BundleError("index file smaller than table footer")
        footer = data[-FOOTER_SIZE:]
        magic = struct.unpack_from("<Q", footer, FOOTER_SIZE - 8)[0]
        if magic != TABLE_MAGIC:
            raise BundleError("bad table magic — not a V2 checkpoint index")
        _, _, pos = _decode_handle(footer, 0)        # metaindex (unused)
        idx_off, idx_size, _ = _decode_handle(footer, pos)

        self._entries: Dict[bytes, BundleEntry] = {}
        num_shards = 1
        index_block = _read_block(data, idx_off, idx_size)
        for _, handle_val in _block_entries(index_block):
            blk_off, blk_size, _ = _decode_handle(handle_val, 0)
            for key, val in _block_entries(_read_block(data, blk_off,
                                                       blk_size)):
                if key == b"":
                    num_shards = _parse_header(val)
                else:
                    entry = BundleEntry(val)
                    if entry.sliced:
                        raise BundleError(
                            "partitioned (sliced) variables not supported")
                    self._entries[key] = entry

        self._prefix = prefix
        self._num_shards = num_shards
        self._shards: Dict[int, bytes] = {}

    # -- public API ---------------------------------------------------

    def variable_names(self) -> List[str]:
        return sorted(k.decode("utf-8") for k in self._entries)

    def has_tensor(self, name: str) -> bool:
        return name.encode("utf-8") in self._entries

    def shape(self, name: str) -> Tuple[int, ...]:
        return self._entry(name).shape

    def get_tensor(self, name: str) -> np.ndarray:
        entry = self._entry(name)
        np_dtype = _DTYPES.get(entry.dtype_enum)
        if np_dtype is None:
            raise BundleError(
                f"unsupported dtype enum {entry.dtype_enum} for '{name}'")
        shard = self._shard(entry.shard_id)
        if entry.offset + entry.size > len(shard):
            raise BundleError(f"tensor '{name}' overruns its data shard")
        raw = shard[entry.offset:entry.offset + entry.size]
        if entry.crc32c is not None and masked_crc32c(raw) != entry.crc32c:
            raise BundleError(f"tensor '{name}' failed its checksum")
        arr = np.frombuffer(raw, dtype=np.dtype(np_dtype).newbyteorder("<"))
        if entry.dtype_enum == _DT_BFLOAT16:
            # bfloat16 payload: upcast bits to float32 (numpy-native).
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        expected = int(np.prod(entry.shape, dtype=np.int64)) if entry.shape \
            else 1
        if arr.size != expected:
            raise BundleError(
                f"tensor '{name}' size {arr.size} != shape {entry.shape}")
        return arr.reshape(entry.shape).copy()

    def as_dict(self) -> Dict[str, np.ndarray]:
        return {name: self.get_tensor(name) for name in self.variable_names()}

    def close(self) -> None:
        """Drop the data shards read so far (the reader keeps no file
        open; a shard stays in memory once a tensor of it was read)."""
        self._shards.clear()

    def __enter__(self) -> "TFBundleReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- internals ----------------------------------------------------

    def _entry(self, name: str) -> BundleEntry:
        try:
            return self._entries[name.encode("utf-8")]
        except KeyError:
            raise KeyError(
                f"variable '{name}' not in checkpoint "
                f"(have {len(self._entries)} entries)") from None

    def _shard(self, shard_id: int) -> bytes:
        if shard_id not in self._shards:
            path = (f"{self._prefix}.data-{shard_id:05d}-of-"
                    f"{self._num_shards:05d}")
            if not os.path.exists(path):
                raise BundleError(f"missing data shard {path}")
            with open(path, "rb") as f:
                self._shards[shard_id] = f.read()
        return self._shards[shard_id]
