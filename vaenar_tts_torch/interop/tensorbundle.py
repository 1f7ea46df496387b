"""Reader and writer for TensorFlow TensorBundle checkpoints, numpy only
(the port's own copy of ``vaenar_tts_tpu/interop/tensorbundle.py``).

This is the on-disk format of ``tf.train.Checkpoint``: what the reference
implementation saves while it trains and what its published pretrained
models ship as. A bundle is:

  ``{prefix}.index``              an SSTable (LevelDB table format) mapping
                                  variable keys -> serialized BundleEntryProto
                                  (the empty key holds BundleHeaderProto)
  ``{prefix}.data-IIIII-of-NNNNN`` raw little-endian tensor bytes; each index
                                  entry records (shard_id, offset, size, crc32c)

No TensorFlow dependency: the SSTable block format, the varint protobuf
wire coding of the two bundle messages and the masked CRC32C are written
here from the public format, byte for byte as the JAX package's copy. One
difference: ``crc32c`` runs over many lanes of a buffer at once in numpy
and joins the lanes' CRCs by the CRC's linearity (the JAX package's copy
loops over the bytes in Python unless the ``google_crc32c`` package is
installed), so that a full-size checkpoint's checksums take a second, not
minutes, without that package.
"""

from __future__ import annotations

import math
import os
import re
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_TABLE_MAGIC = 0xDB4775248B80FB57  # LevelDB/TF table footer magic
_FOOTER_SIZE = 48
_BLOCK_TRAILER_SIZE = 5  # 1B compression type + 4B masked crc32c
_NO_COMPRESSION = 0
_SNAPPY_COMPRESSION = 1
_RESTART_INTERVAL = 16
_BLOCK_SIZE_TARGET = 4096

# TF DataType enum values (tensorflow/core/framework/types.proto)
_DT_TO_NUMPY = {
    1: np.dtype("float32"), 2: np.dtype("float64"), 3: np.dtype("int32"),
    4: np.dtype("uint8"), 5: np.dtype("int16"), 6: np.dtype("int8"),
    9: np.dtype("int64"), 10: np.dtype("bool"), 17: np.dtype("uint16"),
    19: np.dtype("float16"), 22: np.dtype("uint32"), 23: np.dtype("uint64"),
}
_NUMPY_TO_DT = {v: k for k, v in _DT_TO_NUMPY.items()}
DT_STRING = 7
DT_BFLOAT16 = 14


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), with TF/LevelDB masking
# ---------------------------------------------------------------------------

def _make_crc_table() -> np.ndarray:
    poly = 0x82F63B78
    table = np.empty(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (poly if c & 1 else 0)
        table[i] = c
    return table


_CRC_TABLE = _make_crc_table()
_CRC_TABLE_LIST = [int(c) for c in _CRC_TABLE]
# buffers from this size on take the lane-parallel path
_LANES_MIN_BYTES = 2048


def _crc_update(reg: int, data) -> int:
    """Feed bytes to the CRC register, one at a time."""
    table = _CRC_TABLE_LIST
    for b in data:
        reg = table[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


def _apply(op: np.ndarray, values: np.ndarray) -> np.ndarray:
    """A GF(2)-linear map of registers, given as the images of their unit
    registers (the low ``len(op)`` bits), applied to an array of them."""
    values = values.astype(np.uint32)
    out = np.zeros_like(values)
    for bit in range(len(op)):
        out ^= np.where((values >> np.uint32(bit)) & np.uint32(1), op[bit], np.uint32(0))
    return out


def _zeros_operator(n: int) -> np.ndarray:
    """The images of the 32 unit registers after ``n`` zero bytes: the map
    that carries a register across n bytes (squaring, as zlib's
    crc32_combine)."""
    unit = np.uint32(1) << np.arange(32, dtype=np.uint32)
    step = _CRC_TABLE[unit & np.uint32(0xFF)] ^ (unit >> np.uint32(8))  # one zero byte
    result = unit
    while n:
        if n & 1:
            result = _apply(step, result)
        n >>= 1
        if n:
            step = _apply(step, step)
    return result


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data``, continuing from ``crc``. A buffer of
    ``_LANES_MIN_BYTES`` or more is cut into K lanes of L bytes after a
    head of len % K bytes: numpy runs the K lanes' registers from 0 side by
    side, and the lanes are joined in order, reg <- Z_L(reg) ^ lane, where
    Z_L carries a register across L bytes (a register's CRC over a lane is
    Z_L of it XOR the lane's CRC from 0)."""
    buf = np.frombuffer(bytes(data) if not isinstance(data, (bytes, bytearray)) else data,
                        np.uint8)
    reg = crc ^ 0xFFFFFFFF
    n = len(buf)
    if n < _LANES_MIN_BYTES:
        return _crc_update(reg, buf.tolist()) ^ 0xFFFFFFFF
    lanes = math.isqrt(8 * n)
    length = n // lanes
    head = n - lanes * length
    reg = _crc_update(reg, buf[:head].tolist())
    columns = np.ascontiguousarray(buf[head:].reshape(lanes, length).T)
    regs = np.zeros(lanes, np.uint32)
    mask = np.uint32(0xFF)
    for column in columns:
        regs = _CRC_TABLE[(regs ^ column) & mask] ^ (regs >> np.uint32(8))
    op = _zeros_operator(length)
    # the operator as four byte tables, for the join's Python loop
    index = np.arange(256, dtype=np.uint32)
    tables = [_apply(op[8 * k:8 * k + 8], index).tolist() for k in range(4)]
    t0, t1, t2, t3 = tables
    for lane in regs.tolist():
        reg = (t0[reg & 0xFF] ^ t1[(reg >> 8) & 0xFF] ^ t2[(reg >> 16) & 0xFF]
               ^ t3[reg >> 24] ^ lane)
    return reg ^ 0xFFFFFFFF


def crc32c_masked(data: bytes) -> int:
    """LevelDB/TF 'masked' CRC: rotate right 15 and add a constant."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# varints + minimal protobuf wire coding
# ---------------------------------------------------------------------------

def _put_varint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _get_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift, result = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _pb_key(field: int, wire: int) -> bytes:
    out = bytearray()
    _put_varint(out, (field << 3) | wire)
    return bytes(out)


def _pb_varint(field: int, value: int) -> bytes:
    if value == 0:
        return b""  # proto3 default omitted
    out = bytearray(_pb_key(field, 0))
    _put_varint(out, value)
    return bytes(out)


def _pb_bytes(field: int, value: bytes) -> bytes:
    out = bytearray(_pb_key(field, 2))
    _put_varint(out, len(value))
    out += value
    return bytes(out)


def _pb_fixed32(field: int, value: int) -> bytes:
    return _pb_key(field, 5) + struct.pack("<I", value & 0xFFFFFFFF)


def _pb_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) from a serialized message."""
    pos = 0
    while pos < len(buf):
        tag, pos = _get_varint(buf, pos)
        fieldno, wire = tag >> 3, tag & 7
        if wire == 0:
            v, pos = _get_varint(buf, pos)
        elif wire == 2:
            n, pos = _get_varint(buf, pos)
            v = buf[pos:pos + n]
            pos += n
        elif wire == 5:
            v = struct.unpack("<I", buf[pos:pos + 4])[0]
            pos += 4
        elif wire == 1:
            v = struct.unpack("<Q", buf[pos:pos + 8])[0]
            pos += 8
        else:  # pragma: no cover - groups unused by these protos
            raise ValueError(f"unsupported wire type {wire}")
        yield fieldno, wire, v


@dataclass
class BundleEntry:
    """One tensor's metadata (BundleEntryProto,
    tensorflow/core/protobuf/tensor_bundle.proto)."""

    dtype: int = 0
    shape: Tuple[int, ...] = ()
    shard_id: int = 0
    offset: int = 0
    size: int = 0
    crc32c: int = 0

    def serialize(self) -> bytes:
        shape_msg = b"".join(
            _pb_bytes(2, _pb_varint(1, d) or _pb_key(1, 0) + b"\x00")
            for d in self.shape)
        out = (_pb_varint(1, self.dtype)
               + (_pb_bytes(2, shape_msg) if self.shape else b"")
               + _pb_varint(3, self.shard_id)
               + _pb_varint(4, self.offset)
               + _pb_varint(5, self.size)
               + _pb_fixed32(6, self.crc32c))
        return out

    @classmethod
    def parse(cls, buf: bytes) -> "BundleEntry":
        e = cls()
        for fieldno, _wire, v in _pb_fields(buf):
            if fieldno == 1:
                e.dtype = int(v)
            elif fieldno == 2:
                dims: List[int] = []
                for f2, _w2, v2 in _pb_fields(v):
                    if f2 == 2:  # Dim message
                        size = 0
                        for f3, _w3, v3 in _pb_fields(v2):
                            if f3 == 1:
                                size = int(v3)
                        dims.append(size)
                e.shape = tuple(dims)
            elif fieldno == 3:
                e.shard_id = int(v)
            elif fieldno == 4:
                e.offset = int(v)
            elif fieldno == 5:
                e.size = int(v)
            elif fieldno == 6:
                e.crc32c = int(v)
        return e


def _serialize_header(num_shards: int) -> bytes:
    # BundleHeaderProto: num_shards, endianness LITTLE(0), version{producer=1}
    version = _pb_varint(1, 1)
    return _pb_varint(1, num_shards) + _pb_bytes(3, version)


def _parse_header(buf: bytes) -> Dict[str, int]:
    h = {"num_shards": 0, "endianness": 0}
    for fieldno, _wire, v in _pb_fields(buf):
        if fieldno == 1:
            h["num_shards"] = int(v)
        elif fieldno == 2:
            h["endianness"] = int(v)
    return h


# ---------------------------------------------------------------------------
# SSTable (LevelDB table) blocks
# ---------------------------------------------------------------------------

def _parse_block(raw: bytes) -> List[Tuple[bytes, bytes]]:
    """Decode a block's prefix-compressed entries (restart array at the end)."""
    if len(raw) < 4:
        return []
    (num_restarts,) = struct.unpack("<I", raw[-4:])
    data_end = len(raw) - 4 - 4 * num_restarts
    entries: List[Tuple[bytes, bytes]] = []
    pos, key = 0, b""
    while pos < data_end:
        shared, pos = _get_varint(raw, pos)
        non_shared, pos = _get_varint(raw, pos)
        vlen, pos = _get_varint(raw, pos)
        key = key[:shared] + raw[pos:pos + non_shared]
        pos += non_shared
        entries.append((key, raw[pos:pos + vlen]))
        pos += vlen
    return entries


def _read_block(data: bytes, offset: int, size: int,
                verify: bool = True) -> bytes:
    raw = data[offset:offset + size]
    ctype = data[offset + size]
    if verify:
        (stored,) = struct.unpack("<I", data[offset + size + 1:
                                             offset + size + 5])
        if crc32c_masked(data[offset:offset + size + 1]) != stored:
            raise ValueError(f"block at {offset}: crc mismatch")
    if ctype == _SNAPPY_COMPRESSION:  # pragma: no cover - TF writes raw
        import snappy  # gated: not in the base image

        return snappy.decompress(raw)
    if ctype != _NO_COMPRESSION:
        raise ValueError(f"unsupported block compression {ctype}")
    return raw


class _BlockBuilder:
    """LevelDB block builder: prefix-compressed entries + restart array."""

    def __init__(self, restart_interval: int = _RESTART_INTERVAL):
        self.restart_interval = restart_interval
        self.buf = bytearray()
        self.restarts = [0]
        self.counter = 0
        self.last_key = b""

    def add(self, key: bytes, value: bytes) -> None:
        assert key >= self.last_key, "keys must be added in sorted order"
        shared = 0
        if self.counter < self.restart_interval:
            max_shared = min(len(key), len(self.last_key))
            while shared < max_shared and key[shared] == self.last_key[shared]:
                shared += 1
        else:
            self.restarts.append(len(self.buf))
            self.counter = 0
        _put_varint(self.buf, shared)
        _put_varint(self.buf, len(key) - shared)
        _put_varint(self.buf, len(value))
        self.buf += key[shared:]
        self.buf += value
        self.last_key = key
        self.counter += 1

    def finish(self) -> bytes:
        out = bytes(self.buf)
        out += b"".join(struct.pack("<I", r) for r in self.restarts)
        out += struct.pack("<I", len(self.restarts))
        return out

    @property
    def approximate_size(self) -> int:
        return len(self.buf) + 4 * len(self.restarts) + 4


def _encode_handle(offset: int, size: int) -> bytes:
    out = bytearray()
    _put_varint(out, offset)
    _put_varint(out, size)
    return bytes(out)


def _decode_handle(buf: bytes, pos: int) -> Tuple[Tuple[int, int], int]:
    offset, pos = _get_varint(buf, pos)
    size, pos = _get_varint(buf, pos)
    return (offset, size), pos


def _write_table(path: str, entries: List[Tuple[bytes, bytes]]) -> None:
    """Write a single-level SSTable (uncompressed blocks, like TF's bundles)."""
    with open(path, "wb") as f:
        data_blocks: List[Tuple[bytes, Tuple[int, int]]] = []  # last_key, handle
        block = _BlockBuilder()

        def flush_block():
            raw = block.finish()
            handle = (f.tell(), len(raw))
            trailer = bytes([_NO_COMPRESSION])
            crc = crc32c_masked(raw + trailer)
            f.write(raw + trailer + struct.pack("<I", crc))
            data_blocks.append((block.last_key, handle))

        for key, value in entries:
            block.add(key, value)
            if block.approximate_size >= _BLOCK_SIZE_TARGET:
                flush_block()
                block = _BlockBuilder()
        if block.counter or not data_blocks:
            flush_block()

        # metaindex (empty) then index block
        def write_raw_block(raw: bytes) -> Tuple[int, int]:
            handle = (f.tell(), len(raw))
            trailer = bytes([_NO_COMPRESSION])
            crc = crc32c_masked(raw + trailer)
            f.write(raw + trailer + struct.pack("<I", crc))
            return handle

        meta_handle = write_raw_block(_BlockBuilder().finish())
        index = _BlockBuilder(restart_interval=1)
        for last_key, handle in data_blocks:
            index.add(last_key, _encode_handle(*handle))
        index_handle = write_raw_block(index.finish())

        footer = bytearray()
        footer += _encode_handle(*meta_handle)
        footer += _encode_handle(*index_handle)
        footer += b"\x00" * (40 - len(footer))
        footer += struct.pack("<Q", _TABLE_MAGIC)
        f.write(bytes(footer))


def _read_table(path: str, verify: bool = True) -> List[Tuple[bytes, bytes]]:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _FOOTER_SIZE:
        raise ValueError(f"{path}: too small to be a table")
    footer = data[-_FOOTER_SIZE:]
    (magic,) = struct.unpack("<Q", footer[40:48])
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{path}: bad table magic {magic:#x}")
    _meta, pos = _decode_handle(footer, 0)
    (index_off, index_size), _ = _decode_handle(footer, pos)
    index_raw = _read_block(data, index_off, index_size, verify)
    entries: List[Tuple[bytes, bytes]] = []
    for _key, handle_buf in _parse_block(index_raw):
        (off, size), _ = _decode_handle(handle_buf, 0)
        entries.extend(_parse_block(_read_block(data, off, size, verify)))
    return entries


# ---------------------------------------------------------------------------
# Bundle reader / writer
# ---------------------------------------------------------------------------

def _shard_filename(prefix: str, shard_id: int, num_shards: int) -> str:
    return f"{prefix}.data-{shard_id:05d}-of-{num_shards:05d}"


class BundleReader:
    """Reads a TensorBundle checkpoint (TF-written or from BundleWriter)."""

    def __init__(self, prefix: str, verify_blocks: bool = True):
        self.prefix = prefix
        index_path = prefix + ".index"
        if not os.path.isfile(index_path):
            raise FileNotFoundError(index_path)
        self.entries: Dict[str, BundleEntry] = {}
        self.header = {"num_shards": 1}
        for key, value in _read_table(index_path, verify_blocks):
            if key == b"":
                self.header = _parse_header(value)
            else:
                self.entries[key.decode("utf-8")] = BundleEntry.parse(value)
        self._shards: Dict[int, np.memmap] = {}

    def keys(self) -> List[str]:
        return sorted(self.entries)

    def shape(self, key: str) -> Tuple[int, ...]:
        return self.entries[key].shape

    def dtype(self, key: str) -> Optional[np.dtype]:
        return _DT_TO_NUMPY.get(self.entries[key].dtype)

    def _shard(self, shard_id: int) -> np.memmap:
        if shard_id not in self._shards:
            path = _shard_filename(self.prefix, shard_id,
                                   self.header.get("num_shards", 1))
            self._shards[shard_id] = np.memmap(path, np.uint8, mode="r")
        return self._shards[shard_id]

    def raw_bytes(self, key: str) -> bytes:
        e = self.entries[key]
        shard = self._shard(e.shard_id)
        return bytes(shard[e.offset:e.offset + e.size])

    def get(self, key: str, verify_crc: bool = False) -> np.ndarray:
        """Materialize one tensor. String tensors are returned as a list of
        bytes objects (the object-graph entry is one of these)."""
        e = self.entries[key]
        raw = self.raw_bytes(key)
        if verify_crc and e.crc32c and e.dtype != DT_STRING:
            # string entries are crc'd over (uint32 lengths, checksum, data),
            # not the file bytes — verified inside the string branch below
            if crc32c_masked(raw) != e.crc32c:
                raise ValueError(f"{key}: content crc mismatch")
        if e.dtype == DT_STRING:
            # TF string-tensor layout (tensor_bundle.cc WriteStringTensor):
            # varint64 lengths | 4-byte LE masked crc32c(lengths) | data
            n = int(np.prod(e.shape)) if e.shape else 1
            lengths, pos = [], 0
            for _ in range(n):
                v, pos = _get_varint(raw, pos)
                lengths.append(v)
            len_crc = int.from_bytes(raw[pos:pos + 4], "little")
            if verify_crc:
                lens_u32 = struct.pack(f"<{len(lengths)}I", *lengths)
                if len_crc != crc32c_masked(lens_u32):
                    raise ValueError(f"{key}: string length crc mismatch")
            pos += 4
            out = []
            for ln in lengths:
                out.append(raw[pos:pos + ln])
                pos += ln
            return out
        np_dtype = _DT_TO_NUMPY.get(e.dtype)
        if e.dtype == DT_BFLOAT16:
            u16 = np.frombuffer(raw, np.uint16).reshape(e.shape)
            return (u16.astype(np.uint32) << 16).view(np.float32)
        if np_dtype is None:
            raise ValueError(f"{key}: unsupported dtype enum {e.dtype}")
        return np.frombuffer(raw, np_dtype).reshape(e.shape)

    def load_all(self, prefix_filter: str = "",
                 verify_crc: bool = False) -> Dict[str, np.ndarray]:
        return {k: self.get(k, verify_crc) for k in self.keys()
                if k.startswith(prefix_filter)
                and self.entries[k].dtype != DT_STRING}


class BundleWriter:
    """Writes a TensorBundle readable by both BundleReader and TensorFlow."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        self._tensors: Dict[str, np.ndarray] = {}
        self._strings: Dict[str, List[bytes]] = {}

    def add(self, key: str, value: np.ndarray) -> None:
        # NB: not ascontiguousarray — it silently promotes 0-d scalars to 1-d
        self._tensors[key] = np.asarray(value)

    def add_strings(self, key: str, values: List[bytes],
                    scalar: bool = False) -> None:
        """``scalar=True`` writes a single string with shape () (what TF
        uses for _CHECKPOINTABLE_OBJECT_GRAPH); otherwise the entry is a
        rank-1 vector of len(values) even for one element."""
        if scalar and len(values) != 1:
            raise ValueError("scalar string entries hold exactly one value")
        self._strings[key] = (list(values), scalar)

    def close(self) -> None:
        num_shards = 1
        data_path = _shard_filename(self.prefix, 0, num_shards)
        entries: List[Tuple[bytes, bytes]] = [
            (b"", _serialize_header(num_shards))]
        offset = 0
        with open(data_path, "wb") as data_f:
            for key in sorted(set(self._tensors) | set(self._strings)):
                if key in self._strings:
                    vals, scalar = self._strings[key]
                    # TF layout (tensor_bundle.cc WriteStringTensor):
                    # varint64 lengths | 4-byte LE masked crc32c of the
                    # lengths AS A uint32 ARRAY (not of the varint bytes!)
                    # | concatenated string data
                    buf = bytearray()
                    for v in vals:
                        _put_varint(buf, len(v))
                    lens_u32 = struct.pack(f"<{len(vals)}I",
                                           *[len(v) for v in vals])
                    len_crc4 = crc32c_masked(lens_u32).to_bytes(4, "little")
                    buf += len_crc4
                    for v in vals:
                        buf += v
                    raw = bytes(buf)
                    # entry crc: TF accumulates over the uint32 lengths (not
                    # the varint file bytes), the 4 checksum bytes, then data
                    entry_crc = crc32c_masked(
                        lens_u32 + len_crc4 + b"".join(vals))
                    entry = BundleEntry(dtype=DT_STRING,
                                        shape=() if scalar
                                        else (len(vals),), shard_id=0,
                                        offset=offset, size=len(raw),
                                        crc32c=entry_crc)
                else:
                    arr = self._tensors[key]
                    raw = arr.tobytes()
                    entry = BundleEntry(dtype=_NUMPY_TO_DT[arr.dtype],
                                        shape=tuple(arr.shape), shard_id=0,
                                        offset=offset, size=len(raw),
                                        crc32c=crc32c_masked(raw))
                data_f.write(raw)
                offset += len(raw)
                entries.append((key.encode("utf-8"), entry.serialize()))
        _write_table(self.prefix + ".index", entries)


def latest_checkpoint(model_dir: str) -> Optional[str]:
    """Resolve the newest ``{prefix}.index`` in a reference model_dir (the
    reference relies on tf.train's ``checkpoint`` state file; we accept either
    that file's pointer or the highest-numbered prefix)."""
    state = os.path.join(model_dir, "checkpoint")
    if os.path.isfile(state):
        with open(state) as f:
            for line in f:
                m = re.match(r'model_checkpoint_path:\s*"(.+)"', line.strip())
                if m:
                    p = m.group(1)
                    if not os.path.isabs(p):
                        p = os.path.join(model_dir, p)
                    if os.path.isfile(p + ".index"):
                        return p
    best: Tuple[int, Optional[str]] = (-1, None)
    for f in os.listdir(model_dir):
        if f.endswith(".index"):
            m = re.search(r"-(\d+)\.index$", f)
            num = int(m.group(1)) if m else 0
            if num > best[0]:
                best = (num, os.path.join(model_dir, f[:-len(".index")]))
    return best[1]
