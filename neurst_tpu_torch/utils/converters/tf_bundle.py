"""A reader of TensorFlow's tensor-bundle checkpoints without TensorFlow.

A TF2 checkpoint ``<prefix>`` is an index file ``<prefix>.index`` and
data shards ``<prefix>.data-0000k-of-0000n``.  The index is an SSTable
(LevelDB's table format):

* a 48-byte footer: the metaindex and index block handles (varint64
  offset and size each), zero padding to 40 bytes, and the magic
  ``0xdb4775248b80fb57`` (little-endian);
* blocks, each followed by a 5-byte trailer: the compression type (0, no
  compression: any other type raises) and the masked crc32c of the block
  and its type byte;
* a block holds entries (varint32 shared key bytes, varint32 unshared
  key bytes, varint32 value size, the unshared key bytes, the value),
  then the uint32 restart offsets and their count;
* the index block maps each data block's last key to its handle.

The entry of key ``""`` is the ``BundleHeaderProto`` (shard count,
endianness: little-endian only, else this raises); every other entry is
a ``BundleEntryProto`` (dtype, shape, shard id, offset, size, masked
crc32c of the tensor's bytes).  Both are decoded by a small protobuf
wire-format parser.  A tensor's bytes are read from its shard, and their
masked crc32c (``data/recordio.crc32c``, the port's C++ host library) is
checked: a mismatch raises, as does a block whose crc32c does not match.
String tensors (the object graph) are varint64 lengths, the masked
crc32c of the lengths, then the bytes; their checksums cover each length
as a uint32 (a uint64 past 2^32), as TensorFlow writes them.
"""

import os
import re
import struct
from typing import Dict, List, Tuple

import numpy as np

from neurst_tpu_torch.data.recordio import crc32c

__all__ = ["BundleReader", "load_bundle", "resolve_prefix"]

_MAGIC = 0xdb4775248b80fb57
_FOOTER = 48
_MASK_DELTA = 0xA282EAD8

# tensorflow/core/framework/types.proto -> (numpy dtype, TF dtype name)
_DTYPES = {
    1: (np.float32, "float32"), 2: (np.float64, "float64"),
    3: (np.int32, "int32"), 4: (np.uint8, "uint8"), 5: (np.int16, "int16"),
    6: (np.int8, "int8"), 7: (object, "string"),
    8: (np.complex64, "complex64"), 9: (np.int64, "int64"),
    10: (np.bool_, "bool"), 14: (np.uint16, "bfloat16"),
    17: (np.uint16, "uint16"), 18: (np.complex128, "complex128"),
    19: (np.float16, "float16"), 22: (np.uint32, "uint32"),
    23: (np.uint64, "uint64"),
}


def _masked(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def _varint(buf, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> List[Tuple[int, int, object]]:
    """(field number, wire type, value) of a protobuf message: ints for
    varints and fixed widths, bytes for length-delimited fields."""
    out, pos = [], 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        number, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:
            size, pos = _varint(buf, pos)
            value = bytes(buf[pos:pos + size])
            pos += size
        elif wire == 5:
            value = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        out.append((number, wire, value))
    return out


def _shape(buf: bytes) -> Tuple[int, ...]:
    """TensorShapeProto: dim (2) {size (1)}; unknown_rank (3)."""
    dims = []
    for number, _, value in _fields(buf):
        if number == 2:
            size = 0
            for n, _, v in _fields(value):
                if n == 1:
                    size = v - (1 << 64) if v >= 1 << 63 else v
            dims.append(size)
        elif number == 3 and value:
            raise ValueError("a tensor of unknown rank")
    return tuple(dims)


def _block_handle(buf, pos: int) -> Tuple[int, int, int]:
    offset, pos = _varint(buf, pos)
    size, pos = _varint(buf, pos)
    return offset, size, pos


def _read_block(data: bytes, offset: int, size: int, name: str) -> bytes:
    if offset + size + 5 > len(data):
        raise ValueError(f"{name}: block [{offset}, +{size}] past the end")
    block = data[offset:offset + size]
    kind = data[offset + size]
    stored = struct.unpack_from("<I", data, offset + size + 1)[0]
    if _masked(crc32c(data[offset:offset + size + 1])) != stored:
        raise ValueError(f"{name}: crc32c mismatch in the block at {offset}")
    if kind != 0:
        raise ValueError(f"{name}: block at {offset} has compression type "
                         f"{kind}; only uncompressed blocks are read")
    return block


def _block_entries(block: bytes, name: str):
    """(key, value) of a block, in order."""
    if len(block) < 4:
        raise ValueError(f"{name}: a block of {len(block)} bytes")
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    end = len(block) - 4 - 4 * n_restarts
    if end < 0:
        raise ValueError(f"{name}: {n_restarts} restarts do not fit")
    pos, key = 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        value_size, pos = _varint(block, pos)
        if shared > len(key) or pos + unshared + value_size > end:
            raise ValueError(f"{name}: a corrupt block entry")
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        yield key, block[pos:pos + value_size]
        pos += value_size


def resolve_prefix(path: str) -> str:
    """The checkpoint prefix of ``path``: a prefix as it is, or a
    directory's newest (its ``checkpoint`` file's
    ``model_checkpoint_path``, else the ``.index`` of the highest
    step)."""
    if os.path.exists(path + ".index"):
        return path
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no TF checkpoint at {path}")
    state = os.path.join(path, "checkpoint")
    if os.path.exists(state):
        with open(state) as f:
            m = re.search(r'^model_checkpoint_path:\s*"(.*)"\s*$', f.read(),
                          re.MULTILINE)
        if m:
            prefix = m.group(1)
            if not os.path.isabs(prefix):
                prefix = os.path.join(path, prefix)
            if os.path.exists(prefix + ".index"):
                return prefix
    steps = []
    for f in os.listdir(path):
        m = re.match(r"^(.*?)(\d+)\.index$", f)
        if m:
            steps.append((int(m.group(2)), os.path.join(path, f[:-6])))
    if not steps:
        raise FileNotFoundError(f"no TF checkpoint in {path}")
    return max(steps)[1]


class BundleReader(object):
    """The variables of one tensor-bundle checkpoint (``prefix`` or a
    directory): ``dtypes()`` (key -> TF dtype name), ``shapes()`` and
    ``get_tensor(key)``."""

    def __init__(self, path: str):
        self._prefix = resolve_prefix(path)
        index_path = self._prefix + ".index"
        with open(index_path, "rb") as f:
            data = f.read()
        if len(data) < _FOOTER:
            raise ValueError(f"{index_path}: too short for a table")
        footer = data[-_FOOTER:]
        if struct.unpack_from("<Q", footer, 40)[0] != _MAGIC:
            raise ValueError(f"{index_path}: bad table magic")
        _, _, pos = _block_handle(footer, 0)   # the metaindex: unused
        index_offset, index_size, _ = _block_handle(footer, pos)
        index = _read_block(data, index_offset, index_size, index_path)
        self._entries: Dict[str, dict] = {}
        header = None
        for _, handle in _block_entries(index, index_path):
            offset, size, _ = _block_handle(handle, 0)
            block = _read_block(data, offset, size, index_path)
            for key, value in _block_entries(block, index_path):
                if key == b"":
                    header = value
                else:
                    self._entries[key.decode("utf-8")] = self._entry(value)
        if header is None:
            raise ValueError(f"{index_path}: no bundle header")
        self._num_shards = 1
        for number, _, value in _fields(header):
            if number == 1:
                self._num_shards = value
            elif number == 2 and value != 0:
                raise ValueError(f"{index_path}: a big-endian bundle; only "
                                 f"little-endian bundles are read")

    @staticmethod
    def _entry(value: bytes) -> dict:
        entry = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0,
                 "size": 0, "crc32c": None}
        for number, _, v in _fields(value):
            if number == 1:
                entry["dtype"] = v
            elif number == 2:
                entry["shape"] = _shape(v)
            elif number == 3:
                entry["shard_id"] = v
            elif number == 4:
                entry["offset"] = v
            elif number == 5:
                entry["size"] = v
            elif number == 6:
                entry["crc32c"] = v
            elif number == 7:
                raise ValueError("sliced bundle entries are not read")
        if entry["dtype"] not in _DTYPES:
            raise ValueError(f"unsupported tensor dtype {entry['dtype']}")
        return entry

    def dtypes(self) -> Dict[str, str]:
        return {k: _DTYPES[e["dtype"]][1] for k, e in self._entries.items()}

    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {k: e["shape"] for k, e in self._entries.items()}

    def _bytes(self, entry: dict, key: str, check: bool = True) -> bytes:
        shard = (f"{self._prefix}.data-{entry['shard_id']:05d}-of-"
                 f"{self._num_shards:05d}")
        with open(shard, "rb") as f:
            f.seek(entry["offset"])
            raw = f.read(entry["size"])
        if len(raw) != entry["size"]:
            raise ValueError(f"{key}: {shard} ends inside the tensor")
        if check and entry["crc32c"] is not None \
                and _masked(crc32c(raw)) != entry["crc32c"]:
            raise ValueError(f"{key}: crc32c mismatch in {shard}")
        return raw

    def get_tensor(self, key: str) -> np.ndarray:
        """The tensor as numpy (bfloat16 widened to float32 exactly;
        strings as an object array of bytes)."""
        entry = self._entries[key]
        np_dtype, name = _DTYPES[entry["dtype"]]
        shape = entry["shape"]
        if name == "string":
            return self._strings(self._bytes(entry, key, check=False),
                                 shape, key, entry["crc32c"])
        raw = self._bytes(entry, key)
        a = np.frombuffer(raw, dtype=np.dtype(np_dtype).newbyteorder("<"))
        if a.size != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{key}: {a.size} elements for shape {shape}")
        a = a.reshape(shape).astype(np_dtype)
        if name == "bfloat16":
            a = (a.astype(np.uint32) << 16).view(np.float32)
        return a

    @staticmethod
    def _strings(raw: bytes, shape, key: str, entry_crc) -> np.ndarray:
        n = int(np.prod(shape, dtype=np.int64))
        lengths, pos = [], 0
        for _ in range(n):
            length, pos = _varint(raw, pos)
            lengths.append(length)
        summed = b"".join(struct.pack("<I" if length <= 0xFFFFFFFF else "<Q",
                                      length) for length in lengths)
        stored = raw[pos:pos + 4]
        if len(stored) != 4 or struct.unpack("<I", stored)[0] != _masked(
                crc32c(summed)):
            raise ValueError(f"{key}: crc32c mismatch in the string lengths")
        pos += 4
        out = np.empty(n, dtype=object)
        for i, length in enumerate(lengths):
            out[i] = raw[pos:pos + length]
            pos += length
        if pos != len(raw):
            raise ValueError(f"{key}: {len(raw) - pos} bytes after the "
                             f"strings")
        if entry_crc is not None and _masked(crc32c(
                summed + stored + raw[pos - sum(lengths):pos])) != entry_crc:
            raise ValueError(f"{key}: crc32c mismatch in the strings")
        return out.reshape(shape)


def load_bundle(path: str) -> Dict[str, np.ndarray]:
    """Every variable of a checkpoint, by key."""
    reader = BundleReader(path)
    return {key: reader.get_tensor(key) for key in reader.dtypes()}
