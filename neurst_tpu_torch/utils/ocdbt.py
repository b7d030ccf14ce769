"""A key-value store over an OCDBT directory, the on-disk format of
TensorStore's "ocdbt" driver, which orbax checkpoints use (the port's
counterpart of TensorStore's C++ driver; it imports neither tensorstore
nor zstandard).

The format, as TensorStore writes it:

* ``manifest.ocdbt``: a header (magic ``0x0cdb3a2a`` big-endian, the
  file's length as a little-endian u64, the format version and a
  compression byte as varints: 0 none, 1 zstd), a body (compressed as the
  byte says) and a crc32c of everything before it (little-endian u32).
  The body holds the config (a 16-byte uuid, the manifest kind, the
  largest inline value, the largest decoded node, the version tree's
  arity as a log2 byte, the compression method and, for zstd, its level
  as an i32), a data-file table and the version tree: the newest
  versions inline as columns (generation, root height, the root node's
  data file, offset and length, key count, tree bytes, indirect value
  bytes, commit time in ns), then references to older version nodes.
* B+tree nodes (magic ``0x0cdb20de``, the same header and footer), in
  data files under ``d/``, also after the indirect values of a file.
  A node's body: its height, its own data-file table, the entry count,
  the keys (each but the first as the length of the prefix it shares with
  the previous key, then every key's suffix length, then the suffixes),
  then for a leaf each value's length and kind (0 inline, 1 indirect),
  the indirect values' data files and offsets, and the inline values;
  for an interior node each child's common key prefix length and its
  reference (data file, offset, length, key count, tree bytes, indirect
  value bytes), the child storing its keys without that prefix.
* A data-file table: the count, each path's prefix shared with the
  previous path, each path's suffix length and base-path length, then
  the suffixes; a path is a base path (``ocdbt.process_N/`` where the
  root manifest of a multi-process save points into a process's store)
  and a relative path, both under the directory of the manifest.

``OcdbtReader(path)`` reads the newest version (every node's and
manifest's crc32c checked, through the port's C++ crc32c; zstd through
``utils/zstd``).  ``write_store(path, items)`` writes a store of one
version and one leaf node, uncompressed, the values above
``max_inline_value_bytes`` in a data file; ``write_root(path, stores)``
writes the root manifest over the stores of several processes
(``ocdbt.process_<rank>``), as a multi-process orbax save does.
TensorStore reads both.
"""

import os
import struct
import time
import uuid
from typing import Dict, List, NamedTuple, Tuple

from neurst_tpu_torch.data.recordio import crc32c
from neurst_tpu_torch.utils import zstd

__all__ = ["OcdbtReader", "write_store", "write_root",
           "MAX_INLINE_VALUE_BYTES"]

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


class ValueRef(NamedTuple):
    """Where a value lives: inline bytes, or (data file path, offset,
    length) with ``inline`` None."""
    inline: object
    path: str = ""
    offset: int = 0
    length: int = 0


class _Buf:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"ocdbt: truncated {self.what}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"ocdbt: bad varint in {self.what}")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _unframe(data: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node file: header and crc checked,
    decompressed."""
    if len(data) < 18:
        raise ValueError(f"ocdbt: truncated {what}")
    got_magic, length = struct.unpack(">I", data[:4])[0], \
        struct.unpack("<Q", data[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"ocdbt: {what} has magic {got_magic:#x}, not "
                         f"{magic:#x}")
    if length != len(data):
        raise ValueError(f"ocdbt: {what} says {length} bytes, has "
                         f"{len(data)}")
    if crc32c(data[:-4]) != struct.unpack("<I", data[-4:])[0]:
        raise ValueError(f"ocdbt: crc32c mismatch in {what}")
    buf = _Buf(data[12:-4], what)
    version = buf.varint()
    if version != 0:
        raise ValueError(f"ocdbt: {what} format version {version}")
    compression = buf.varint()
    body = buf.data[buf.pos:]
    if compression == 1:
        return zstd.decompress(body)
    if compression != 0:
        raise ValueError(f"ocdbt: {what} compression {compression}")
    return body


def _frame(body: bytes, magic: int) -> bytes:
    """An uncompressed manifest or node file of ``body``."""
    head = _varint(0) + _varint(0)
    length = 12 + len(head) + len(body) + 4
    out = struct.pack(">I", magic) + struct.pack("<Q", length) + head + body
    return out + struct.pack("<I", crc32c(out))


def _read_file_table(buf: _Buf) -> List[Tuple[str, str]]:
    n = buf.varint()
    prefix = [0] + buf.varints(n - 1) if n else []
    suffix = buf.varints(n)
    base = buf.varints(n)
    out, last = [], b""
    for i in range(n):
        if prefix[i] > len(last):
            raise ValueError("ocdbt: bad data-file table")
        full = last[:prefix[i]] + buf.take(suffix[i])
        if base[i] > len(full):
            raise ValueError("ocdbt: bad data-file table")
        out.append((full[:base[i]].decode(), full[base[i]:].decode()))
        last = full
    return out


def _file_table(files: List[Tuple[str, str]]) -> bytes:
    fulls = [(b + r).encode() for b, r in files]
    prefix, suffix = [], []
    last = b""
    for i, full in enumerate(fulls):
        shared = 0
        if i:
            while shared < min(len(last), len(full)) \
                    and last[shared] == full[shared]:
                shared += 1
            prefix.append(shared)
        suffix.append(full[shared:])
        last = full
    return (_varint(len(files)) + b"".join(_varint(p) for p in prefix)
            + b"".join(_varint(len(s)) for s in suffix)
            + b"".join(_varint(len(b.encode())) for b, _ in files)
            + b"".join(suffix))


def _read_keys(buf: _Buf, n: int) -> List[bytes]:
    prefix = [0] + buf.varints(n - 1) if n else []
    suffix = buf.varints(n)
    keys, last = [], b""
    for i in range(n):
        if prefix[i] > len(last):
            raise ValueError("ocdbt: bad key prefix")
        last = last[:prefix[i]] + buf.take(suffix[i])
        keys.append(last)
    return keys


def _keys(keys: List[bytes]) -> bytes:
    prefix, suffix, last = [], [], b""
    for i, key in enumerate(keys):
        shared = 0
        if i:
            while shared < min(len(last), len(key)) \
                    and last[shared] == key[shared]:
                shared += 1
            prefix.append(shared)
        suffix.append(key[shared:])
        last = key
    return (b"".join(_varint(p) for p in prefix)
            + b"".join(_varint(len(s)) for s in suffix) + b"".join(suffix))


class OcdbtReader:
    """The newest version of the OCDBT store at directory ``path``:
    ``keys()``, ``get(key)`` (bytes, KeyError when absent) and
    ``refs`` ({key: ValueRef})."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "manifest.ocdbt"), "rb") as f:
            body = _unframe(f.read(), MANIFEST_MAGIC, "manifest")
        buf = _Buf(body, "manifest")
        buf.take(16)  # uuid
        kind = buf.varint()
        if kind != 0:
            raise ValueError("ocdbt: numbered manifests are not supported")
        self.max_inline_value_bytes = buf.varint()
        buf.varint()  # max decoded node bytes
        buf.byte()  # version tree arity
        if buf.varint() == 1:
            buf.take(4)  # zstd level
        files = _read_file_table(buf)
        n = buf.varint()
        cols = [buf.varints(n)]  # generation
        cols.append([buf.byte() for _ in range(n)])  # root height
        cols += [buf.varints(n) for _ in range(6)]
        if not n:
            raise ValueError("ocdbt: manifest holds no version")
        i = max(range(n), key=lambda j: cols[0][j])
        gen, height, file_id, offset, length, num_keys = (
            c[i] for c in cols[:6])
        self.generation, self.height = gen, height
        self.refs: Dict[bytes, ValueRef] = {}
        if num_keys:  # an empty tree has no root node
            self._node(files[file_id], offset, length, height, b"")

    def _file(self, entry: Tuple[str, str]) -> str:
        return os.path.join(self.path, entry[0], entry[1])

    def _node(self, entry, offset, length, height, prefix):
        with open(self._file(entry), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        buf = _Buf(_unframe(data, NODE_MAGIC, "B+tree node"), "node")
        if buf.byte() != height:
            raise ValueError("ocdbt: node height mismatch")
        files = _read_file_table(buf)
        n = buf.varint()
        if height == 0:
            keys = _read_keys(buf, n)
            lengths = buf.varints(n)
            kinds = [buf.byte() for _ in range(n)]
            indirect = [i for i in range(n) if kinds[i] == 1]
            if any(k not in (0, 1) for k in kinds):
                raise ValueError("ocdbt: bad value kind")
            file_ids = buf.varints(len(indirect))
            offsets = buf.varints(len(indirect))
            refs = {}
            for i, fid, off in zip(indirect, file_ids, offsets):
                refs[i] = ValueRef(None, self._file(files[fid]), off,
                                   lengths[i])
            for i in range(n):
                if kinds[i] == 0:
                    refs[i] = ValueRef(buf.take(lengths[i]))
                self.refs[prefix + keys[i]] = refs[i]
            return
        prefix_len = [0] + buf.varints(n - 1) if n else []
        suffix_len = buf.varints(n)
        common = buf.varints(n)
        keys, last = [], b""
        for i in range(n):
            last = last[:prefix_len[i]] + buf.take(suffix_len[i])
            keys.append(last)
        file_ids, offsets, lengths = (buf.varints(n) for _ in range(3))
        buf.varints(3 * n)  # key counts, tree bytes, indirect bytes
        for i in range(n):
            self._node(files[file_ids[i]], offsets[i], lengths[i],
                       height - 1, prefix + keys[i][:common[i]])

    def keys(self) -> List[bytes]:
        return sorted(self.refs)

    def get(self, key) -> bytes:
        if isinstance(key, str):
            key = key.encode()
        ref = self.refs[key]
        if ref.inline is not None:
            return ref.inline
        with open(ref.path, "rb") as f:
            f.seek(ref.offset)
            data = f.read(ref.length)
        if len(data) != ref.length:
            raise ValueError(f"ocdbt: truncated value {key!r}")
        return data


def _config(max_inline: int) -> bytes:
    return (uuid.uuid4().bytes + _varint(0) + _varint(max_inline)
            + _varint(MAX_DECODED_NODE_BYTES)
            + bytes([VERSION_TREE_ARITY_LOG2]) + _varint(0))


def _leaf(files, keys, values) -> bytes:
    """A leaf node's body: ``values`` are bytes (inline) or (file id,
    offset, length)."""
    lengths = [len(v) if isinstance(v, bytes) else v[2] for v in values]
    kinds = bytes(0 if isinstance(v, bytes) else 1 for v in values)
    indirect = [v for v in values if not isinstance(v, bytes)]
    return (b"\x00" + _file_table(files) + _varint(len(keys)) + _keys(keys)
            + b"".join(_varint(x) for x in lengths) + kinds
            + b"".join(_varint(v[0]) for v in indirect)
            + b"".join(_varint(v[1]) for v in indirect)
            + b"".join(v for v in values if isinstance(v, bytes)))


def _write_tree(path, files, keys, values, data: bytearray, data_name):
    """Appends the leaf node to ``data``, writes the data file and the
    manifest of one version over it.  A tree of no keys has no root node
    (TensorStore refuses an empty one): raises."""
    if not keys:
        raise ValueError(f"ocdbt: no keys to write at {path}")
    node = _frame(_leaf(files, keys, values), NODE_MAGIC)
    offset = len(data)
    data += node
    os.makedirs(os.path.join(path, "d"), exist_ok=True)
    with open(os.path.join(path, data_name), "wb") as f:
        f.write(bytes(data))
    indirect = sum(v[2] for v in values if not isinstance(v, bytes))
    body = (_config(MAX_INLINE_VALUE_BYTES) + _file_table([("", data_name)])
            + _varint(1) + _varint(1) + b"\x00" + _varint(0)
            + _varint(offset) + _varint(len(node)) + _varint(len(keys))
            + _varint(len(node)) + _varint(indirect)
            + struct.pack("<Q", time.time_ns()) + _varint(0))
    tmp = os.path.join(path, f"manifest.ocdbt.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        f.write(_frame(body, MANIFEST_MAGIC))
    os.replace(tmp, os.path.join(path, "manifest.ocdbt"))


def write_store(path: str, items: Dict[bytes, bytes]) -> None:
    """A store at ``path`` holding ``items`` ({key: value}, bytes), one
    version, uncompressed; values above MAX_INLINE_VALUE_BYTES go to one
    data file, which the leaf node follows."""
    name = f"d/{uuid.uuid4().hex}"
    data = bytearray()
    encoded = {k.encode() if isinstance(k, str) else k: bytes(v)
               for k, v in items.items()}
    keys = sorted(encoded)
    values = []
    for key in keys:
        value = encoded[key]
        if len(value) > MAX_INLINE_VALUE_BYTES:
            values.append((0, len(data), len(value)))
            data += value
        else:
            values.append(value)
    _write_tree(path, [("", name)] if data else [], keys, values, data,
                name)


def write_root(path: str, stores: List[str]) -> None:
    """The root manifest at ``path`` over the stores in its
    subdirectories ``stores`` (``ocdbt.process_<rank>``; one that does not
    exist holds nothing): one leaf node that refers to each store's values
    in place (inline values copied).  A key in several stores keeps the
    first store's value."""
    files, ids, entries = [], {}, {}
    for store in stores:
        if not os.path.isdir(os.path.join(path, store)):
            continue
        reader = OcdbtReader(os.path.join(path, store))
        for key, ref in reader.refs.items():
            if key in entries:
                continue
            if ref.inline is not None:
                entries[key] = ref.inline
                continue
            rel = os.path.relpath(ref.path, os.path.join(path, store))
            entry = (store.rstrip("/") + "/", rel)
            if entry not in ids:
                ids[entry] = len(files)
                files.append(entry)
            entries[key] = (ids[entry], ref.offset, ref.length)
    keys = sorted(entries)
    _write_tree(path, files, keys, [entries[k] for k in keys], bytearray(),
                f"d/{uuid.uuid4().hex}")
