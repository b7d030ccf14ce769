"""TFRecord-compatible record IO in plain Python and numpy (the port's copy
of ``neurst_tpu/data/recordio.py``).

* The TFRecord framing: length, masked crc32c of the length, data, masked
  crc32c of the data.
* A minimal protobuf wire-format codec for ``tf.train.Example``
  (features: map<string, Feature>, Feature = oneof {bytes_list,
  float_list, int64_list}).

Files written by either package read in the other.  ``crc32c`` runs in
the port's host library (``csrc/crc32c.cpp``: the SSE4.2 crc32
instruction, or slicing-by-8 tables), built on first use by
``ops/_build.py``; a build that fails raises.  ``crc32c_numpy`` is its
plain version, which the tests hold it against: records of audio
features are megabytes each, and a byte loop in Python would take seconds
a record.
"""

import ctypes
import functools
import glob as _glob
import os
import struct
from typing import Dict, Iterator, List, Union

import numpy as np

__all__ = ["RecordWriter", "record_iterator", "parse_example",
           "build_example", "glob_record_files", "crc32c", "crc32c_numpy"]

_POLY = 0x82F63B78  # Castagnoli, reflected
_MASK_DELTA = 0xA282EAD8


@functools.lru_cache(maxsize=None)
def _table() -> np.ndarray:
    crc = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        crc = np.where(crc & 1, (crc >> 1) ^ np.uint32(_POLY), crc >> 1)
    return crc.astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _zeros_operator(length: int) -> List[List[int]]:
    """[4, 256] tables of the linear map 'feed ``length`` zero bytes' on a
    crc register: ``Z(s) = xor of tables[k][byte k of s]``."""
    table = _table()
    basis = np.uint32(1) << np.arange(32, dtype=np.uint32)
    state = basis.copy()
    for _ in range(length):
        state = table[state & 0xFF] ^ (state >> 8)
    bits = (np.arange(256)[:, None] >> np.arange(8)[None, :]) & 1  # [256, 8]
    out = np.zeros((4, 256), np.uint32)
    for k in range(4):
        images = state[8 * k:8 * k + 8]                             # [8]
        out[k] = np.bitwise_xor.reduce(
            np.where(bits == 1, images[None, :], np.uint32(0)), axis=1)
    return out.tolist()


def _feed(states: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Runs each row of ``data`` [n, L] uint8 through the register
    ``states`` [n] uint32 (no initial or final inversion)."""
    table = _table()
    for i in range(data.shape[1]):
        states = table[(states ^ data[:, i]) & 0xFF] ^ (states >> 8)
    return states


@functools.lru_cache(maxsize=None)
def _native() -> ctypes.CDLL:
    from neurst_tpu_torch.ops import _build
    lib = _build.load("crc32c")
    for fn in (lib.neurst_crc32c, lib.neurst_crc32c_tables):
        fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        fn.restype = ctypes.c_uint32
    return lib


def crc32c(data: bytes) -> int:
    """CRC-32C of ``data`` (bytes-like), in the host library."""
    if not isinstance(data, bytes):
        data = bytes(data)
    return _native().neurst_crc32c(data, len(data))


def crc32c_numpy(data: bytes) -> int:
    """CRC-32C of ``data`` in numpy.  The register update is affine over
    GF(2), so the bytes are cut into equal chunks that run side by side
    from a zero register (one vectorized step per byte of a chunk), and
    the chunk results are chained through the 'feed L zero bytes'
    operator."""
    buf = np.frombuffer(data, dtype=np.uint8)
    chunk = max(64, int(np.sqrt(buf.size)) // 64 * 64)
    n_chunks = buf.size // chunk if buf.size >= 4 * chunk else 0
    state = np.uint32(0xFFFFFFFF)
    if n_chunks:
        parts = _feed(np.zeros(n_chunks, np.uint32),
                      buf[:n_chunks * chunk].reshape(n_chunks, chunk))
        zeros = _zeros_operator(chunk)
        s = int(state)
        for part in parts.tolist():
            s = (zeros[0][s & 0xFF] ^ zeros[1][(s >> 8) & 0xFF]
                 ^ zeros[2][(s >> 16) & 0xFF] ^ zeros[3][s >> 24] ^ part)
        state = np.uint32(s)
    tail = buf[n_chunks * chunk:]
    state = _feed(np.asarray([state], np.uint32), tail[None, :])[0]
    return int(state) ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


class RecordWriter(object):
    """Writes TFRecord-framed records to a file."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "wb")

    def write(self, record: bytes):
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


def record_iterator(path: str, check_crc: bool = False) -> Iterator[bytes]:
    """Yields the record payloads of a TFRecord file.  Every corruption
    raises IOError; a declared length is bounded by the rest of the file
    before it is read."""
    with open(path, "rb") as f:
        file_size = os.fstat(f.fileno()).st_size
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) != 8:
                raise IOError(f"Truncated record header in {path}")
            (length,) = struct.unpack("<Q", header)
            if length > file_size - f.tell():
                raise IOError(f"Implausible record length {length} in {path}")
            len_crc = f.read(4)
            if len(len_crc) != 4:
                raise IOError(f"Truncated record length crc in {path}")
            if check_crc and struct.unpack("<I", len_crc)[0] != \
                    _masked_crc(header):
                raise IOError(f"Corrupted record length crc in {path}")
            data = f.read(length)
            if len(data) != length:
                raise IOError(f"Truncated record in {path}")
            data_crc = f.read(4)
            if len(data_crc) != 4:
                raise IOError(f"Truncated record data crc in {path}")
            if check_crc and struct.unpack("<I", data_crc)[0] != \
                    _masked_crc(data):
                raise IOError(f"Corrupted record data crc in {path}")
            yield data


def glob_record_files(file_path) -> List[str]:
    """Expands dirs (``*train*``), plain files and prefix globs."""
    from neurst_tpu_torch.utils.configurable import flatten_string_list
    out = []
    for f in flatten_string_list(file_path):
        if os.path.isdir(f):
            out.extend(sorted(_glob.glob(os.path.join(f, "*train*"))))
        elif os.path.exists(f):
            out.append(f)
        else:
            out.extend(sorted(_glob.glob(f + "*")))
    return out


# ------------------------- protobuf wire format ------------------------ #

def _write_varint(out: bytearray, value: int):
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field_number: int, wire_type: int) -> int:
    return (field_number << 3) | wire_type


def _encode_len_delimited(out: bytearray, field_number: int, payload: bytes):
    _write_varint(out, _tag(field_number, 2))
    _write_varint(out, len(payload))
    out.extend(payload)


def _encode_bytes_list(values: List[bytes]) -> bytes:
    out = bytearray()
    for v in values:
        _encode_len_delimited(out, 1, v)
    return bytes(out)


def _encode_float_list(values) -> bytes:
    out = bytearray()
    _encode_len_delimited(out, 1, np.asarray(values, dtype="<f4").tobytes())
    return bytes(out)


def _encode_int64_list(values) -> bytes:
    body = bytearray()
    for v in values:
        _write_varint(body, int(v) & 0xFFFFFFFFFFFFFFFF)
    out = bytearray()
    _encode_len_delimited(out, 1, bytes(body))
    return bytes(out)


def build_example(features: Dict[str, Union[List[bytes], np.ndarray, list]]
                  ) -> bytes:
    """Serializes {name: values} into a tf.train.Example proto.  Kinds are
    inferred: bytes/str -> bytes_list; float arrays and lists of floats ->
    float_list; ints -> int64_list."""
    feats = bytearray()
    for name, values in features.items():
        if isinstance(values, (bytes, str)):
            values = [values]
        if isinstance(values, np.ndarray):
            if values.dtype.kind == "f":
                payload, field_no = _encode_float_list(values.reshape(-1)), 2
            elif values.dtype.kind in ("i", "u"):
                payload = _encode_int64_list(values.reshape(-1).tolist())
                field_no = 3
            else:
                raise ValueError(f"Unsupported ndarray dtype {values.dtype}")
        elif len(values) > 0 and isinstance(values[0], (bytes, str)):
            payload = _encode_bytes_list(
                [v.encode("utf-8") if isinstance(v, str) else v
                 for v in values])
            field_no = 1
        elif len(values) > 0 and isinstance(values[0], float):
            payload, field_no = _encode_float_list(values), 2
        else:
            payload, field_no = _encode_int64_list(values), 3
        feature = bytearray()
        _encode_len_delimited(feature, field_no, payload)
        entry = bytearray()
        _encode_len_delimited(entry, 1, name.encode("utf-8"))
        _encode_len_delimited(entry, 2, bytes(feature))
        _encode_len_delimited(feats, 1, bytes(entry))
    example = bytearray()
    _encode_len_delimited(example, 1, bytes(feats))
    return bytes(example)


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _parse_list(buf: bytes, kind: str):
    """Parses a BytesList / FloatList / Int64List body."""
    pos, n = 0, len(buf)
    values = []
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        wire = tag & 7
        if kind == "bytes":
            if tag != _tag(1, 2):
                raise IOError(f"unexpected tag {tag} in bytes_list")
            ln, pos = _read_varint(buf, pos)
            values.append(buf[pos:pos + ln])
            pos += ln
        elif kind == "float" and wire == 2:  # packed
            ln, pos = _read_varint(buf, pos)
            values.append(np.frombuffer(buf, dtype="<f4", count=ln // 4,
                                        offset=pos))
            pos += ln
        elif kind == "float" and wire == 5:  # one fixed32
            values.append(np.frombuffer(buf, dtype="<f4", count=1,
                                        offset=pos))
            pos += 4
        elif kind == "int64" and wire == 2:  # packed
            ln, pos = _read_varint(buf, pos)
            end = pos + ln
            while pos < end:
                v, pos = _read_varint(buf, pos)
                values.append(_signed(v))
        elif kind == "int64" and wire == 0:
            v, pos = _read_varint(buf, pos)
            values.append(_signed(v))
        else:
            raise IOError(f"bad {kind}_list wire type {wire}")
    if kind == "float":
        return (np.concatenate(values).astype(np.float32) if values
                else np.zeros([0], np.float32))
    if kind == "int64":
        return np.asarray(values, dtype=np.int64)
    return values


def _fields(buf: bytes):
    """Yields (tag, payload) of length-delimited fields, skipping others."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        wire = tag & 7
        if wire == 2:
            ln, pos = _read_varint(buf, pos)
            yield tag, buf[pos:pos + ln]
            pos += ln
        elif wire == 0:
            _, pos = _read_varint(buf, pos)
        elif wire in (1, 5):
            pos += 8 if wire == 1 else 4
        else:
            raise IOError(f"Cannot skip wire type {wire}")


def parse_example(serialized: bytes
                  ) -> Dict[str, Union[List[bytes], np.ndarray]]:
    """Parses a serialized tf.train.Example into {name: values}."""
    result: Dict[str, Union[List[bytes], np.ndarray]] = {}
    for tag, features in _fields(serialized):
        if tag != _tag(1, 2):
            continue
        for ftag, entry in _fields(features):
            if ftag != _tag(1, 2):
                continue
            name, value = None, []
            for etag, payload in _fields(entry):
                if etag == _tag(1, 2):
                    name = payload.decode("utf-8")
                elif etag == _tag(2, 2):
                    for kind_tag, body in _fields(payload):
                        kind = {_tag(1, 2): "bytes", _tag(2, 2): "float",
                                _tag(3, 2): "int64"}.get(kind_tag)
                        if kind is not None:
                            value = _parse_list(body, kind)
                            break
            result[name] = value
    return result
