"""Zarr v2 arrays inside an OCDBT store, as orbax writes them with
``use_zarr3: false`` (the port's counterpart of TensorStore's zarr
driver over ``utils/ocdbt``).

An array ``name`` is the key ``<name>/.zarray`` (JSON: ``shape``,
``chunks``, ``dtype``, ``fill_value``, ``order`` "C",
``dimension_separator`` ".", ``compressor`` ``{"id": "zstd", ...}`` or
null, ``filters`` null) and one key a chunk, ``i.j...`` by chunk index
(``0`` for a 0-d array).  A chunk holds the whole chunk shape in C order,
also at the array's edges; a missing chunk is the fill value (zero when
it is null).  Dtypes: little-endian ``<f4``, ``<f8``, ``<f2``, ``<i8``,
``<i4``, ``<i2``, ``|i1``, ``|u1``, ``<u4``, ``|b1`` and ``bfloat16``
(returned as float32, which holds every bfloat16 value exactly: numpy
has no bfloat16 without ml_dtypes).

``read_array(store, name)`` -> numpy array; ``zarray(shape, chunks,
dtype)`` and ``chunk_bytes(block, chunks)`` give the items
a writer puts in the store: the port writes ``compressor: null``.
"""

import itertools
import json
from typing import Dict, Sequence

import numpy as np

from neurst_tpu_torch.utils import zstd

__all__ = ["read_array", "zarray", "chunk_key", "chunk_bytes",
           "zarr_dtype"]

_DTYPES = {"<f4": np.float32, "<f8": np.float64, "<f2": np.float16,
           "<i8": np.int64, "<i4": np.int32, "<i2": np.int16,
           "|i1": np.int8, "|u1": np.uint8, "<u4": np.uint32,
           "<u8": np.uint64, "|b1": np.bool_}


def zarr_dtype(array: np.ndarray) -> str:
    """The zarr dtype string of a numpy array (``bfloat16`` is written
    from its uint16 bits by the caller)."""
    for name, dtype in _DTYPES.items():
        if array.dtype == dtype:
            return name
    raise ValueError(f"zarr: no dtype for {array.dtype}")


def _decode_chunk(raw: bytes, meta: dict) -> np.ndarray:
    compressor = meta.get("compressor")
    if compressor is not None:
        if compressor.get("id") != "zstd":
            raise ValueError(f"zarr: compressor {compressor} is not "
                             f"supported")
        raw = zstd.decompress(raw)
    chunks = tuple(meta["chunks"])
    dtype = meta["dtype"]
    if dtype == "bfloat16":
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        out = bits.view(np.float32)
    elif dtype in _DTYPES:
        out = np.frombuffer(raw, dtype=_DTYPES[dtype])
    else:
        raise ValueError(f"zarr: dtype {dtype!r} is not supported")
    if out.size != int(np.prod(chunks, dtype=np.int64)):
        raise ValueError(f"zarr: chunk of {out.size} elements, not "
                         f"{chunks}")
    return out.reshape(chunks)


def chunk_key(index: Sequence[int]) -> str:
    return ".".join(str(i) for i in index) if len(index) else "0"


def read_array(store, name: str) -> np.ndarray:
    """The array ``name`` of an ``ocdbt.OcdbtReader``."""
    meta = json.loads(store.get(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" \
            or meta.get("filters"):
        raise ValueError(f"zarr: {name}: only zarr v2, C order, no "
                         f"filters")
    if meta.get("dimension_separator", ".") != ".":
        raise ValueError(f"zarr: {name}: dimension separator "
                         f"{meta['dimension_separator']!r}")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    dtype = np.float32 if meta["dtype"] == "bfloat16" \
        else _DTYPES[meta["dtype"]]
    fill = meta.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, dtype=dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for index in itertools.product(*grid):
        key = f"{name}/{chunk_key(index)}".encode()
        if key not in store.refs:
            continue
        chunk = _decode_chunk(store.get(key), meta)
        dst = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(index, chunks, shape))
        src = tuple(slice(0, d.stop - d.start) for d in dst)
        out[dst] = chunk[src]
    return out


def zarray(shape, chunks, dtype: str) -> bytes:
    """The ``.zarray`` of an uncompressed array."""
    return json.dumps({
        "chunks": list(chunks), "compressor": None,
        "dimension_separator": ".", "dtype": dtype, "fill_value": None,
        "filters": None, "order": "C", "shape": list(shape),
        "zarr_format": 2}, separators=(",", ":")).encode()


def chunk_bytes(block: np.ndarray, chunks) -> bytes:
    """A chunk's bytes: ``block`` (C order, little-endian) padded with
    zeros to the whole chunk shape."""
    block = np.asarray(block, order="C")
    if tuple(block.shape) != tuple(chunks):
        full = np.zeros(chunks, dtype=block.dtype)
        full[tuple(slice(0, s) for s in block.shape)] = block
        block = full
    return block.astype(block.dtype.newbyteorder("<"), copy=False).tobytes()
