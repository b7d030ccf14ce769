"""Zstandard decompression through the port's own decoder
(``csrc/zstd_decompress.cpp``, RFC 8878), for the orbax checkpoint
format: TensorStore compresses the OCDBT nodes and the zarr chunks with
zstd.  The library is built from the repository's source with the host
C++ compiler at first use (``ops/_build.py``; a failed build raises);
neither the ``zstandard`` package nor ``libzstd`` is used.

``decompress(data)`` decodes every frame of ``data`` (skippable frames
skipped) and checks each frame's content checksum where it has one; a
corrupt frame or a frame that needs a dictionary raises ``ValueError``.
"""

import ctypes

__all__ = ["decompress"]

_LIB = None


def _native() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from neurst_tpu_torch.ops import _build
        lib = _build.load("zstd_decompress")
        lib.neurst_zstd_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_char_p)]
        lib.neurst_zstd_decode.restype = ctypes.c_void_p
        lib.neurst_zstd_size.argtypes = [ctypes.c_void_p]
        lib.neurst_zstd_size.restype = ctypes.c_size_t
        lib.neurst_zstd_data.argtypes = [ctypes.c_void_p]
        lib.neurst_zstd_data.restype = ctypes.c_void_p
        lib.neurst_zstd_free.argtypes = [ctypes.c_void_p]
        lib.neurst_zstd_free.restype = None
        _LIB = lib
    return _LIB


def decompress(data: bytes) -> bytes:
    """The concatenated contents of every zstd frame in ``data``."""
    lib = _native()
    data = bytes(data)
    error = ctypes.c_char_p()
    handle = lib.neurst_zstd_decode(data, len(data), ctypes.byref(error))
    if not handle:
        raise ValueError(error.value.decode())
    try:
        size = lib.neurst_zstd_size(handle)
        return ctypes.string_at(lib.neurst_zstd_data(handle), size) \
            if size else b""
    finally:
        lib.neurst_zstd_free(handle)
