"""FLAC decoding in the port's host library (counterpart of
``neurst_tpu/data/audio/flac_io.py``).

The decoder (``csrc/flac_decoder.cpp``) is built by ``ops/_build.py`` with
the host C++ compiler (``$CXX``, else ``c++``) into
``build/torch_kernels/`` at its first use and bound through ctypes.  A
failed build raises ``RuntimeError`` with the compiler's output: there is
no fallback.
"""

import ctypes
import functools
from typing import Tuple

import numpy as np

__all__ = ["decode_flac", "flac_available"]


@functools.lru_cache(maxsize=None)
def _native() -> ctypes.CDLL:
    from neurst_tpu_torch.ops import _build
    lib = _build.load("flac_decoder")
    lib.flac_decode.restype = ctypes.c_int
    lib.flac_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.flac_free.argtypes = [ctypes.POINTER(ctypes.c_int32)]
    return lib


def flac_available() -> bool:
    """True once the decoder is built and loaded; a failed build raises."""
    return _native() is not None


def decode_flac(data: bytes) -> Tuple[np.ndarray, int]:
    """FLAC bytes -> (float32 mono waveform in int16 scale, rate)."""
    lib = _native()
    samples = ctypes.POINTER(ctypes.c_int32)()
    n = ctypes.c_longlong()
    rate = ctypes.c_int()
    channels = ctypes.c_int()
    bps = ctypes.c_int()
    rc = lib.flac_decode(data, len(data), ctypes.byref(samples),
                         ctypes.byref(n), ctypes.byref(rate),
                         ctypes.byref(channels), ctypes.byref(bps))
    if rc != 0:
        raise ValueError(f"flac decode failed (code {rc})")
    try:
        count = n.value * channels.value
        arr = np.ctypeslib.as_array(samples, shape=(count,)).astype(
            np.float32)
    finally:
        lib.flac_free(samples)
    if channels.value > 1:
        arr = arr.reshape(-1, channels.value).mean(axis=1)
    # normalize to the int16 value range of the wav path
    shift = bps.value - 16
    if shift > 0:
        arr = arr / float(1 << shift)
    elif shift < 0:
        arr = arr * float(1 << (-shift))
    return arr, rate.value
