"""Explicit dropout keys (the port's stand-in for the ``jax.random`` keys
that ``neurst_tpu/parallel/train_step.py`` folds with the step and splits
per micro-batch).

A ``DropoutKey`` is four plain Python integers: the two 32-bit key words
of Philox4x32-10 and the two counter words that name a dropout site
(``stream``) and a micro-batch (``micro``).  Every dropout mask of the
port is a function of (key, stream, micro, absolute element index): the
mask kernels and their plain versions (``ops/fused_dropout.py``) read
word ``i & 3`` of ``philox4x32_10((i >> 2) low, (i >> 2) high, stream,
micro; k0, k1)`` for element ``i``.  Deriving keys here is pure Python:
it draws nothing from torch's global generator and never waits on the
device.  The bits are not those of JAX's threefry, nor of the TPU's
hardware generator; nothing depends on them.
"""

from typing import List, NamedTuple, Optional

__all__ = ["DropoutKey", "make_key", "fold_in", "split", "at_site",
           "site_words", "philox4x32_10", "SIDE_ENCODER", "SIDE_DECODER"]

_MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
# third counter word of the derivations, apart from any site's stream
_FOLD, _SPLIT = 0xF01D0000, 0x5B170000

# stream = side << 16 | layer << 4 | site (sites numbered per layer in
# ``layers/transformer_layers.py``)
SIDE_ENCODER, SIDE_DECODER = 1, 2


def _mulhilo(m: int, c):
    """(high, low) 32-bit words of m * c for a 32-bit constant m and a
    32-bit c (a Python int or an int64 tensor), with no int64 overflow: m
    is split into 16-bit halves, so every partial product stays below
    2^48."""
    p_lo = c * (m & 0xFFFF)
    p_hi = c * (m >> 16)
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11): four 32-bit counter words,
    each a Python int or an int64 tensor (broadcastable), and two Python
    key words -> four 32-bit words of the counters' type.  On tensors it
    is the plain twin of ``csrc/philox.cuh``."""
    k0, k1 = int(k0) & _MASK32, int(k1) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W0) & _MASK32, (k1 + PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


class DropoutKey(NamedTuple):
    k0: int
    k1: int
    stream: int = 0
    micro: int = 0


def make_key(seed: int) -> DropoutKey:
    """The key of an integer seed (its low and high 32-bit words)."""
    seed = int(seed)
    return DropoutKey(seed & _MASK32, (seed >> 32) & _MASK32)


def _derive(key: DropoutKey, n: int, tag: int):
    n = int(n)
    return philox4x32_10(n & _MASK32, (n >> 32) & _MASK32, tag, 0, key.k0,
                         key.k1)[:2]


def fold_in(key: DropoutKey, n: int) -> DropoutKey:
    """A new key from ``key`` and the integer ``n`` (the step)."""
    return key._replace(**dict(zip(("k0", "k1"), _derive(key, n, _FOLD))))


def split(key: DropoutKey, n: int) -> List[DropoutKey]:
    """``n`` distinct keys, the i-th with ``micro = i``."""
    return [DropoutKey(*_derive(key, i, _SPLIT), stream=key.stream, micro=i)
            for i in range(int(n))]


def site_words(key: Optional[DropoutKey]):
    """(k0, k1, stream, micro), the words a kernel takes for its site;
    zeros without a key (no dropout)."""
    return (0, 0, 0, 0) if key is None else tuple(key)


def at_site(key: Optional[DropoutKey], stream: int
            ) -> Optional[DropoutKey]:
    """``key`` with ``stream`` added to its stream word (None stays
    None, so layers thread an absent key through unchanged)."""
    if key is None:
        return None
    return key._replace(stream=(key.stream + int(stream)) & _MASK32)
