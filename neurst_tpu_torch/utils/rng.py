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
           "site_words", "key_words", "group_base", "at_row", "at_shard",
           "philox4x32_10", "SIDE_ENCODER", "SIDE_DECODER",
           "SIDE_ASR_DECODER", "SIDE_BERT", "SIDE_ROUTER"]

_MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
# third counter word of the derivations, apart from any site's stream
_FOLD, _SPLIT = 0xF01D0000, 0x5B170000

# stream = side << 16 | layer << 4 | site (sites numbered per layer in
# ``layers/transformer_layers.py``); the multi-task speech model's
# transcript decoder has a side of its own, so its masks are not the
# translation decoder's, and so has a BERT trunk (CTNMT runs one beside
# its own encoder)
SIDE_ENCODER, SIDE_DECODER, SIDE_ASR_DECODER, SIDE_BERT = 1, 2, 3, 4
# an MoE layer's router jitter draws from its FFN site's stream with
# SIDE_ROUTER << 24 added (sides fill bits 16-23), so its noise is no
# dropout mask of any layer
SIDE_ROUTER = 5


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
    # the batch row of the single-rank batch that the tensor's first row
    # is (a data-parallel rank's or a pipeline micro-batch's offset), how
    # many such shards the single-rank batch has (a site's rate is
    # quantized by the size of the single-rank tensor), and how many batch
    # rows the shard holds: element i of a site's tensor of n elements
    # draws the mask of element row x n / rows + i, so a shard draws its
    # rows' masks whatever the site's layout ([B, ...] or [B x T, ...])
    row: int = 0
    shards: int = 1
    rows: int = 0


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
    return [key._replace(**dict(zip(("k0", "k1"), _derive(key, i, _SPLIT))),
                         micro=i)
            for i in range(int(n))]


def site_words(key: Optional[DropoutKey]):
    """(k0, k1, stream, micro), the words a kernel takes for its site;
    zeros without a key (no dropout)."""
    return (0, 0, 0, 0) if key is None else tuple(key)[:4]


def key_words(key: Optional[DropoutKey]):
    """(k0, k1, stream, micro, row, shards, rows) of a key, zeros without
    one (the ``int[] key`` argument of the port's custom operators)."""
    return (0, 0, 0, 0, 0, 1, 0) if key is None else tuple(key)


def group_base(key: Optional[DropoutKey], numel: int) -> int:
    """The first element group (4 elements) of a site whose tensor holds
    ``numel`` elements: ``key.row x numel / key.rows / 4``, the one place
    where the key's batch-row offset becomes an element offset.  Raises
    when the tensor's elements do not split evenly into its batch rows, or
    the offset is not a multiple of 4 (the kernels draw 4 elements' words
    at once)."""
    if key is None or not key.row:
        return 0
    per_row, rest = divmod(int(numel), int(key.rows))
    base = int(key.row) * per_row
    if rest or base % 4:
        raise ValueError(f"dropout row offset {key.row} of a site of "
                         f"{numel} elements in {key.rows} batch rows is "
                         f"not a whole multiple of 4 elements")
    return base // 4


def at_row(key: Optional[DropoutKey], offset: int, rows: int,
           shards: int = 1) -> Optional[DropoutKey]:
    """``key`` moved ``offset`` batch rows on, for tensors of ``rows``
    batch rows that are one of ``shards`` equal row shards of their
    sites' (None stays None, and the one shard at offset 0 is the key
    itself)."""
    if key is None or (not offset and shards == 1):
        return key
    return key._replace(row=key.row + int(offset), rows=int(rows),
                        shards=key.shards * int(shards))


def at_shard(key: Optional[DropoutKey], coord: int, field: int = 0
             ) -> Optional[DropoutKey]:
    """``key`` with a shard coordinate folded into its micro-batch word
    (bits 20-25 for field 0, a tensor-parallel rank; bits 26-31 for field
    1, a ring rank), so ranks that hold other parts of a tensor draw
    independent masks (None stays None)."""
    if key is None:
        return None
    return key._replace(micro=(key.micro + ((int(coord) + 1)
                                            << (20 + 6 * field)))
                        & _MASK32)


def at_site(key: Optional[DropoutKey], stream: int
            ) -> Optional[DropoutKey]:
    """``key`` with ``stream`` added to its stream word (None stays
    None, so layers thread an absent key through unchanged)."""
    if key is None:
        return None
    return key._replace(stream=(key.stream + int(stream)) & _MASK32)
