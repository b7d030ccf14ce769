"""Launch plans of the bf16 tensor-core kernels, shared by their
wrappers: how many blocks split one row tile's chunk loop, how many split
the rows of a product over rows, and the 16-byte alignment their staging
needs.  The CUDA sources take the counts as arguments; the CPU tests hold
the plans to the card's shape.

A block of these kernels holds one H100 SM (132 of them) for its whole
loop, so the plans count waves of 132 blocks.
"""

__all__ = ["SMS", "chunk_splits", "row_splits", "aligned16"]

SMS = 132
# a split of a chunk loop takes at least this many chunks, so that its
# float32 partial (written once, summed once) stays small beside its work
MIN_CHUNKS = 8
# a row split of a product over rows takes at least this many 64-row slabs
MIN_SLABS = 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def chunk_splits(tiles: int, chunks: int) -> int:
    """Splits S of each row tile's loop over ``chunks`` chunks.  The
    critical path of S is waves of ``tiles`` x S blocks times
    ceil(chunks / S) chunks a block; each split adds a float32 partial
    to write and sum, so this takes the smallest S whose path is within
    1/8 of the shortest (each split at least ``MIN_CHUNKS`` chunks)."""
    def path(s):
        return _cdiv(tiles * s, SMS) * _cdiv(chunks, s)
    candidates = range(1, max(1, chunks // MIN_CHUNKS) + 1)
    shortest = min(path(s) for s in candidates)
    return next(s for s in candidates if 8 * path(s) <= 9 * shortest)


def row_splits(tiles: int, rows: int) -> int:
    """Row splits of a product over rows whose output has ``tiles``
    tiles of one block each: as many as fill the card's resident blocks
    once (one an SM), each split taking at least ``MIN_SLABS`` slabs of
    64 rows."""
    return max(1, min(SMS // tiles, _cdiv(rows, 64) // MIN_SLABS))


def aligned16(x):
    """x contiguous and 16-byte aligned (the kernels stage 16-byte
    vectors); a copy only where a view starts mid-vector."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()
