"""Row-count gate of the port's fused FFN: a copy of the ``fused_ffn``
thresholds of ``neurst_tpu/ops/kernel_gates.json`` as
``neurst_tpu/ops/kernel_gates.py:87-103`` reads them, so the port takes the
JAX package's path at every shape.  Thresholds only: the table's
measurements were taken on another device and are not the port's.  An
H100 sweep of the gate is later work.
"""

from typing import Optional

__all__ = ["fused_ffn_min_rows"]

# mode -> model dim -> smallest row count that takes the fused FFN; a mode
# or dim not listed (and None) = never
_FUSED_FFN_MIN_ROWS = {
    "train": {256: 16384, 512: 16384},
    "train_drop": {256: 1024, 512: 16384},
}


def fused_ffn_min_rows(mode: str, d: int) -> Optional[int]:
    """Smallest row count at which the fused FFN is used in ``mode``
    ("train" | "train_drop" | "infer") at model dim ``d``; None = never."""
    return _FUSED_FFN_MIN_ROWS.get(mode, {}).get(d)
