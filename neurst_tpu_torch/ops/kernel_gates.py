"""Row-count gate of the port's fused FFN.

The thresholds start as a copy of the ``fused_ffn`` thresholds of
``neurst_tpu/ops/kernel_gates.json`` as
``neurst_tpu/ops/kernel_gates.py:87-103`` reads them (thresholds only:
that table's measurements were taken on another device and are not the
port's).  D 256, the dim the kernels are built for, was swept on the
card: ``H100_SWEEP`` holds the device ms of the fused FFN and of the
composite (linear -> relu -> the port's dropout -> linear), forward and
backward through autograd (``infer``: forward alone), D 256, F 2048,
bf16, from ``tools/sweep_torch_ffn_gate.py`` on an NVIDIA H100 80GB HBM3
at a 700.00 W power limit.  A D 256 training entry is the smallest
measured row count from which the fused FFN wins at every larger one
(``min_rows_from_sweep``); where it loses at every row count (``train``)
the copied threshold stays.  ``infer`` stays off, as in the JAX table:
the fused forward loses at all but one row count, and the decode path's
launch checks assume it off.

    rows    train (fused, composite)  train_drop         infer
    1024    0.1733, 0.0629            0.1816, 0.0727     0.0463, 0.0166
    2048    0.1836, 0.0874            0.1932, 0.1003     0.0489, 0.0210
    4096    0.2043, 0.1307            0.2142, 0.1567     0.0579, 0.0354
    6000    0.2397, 0.1839            0.2596, 0.2211     0.0795, 0.0487
    8192    0.2597, 0.2280            0.2795, 0.2787     0.0848, 0.0648
    12000   0.4478, 0.3186            0.4754, 0.3909     0.1568, 0.0926
    16384   0.4429, 0.4120            0.4818, 0.5185     0.1192, 0.1205
    30000   0.7272, 0.6967            0.8023, 0.8829     0.2284, 0.2160
"""

from typing import Dict, Optional, Tuple

__all__ = ["fused_ffn_min_rows", "min_rows_from_sweep", "H100_SWEEP"]

# mode -> rows -> (fused ms, composite ms): the table above
H100_SWEEP = {
    "train": {1024: (0.1733, 0.0629), 2048: (0.1836, 0.0874),
              4096: (0.2043, 0.1307), 6000: (0.2397, 0.1839),
              8192: (0.2597, 0.2280), 12000: (0.4478, 0.3186),
              16384: (0.4429, 0.4120), 30000: (0.7272, 0.6967)},
    "train_drop": {1024: (0.1816, 0.0727), 2048: (0.1932, 0.1003),
                   4096: (0.2142, 0.1567), 6000: (0.2596, 0.2211),
                   8192: (0.2795, 0.2787), 12000: (0.4754, 0.3909),
                   16384: (0.4818, 0.5185), 30000: (0.8023, 0.8829)},
    "infer": {1024: (0.0463, 0.0166), 2048: (0.0489, 0.0210),
              4096: (0.0579, 0.0354), 6000: (0.0795, 0.0487),
              8192: (0.0848, 0.0648), 12000: (0.1568, 0.0926),
              16384: (0.1192, 0.1205), 30000: (0.2284, 0.2160)},
}

# mode -> model dim -> smallest row count that takes the fused FFN; a mode
# or dim not listed (and None) = never.  D 256 "train_drop" is the sweep's
# 16384; the rest are the JAX package's.
_FUSED_FFN_MIN_ROWS = {
    "train": {256: 16384, 512: 16384},
    "train_drop": {256: 16384, 512: 16384},
}


def min_rows_from_sweep(
        table: Dict[int, Tuple[float, float]]) -> Optional[int]:
    """The smallest measured row count from which the fused FFN wins at
    every larger measured count, from {rows: (fused ms, composite ms)};
    None where it loses at the largest."""
    best = None
    for rows in sorted(table, reverse=True):
        fused_ms, composite_ms = table[rows]
        if fused_ms >= composite_ms:
            break
        best = rows
    return best


def fused_ffn_min_rows(mode: str, d: int) -> Optional[int]:
    """Smallest row count at which the fused FFN is used in ``mode``
    ("train" | "train_drop" | "infer") at model dim ``d``; None = never."""
    return _FUSED_FFN_MIN_ROWS.get(mode, {}).get(d)
