"""Row-count gate of the port's fused FFN.

The thresholds start as a copy of the ``fused_ffn`` thresholds of
``neurst_tpu/ops/kernel_gates.json`` as
``neurst_tpu/ops/kernel_gates.py:87-103`` reads them (thresholds only:
that table's measurements were taken on another device and are not the
port's).  D 256 and 512, the dims the kernels are built for (and the
only ones at which the JAX gate fuses), were swept on the card:
``H100_SWEEP`` holds the device ms of the fused FFN and of the composite
(linear -> relu -> the port's dropout -> linear), forward and backward
through autograd (``infer``: forward alone), F 2048, bf16, from
``tools/sweep_torch_ffn_gate.py --dim D`` on an NVIDIA H100 80GB HBM3 at
a 700.00 W power limit.  A training entry is the smallest measured row
count from which the fused FFN wins at every larger one
(``min_rows_from_sweep``); where it loses at every row count the copied
threshold stays, so the path still runs the ported kernels.  ``infer``
stays off, as in the JAX table: the fused forward loses at all but one
row count, and the decode path's launch checks assume it off.

D 256 (the speech recipe's width):

    rows    train (fused, composite)  train_drop         infer
    1024    0.1733, 0.0629            0.1816, 0.0727     0.0463, 0.0166
    2048    0.1836, 0.0874            0.1932, 0.1003     0.0489, 0.0210
    4096    0.2043, 0.1307            0.2142, 0.1567     0.0579, 0.0354
    6000    0.2397, 0.1839            0.2596, 0.2211     0.0795, 0.0487
    8192    0.2597, 0.2280            0.2795, 0.2787     0.0848, 0.0648
    12000   0.4478, 0.3186            0.4754, 0.3909     0.1568, 0.0926
    16384   0.4429, 0.4120            0.4818, 0.5185     0.1192, 0.1205
    30000   0.7272, 0.6967            0.8023, 0.8829     0.2284, 0.2160

D 512 (transformer_base; the fused FFN loses at every row count, by
1.5-3.9x, so both training thresholds keep the JAX package's 16384):

    rows    train (fused, composite)  train_drop         infer
    1024    0.2788, 0.0716            0.2824, 0.0811     0.0660, 0.0186
    2048    0.3009, 0.1056            0.3057, 0.1205     0.0762, 0.0272
    4096    0.3698, 0.1595            0.3748, 0.1871     0.1193, 0.0436
    6000    0.4738, 0.2203            0.4820, 0.2584     0.2024, 0.0631
    8192    0.4968, 0.2833            0.5054, 0.3322     0.1743, 0.0833
    12000   0.8508, 0.4035            0.8696, 0.4812     0.3291, 0.1239
    16384   0.9494, 0.5095            0.9667, 0.6086     0.3362, 0.1575
    30000   1.8144, 0.8820            1.8339, 1.0642     0.6505, 0.2810
    32768   1.8409, 0.9364            1.8712, 1.1412     0.6551, 0.2988
"""

from typing import Dict, Optional, Tuple

__all__ = ["fused_ffn_min_rows", "min_rows_from_sweep", "H100_SWEEP"]

# model dim -> mode -> rows -> (fused ms, composite ms): the tables above
H100_SWEEP = {256: {
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
}, 512: {
    "train": {1024: (0.2788, 0.0716), 2048: (0.3009, 0.1056),
              4096: (0.3698, 0.1595), 6000: (0.4738, 0.2203),
              8192: (0.4968, 0.2833), 12000: (0.8508, 0.4035),
              16384: (0.9494, 0.5095), 30000: (1.8144, 0.8820),
              32768: (1.8409, 0.9364)},
    "train_drop": {1024: (0.2824, 0.0811), 2048: (0.3057, 0.1205),
                   4096: (0.3748, 0.1871), 6000: (0.4820, 0.2584),
                   8192: (0.5054, 0.3322), 12000: (0.8696, 0.4812),
                   16384: (0.9667, 0.6086), 30000: (1.8339, 1.0642),
                   32768: (1.8712, 1.1412)},
    "infer": {1024: (0.0660, 0.0186), 2048: (0.0762, 0.0272),
              4096: (0.1193, 0.0436), 6000: (0.2024, 0.0631),
              8192: (0.1743, 0.0833), 12000: (0.3291, 0.1239),
              16384: (0.3362, 0.1575), 30000: (0.6505, 0.2810),
              32768: (0.6551, 0.2988)},
}}

# mode -> model dim -> smallest row count that takes the fused FFN; a mode
# or dim not listed (and None) = never.  D 256 "train_drop" is the sweep's
# 16384; the rest are the JAX package's (the sweeps found no row count
# from which the fused FFN wins).
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
