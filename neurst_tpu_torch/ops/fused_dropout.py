"""Inverted dropout with a counter-based mask: a hand-written CUDA kernel
and its plain PyTorch version.

Counterpart of ``neurst_tpu/ops/fused_dropout.py``.  The TPU kernel
``_mask_kernel`` (hardware-PRNG bytes; XLA applies the compare and the
scale) becomes ``csrc/fused_dropout.cu``: one elementwise pass that draws
the mask in registers from Philox4x32-10 (``csrc/philox.cuh``) and writes
``keep ? x * scale : 0``, built for sm_90a and called through ctypes
(see ``ops/_build.py``).

The mask is a function of (key, stream, micro-batch, absolute element
index), see ``utils/rng.py``: element ``i`` is kept when word ``i & 3``
of ``philox4x32_10((i >> 2) low, (i >> 2) high, stream, micro; k0, k1)``
is at least the threshold.  ``dropout_words`` computes those words with
int64 tensor ops (``utils.rng.philox4x32_10``) and agrees bitwise with
the kernel, and with the
fused-FFN and flash kernels, which draw their masks the same way.

Rates: at a site the TPU path sends through its ``fused_dropout`` (at
least 65536 elements and a last dim divisible by 128,
``neurst_tpu/layers/common_layers.py:77-78``) the rate is quantized to
1/256 with the realized rate's scale (``threshold_and_scale(rate,
quantized=True)``); elsewhere the exact rate applies.

``dropout`` is differentiable: the backward runs the same kernel on the
output gradient with the same site.  The kernel wrapper
``fused_dropout_apply`` launches the kernel for CUDA tensors and raises on
anything it does not take; CPU tensors take the plain version.
"""

import ctypes
import functools

import torch

from neurst_tpu_torch.utils.rng import philox4x32_10, site_words

__all__ = ["dropout", "fused_dropout_apply", "dropout_reference",
           "dropout_words", "dropout_keep_mask", "threshold_and_scale",
           "quantized_site"]

_MASK32 = 0xFFFFFFFF
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the TPU path's fused_dropout gate (common_layers.py:77-78)
QUANTIZED_MIN_SIZE = 1 << 16
QUANTIZED_LANES = 128


def quantized_site(shape) -> bool:
    """Whether a dropout site of this shape takes the 1/256 rate (the
    sites the TPU path sends through its mask kernel)."""
    size = 1
    for s in shape:
        size *= int(s)
    return size >= QUANTIZED_MIN_SIZE and int(shape[-1]) % \
        QUANTIZED_LANES == 0


def threshold_and_scale(rate: float, quantized: bool):
    """(32-bit threshold, scale): quantized, ``t8 = round(rate * 256)``
    clipped to [1, 255] (``neurst_tpu/ops/fused_dropout.py:107-110``),
    threshold ``t8 << 24`` and scale ``1 / (1 - t8 / 256)``; exact,
    threshold ``round(rate * 2^32)`` and scale ``1 / (1 - rate)``
    (``neurst_tpu/ops/flash_attention.py:358-362``).  Rate 0 gives
    (0, 1.0): everything kept."""
    rate = float(rate)
    if rate <= 0.0:
        return 0, 1.0
    if quantized:
        t8 = min(max(int(round(rate * 256.0)), 1), 255)
        return t8 << 24, 1.0 / (1.0 - t8 / 256.0)
    return min(int(round(rate * 4294967296.0)), _MASK32), 1.0 / (1.0 - rate)


def dropout_words(n: int, key, device=None):
    """int64 [n]: the 32-bit mask word of elements 0 .. n - 1 of a site
    (``key`` a ``utils.rng.DropoutKey``)."""
    groups = (int(n) + 3) // 4
    g = torch.arange(groups, dtype=torch.int64, device=device)
    words = philox4x32_10(g & _MASK32, g >> 32, key.stream, key.micro,
                          key.k0, key.k1)
    return torch.stack(words, dim=1).reshape(-1)[:n]


def dropout_keep_mask(shape, key, threshold: int, device=None):
    """bool mask of the given shape, element i (row-major) kept when its
    word is at least ``threshold``."""
    n = 1
    for s in shape:
        n *= int(s)
    if threshold == 0:
        return torch.ones(tuple(shape), dtype=torch.bool, device=device)
    return (dropout_words(n, key, device) >= threshold).reshape(
        tuple(shape))


def dropout_reference(x, key, threshold: int, scale: float):
    """Plain version of the kernel: ``keep ? round(float(x) * scale) :
    0`` in x's dtype."""
    keep = dropout_keep_mask(x.shape, key, threshold, x.device)
    y = x.float() * torch.tensor(scale, dtype=torch.float32)
    return torch.where(keep, y, torch.zeros_like(y)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    from neurst_tpu_torch.ops._build import load
    fn = load("fused_dropout").neurst_fused_dropout
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                            ctypes.c_uint32, ctypes.c_float]
                   + [ctypes.c_uint32] * 4 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def fused_dropout_apply(x, key, threshold: int, scale: float):
    """``keep ? x * scale : 0`` with the site's mask.  CUDA tensors run
    the kernel (or raise); CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return dropout_reference(x, key, threshold, scale)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_dropout: dtype {x.dtype}; the kernel takes "
                        f"float32 or bfloat16")
    if x.device.type != "cuda" or not x.is_contiguous() or x.numel() == 0:
        raise ValueError("fused_dropout: x must be a non-empty contiguous "
                         "CUDA tensor")
    y = torch.empty_like(x)
    err = _kernel()(x.data_ptr(), y.data_ptr(), x.numel(), int(threshold),
                    float(scale), *site_words(key),
                    _DTYPE_CODES[x.dtype],
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_dropout launch failed: CUDA error {err}")
    fused_dropout_apply.launches += 1
    return y


fused_dropout_apply.launches = 0
fused_dropout_apply.kernel_name = "fused_dropout"


class _Dropout(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, key, threshold, scale):
        ctx.site = (key, threshold, scale)
        return fused_dropout_apply(x, key, threshold, scale)

    @staticmethod
    def backward(ctx, g):
        return (fused_dropout_apply(g.contiguous(), *ctx.site), None, None,
                None)


def dropout(x, rate: float, key, quantized: bool):
    """Differentiable inverted dropout of ``x`` at ``rate`` with the
    site's ``key``; ``quantized`` picks the 1/256 rate (see
    ``threshold_and_scale``)."""
    threshold, scale = threshold_and_scale(rate, quantized)
    if threshold == 0:
        return x
    return _Dropout.apply(x.contiguous(), key, threshold, scale)
