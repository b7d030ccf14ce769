"""Fused position-wise FFN, ``dropout(relu(x W1^T + b1)) W2^T + b2``: a
hand-written CUDA kernel set and its plain PyTorch version.

Counterpart of ``neurst_tpu/ops/fused_ffn.py``.  The TPU kernels
``_ffn_fwd_kernel`` and ``_ffn_bwd_kernel`` become ``csrc/fused_ffn.cu``:
a forward kernel, followed where it splits the filter over blocks by a
sum of the float32 partials (``fwd_splits``), and a backward in three
launches (a dx pass over row tiles, a dW pass over row splits, a
deterministic sum of the splits and of the bias partials), built for
sm_90a for D 256 and 512 and called through ctypes (see
``ops/_build.py``).  bf16 products run on the tensor cores.  The bf16 dx
pass also writes round(dh) [R, F] to a scratch buffer, which makes its
dW pass two products over rows, round(dh)^T x and dy^T hd; the float32
dW pass recomputes dh (``bwd_scratch`` sizes the buffers).

Semantics follow the TPU kernels: float32 accumulation; the hidden is
rounded to the compute dtype after the bias, relu and dropout; the
training forward saves that post-dropout hidden ``hd`` [R, F] and the
backward reads its masks from ``hd > 0`` (no recompute).  Dropout is the
FFN site's counter-based mask (``ops/fused_dropout.py``) at the absolute
index ``r F + f``, with the rate quantized to 1/256 as the TPU kernel
quantizes it.  Weights are in ``nn.Linear``'s layout: w1 [F, D], w2
[D, F].

``fused_ffn`` is differentiable (a ``torch.autograd.Function``).  The
kernel wrappers ``fused_ffn_fwd`` and ``fused_ffn_bwd`` launch the
kernels for CUDA tensors and raise on anything they do not take; CPU
tensors take the plain versions, which the CPU tests hold against the
JAX Pallas kernels in interpret mode.  ``fused_ffn_available`` is the
JAX package's gate (``ops/kernel_gates.py`` holds a copy of its
thresholds) restricted to the dims the kernels are built for.
"""

import ctypes
import functools

import torch

from neurst_tpu_torch.ops._plan import (SMS, aligned16, chunk_splits,
                                       row_splits)
from neurst_tpu_torch.ops.fused_dropout import (dropout_keep_mask,
                                                threshold_and_scale)
from neurst_tpu_torch.ops.kernel_gates import fused_ffn_min_rows
from neurst_tpu_torch.utils.rng import site_words

__all__ = ["fused_ffn", "fused_ffn_fwd", "fused_ffn_bwd",
           "fused_ffn_available", "DIMS"]

# model dims the CUDA kernels are compiled for (those at which the JAX
# package's gate fuses); the filter size must be a multiple of 128
DIMS = (256, 512)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMS = SMS
# bf16 forward and dx pass: filter columns of a chunk (kDxChunk)
_CHUNK = 64
# float32 dW pass (csrc/fused_ffn.cu): rows per tile (kDwRowsF32) and the
# filter columns of one of its blocks (kCols)
_DW_ROWS_F32 = 32
_DW_COLS_F32 = 64
# bf16 backward: the filter rows and dims of a dW pass output tile
# (kRpTileM and kN of csrc/row_product.cuh) and its resident blocks an SM
# (__launch_bounds__)
_DW_TILE_F = 128
_DW_TILE_D = 256
_DW_BLOCKS_PER_SM = 1


def fused_ffn_available(d: int, f: int, activation: str, rows: int,
                        is_training: bool = True,
                        dropout_rate: float = 0.0) -> bool:
    """The JAX package's choice (``neurst_tpu/ops/fused_ffn.py:66-98``):
    relu, d and f multiples of 128, W1 + W2 and their float32 gradients
    within 24 MiB, and at least the gate's row count for the mode
    ("infer", "train", or "train_drop" when training with dropout);
    here also a dim the kernels are built for."""
    if not (activation == "relu" and d % 128 == 0 and f % 128 == 0
            and d * f * 8 <= 24 * 2 ** 20 and d in DIMS):
        return False
    if not is_training:
        mode = "infer"
    elif dropout_rate and dropout_rate > 0.0:
        mode = "train_drop"
    else:
        mode = "train"
    min_rows = fused_ffn_min_rows(mode, d)
    return min_rows is not None and rows >= min_rows


def _drop(dropout_rate, dropout_key):
    """(threshold, scale, key) of the FFN site, quantized to 1/256."""
    threshold, scale = threshold_and_scale(dropout_rate or 0.0, True)
    if threshold and dropout_key is None:
        raise ValueError("fused_ffn dropout_rate > 0 needs a dropout_key")
    return threshold, scale, dropout_key


def _fwd_plain(x2, w1, b1, w2, b2, drop, save_hidden):
    """(y [R, D], hd [R, F] or None): the kernel's arithmetic in plain
    PyTorch."""
    threshold, scale, key = drop
    h = torch.relu(torch.matmul(x2.float(), w1.float().t()) + b1.float())
    if threshold:
        keep = dropout_keep_mask(h.shape, key, threshold, h.device)
        h = torch.where(keep, h * torch.tensor(scale, dtype=torch.float32),
                        torch.zeros_like(h))
    hd = h.to(x2.dtype)
    y = torch.matmul(hd.float(), w2.float().t()) + b2.float()
    return y.to(x2.dtype), (hd if save_hidden else None)


def _bwd_plain(x2, w1, w2, hd, dy, scale):
    """(dx, dW1 [F, D], dW2 [D, F], db1, db2) from hd and dy, rounded
    where the TPU kernel rounds: dh before the dW1 and dx products (db1
    takes the unrounded dh)."""
    dyf = dy.to(x2.dtype).float()
    hdf = hd.float()
    dhd = torch.matmul(dyf, w2.float())
    dh = torch.where(hdf > 0.0,
                     dhd * torch.tensor(scale, dtype=torch.float32),
                     torch.zeros_like(dhd))
    dhc = dh.to(x2.dtype).float()
    dx = torch.matmul(dhc, w1.float()).to(x2.dtype)
    dw1 = torch.matmul(dhc.t(), x2.float()).to(w1.dtype)
    dw2 = torch.matmul(dyf.t(), hdf).to(w2.dtype)
    return dx, dw1, dw2, dh.sum(dim=0), dyf.sum(dim=0)


def _check_cuda_inputs(x2, w1, w2, *others):
    if x2.dtype not in _DTYPE_CODES or w1.dtype != x2.dtype \
            or w2.dtype != x2.dtype:
        raise TypeError(f"fused_ffn: x {x2.dtype}, w1 {w1.dtype}, w2 "
                        f"{w2.dtype}; they must share float32 or bfloat16")
    rows, dim = x2.shape
    filter_size = w1.shape[0]
    if w1.shape != (filter_size, dim) or w2.shape != (dim, filter_size):
        raise ValueError(f"fused_ffn: x {tuple(x2.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}; want "
                         f"[R, D], [F, D], [D, F]")
    if dim not in DIMS or filter_size % 128 or rows == 0:
        raise ValueError(f"fused_ffn: dim {dim} not in {DIMS}, filter "
                         f"{filter_size} not a multiple of 128, or no rows")
    for x in (x2, w1, w2) + others:
        if x.device.type != "cuda" or x.device != x2.device \
                or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("fused_ffn: every input must be contiguous, "
                             "16-byte aligned, on x's CUDA device")


@functools.lru_cache(maxsize=None)
def _kernel(name):
    """The C entry point ``neurst_ffn_<name>``, built and typed once."""
    from neurst_tpu_torch.ops._build import load
    fn = getattr(load("fused_ffn"), f"neurst_ffn_{name}")
    ptr, i32, f32, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_uint32)
    fn.argtypes = {
        "fwd": [ptr] * 8 + [i32] * 4 + [u32, f32] + [u32] * 4 + [i32, ptr],
        "fwd_sum": [ptr] * 3 + [i32] * 3 + [ptr],
        "dx": [ptr] * 7 + [i32] * 4 + [f32, i32, ptr],
        "dw": [ptr] * 6 + [i32] * 4 + [f32, i32, ptr],
        "dw_sum": [ptr] * 5 + [i32] * 5 + [ptr],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _check(name, err):
    if err != 0:
        raise RuntimeError(f"fused_ffn {name} launch failed: CUDA error "
                           f"{err}")


def fwd_rows(dim: int) -> int:
    """Rows of a bf16 forward tile (csrc/fused_ffn.cu: kFwdRows, and
    kWideRows at D 512)."""
    return 64 if dim == 512 else 128


def fwd_splits(rows: int, filter_size: int, dim: int, dtype) -> int:
    """Filter splits of the forward: bf16 row tiles (``fwd_rows``), each
    split over S blocks where the tiles alone would leave SMs idle
    (``_plan.chunk_splits`` over the 64-column chunks); float32 takes
    one."""
    if dtype != torch.bfloat16:
        return 1
    return chunk_splits(-(-rows // fwd_rows(dim)), filter_size // _CHUNK)


def fwd_launches(rows: int, filter_size: int, dim: int, dtype) -> int:
    """Kernel launches of one forward call: the forward, and the sum of
    its partials where it splits the filter."""
    return 1 + (fwd_splits(rows, filter_size, dim, dtype) > 1)


def fused_ffn_fwd(x2, w1, b1, w2, b2, dropout_rate: float = 0.0,
                  dropout_key=None, save_hidden: bool = False):
    """(y [R, D], hd [R, F] or None) for x2 [R, D], w1 [F, D], w2 [D, F]
    of one dtype and float32 biases.  CUDA tensors run the forward
    kernel, and the sum of its filter splits where it has them (or
    raise); CPU tensors run the plain version."""
    drop = _drop(dropout_rate, dropout_key)
    if x2.device.type == "cpu":
        return _fwd_plain(x2, w1, b1, w2, b2, drop, save_hidden)
    _check_cuda_inputs(x2, w1, w2, b1, b2)
    if b1.dtype != torch.float32 or b2.dtype != torch.float32:
        raise TypeError("fused_ffn: biases must be float32")
    rows, dim = x2.shape
    filter_size = w1.shape[0]
    splits = fwd_splits(rows, filter_size, dim, x2.dtype)
    y = torch.empty_like(x2)
    hd = (torch.empty((rows, filter_size), dtype=x2.dtype, device=x2.device)
          if save_hidden else None)
    partials = (torch.empty(splits * rows * dim, dtype=torch.float32,
                            device=x2.device) if splits > 1 else None)
    threshold, scale, key = drop
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    _check("fwd", _kernel("fwd")(
        x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), 0 if hd is None else hd.data_ptr(),
        0 if partials is None else partials.data_ptr(), rows, filter_size,
        dim, splits, threshold, scale, *site_words(key),
        _DTYPE_CODES[x2.dtype], stream))
    fused_ffn_fwd.launches += 1
    if partials is not None:
        _check("fwd_sum", _kernel("fwd_sum")(
            partials.data_ptr(), b2.data_ptr(), y.data_ptr(), rows, dim,
            splits, stream))
        fused_ffn_fwd.launches += 1
    return y, hd


fused_ffn_fwd.launches = 0
fused_ffn_fwd.kernel_name = "fused_ffn_fwd"


def dw_splits(rows: int, filter_size: int, dim: int, dtype) -> int:
    """Row splits of the dW pass.  bf16: its output tiles of both
    products (128 filter rows by 256 dims: two a row at D 512) times the
    splits fill the card's resident blocks once (a whole wave;
    ``_plan.row_splits``).  float32: enough blocks (F / 64 per split) to
    cover the SMs twice, at most one split per row tile."""
    if dtype == torch.bfloat16:
        return row_splits(2 * (filter_size // _DW_TILE_F)
                          * (dim // _DW_TILE_D), rows)
    tiles = -(-rows // _DW_ROWS_F32)
    col_blocks = filter_size // _DW_COLS_F32
    return max(1, min(tiles, -(-2 * _SMS // col_blocks)))


def dx_rows(rows: int, dim: int) -> int:
    """Rows of a bf16 dx-pass tile (csrc/fused_ffn.cu: dx_rows): at D 256,
    128 where those tiles fill the card's SMs at least once, else 64; at
    D 512, 64."""
    return 128 if dim == 256 and -(-rows // 128) >= _SMS else 64


def bwd_scratch(rows: int, filter_size: int, dim: int, dtype):
    """(splits, bias partials P, dh elements, float32 partial elements)
    of the backward's scratch: dh [R, F] in bf16 (none for float32, whose
    dW pass recomputes it); dW1 and dW2 partials [S, F, D] each, then
    db1 [P, F] and db2 [P, D], P the bf16 dx pass's tiles (``dx_rows``)
    or the float32 dW pass's splits."""
    splits = dw_splits(rows, filter_size, dim, dtype)
    if dtype == torch.bfloat16:
        parts, dh = -(-rows // dx_rows(rows, dim)), rows * filter_size
    else:
        parts, dh = splits, 0
    return (splits, parts, dh,
            2 * splits * filter_size * dim + parts * (filter_size + dim))


def fused_ffn_bwd(x2, w1, w2, hd, dy, scale: float):
    """(dx [R, D], dW1 [F, D], dW2 [D, F] in the operand dtype, db1 [F],
    db2 [D] float32) from the saved hd and dy [R, D]; ``scale`` is the
    dropout scale (1 without dropout).  CUDA tensors run the dx pass, the
    dW pass and the sum of its splits (three launches) or raise; CPU
    tensors run the plain version."""
    if x2.device.type == "cpu":
        return _bwd_plain(x2, w1, w2, hd, dy, scale)
    _check_cuda_inputs(x2, w1, w2, hd, dy)
    rows, dim = x2.shape
    filter_size = w1.shape[0]
    if hd.shape != (rows, filter_size) or dy.shape != (rows, dim) \
            or hd.dtype != x2.dtype or dy.dtype != x2.dtype:
        raise ValueError("fused_ffn: hd must be [R, F] and dy [R, D], in "
                         "x's dtype")
    code = _DTYPE_CODES[x2.dtype]
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    splits, parts, dh_size, partial_size = bwd_scratch(
        rows, filter_size, dim, x2.dtype)
    dx = torch.empty_like(x2)
    dh = torch.empty(dh_size, dtype=x2.dtype, device=x2.device)
    partials = torch.empty(partial_size, dtype=torch.float32,
                           device=x2.device)
    dh_ptr = dh.data_ptr() if dh_size else 0
    _check("dx", _kernel("dx")(
        w1.data_ptr(), w2.data_ptr(), hd.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), dh_ptr, partials.data_ptr(), rows, filter_size, dim,
        splits, scale, code, stream))
    fused_ffn_bwd.launches += 1
    _check("dw", _kernel("dw")(
        x2.data_ptr(), w2.data_ptr(), hd.data_ptr(), dy.data_ptr(), dh_ptr,
        partials.data_ptr(), rows, filter_size, dim, splits, scale, code,
        stream))
    fused_ffn_bwd.launches += 1
    dw1 = torch.empty_like(w1)
    dw2 = torch.empty_like(w2)
    db1 = torch.empty(filter_size, dtype=torch.float32, device=x2.device)
    db2 = torch.empty(dim, dtype=torch.float32, device=x2.device)
    _check("dw_sum", _kernel("dw_sum")(
        partials.data_ptr(), dw1.data_ptr(), dw2.data_ptr(), db1.data_ptr(),
        db2.data_ptr(), filter_size, dim, splits, parts, code, stream))
    fused_ffn_bwd.launches += 1
    return dx, dw1, dw2, db1, db2


fused_ffn_bwd.launches = 0
fused_ffn_bwd.kernel_name = "fused_ffn_bwd"


class _FusedFFN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, dropout_rate, dropout_key):
        save = any(ctx.needs_input_grad[:5])
        y, hd = fused_ffn_fwd(x2, w1, b1, w2, b2, dropout_rate, dropout_key,
                              save_hidden=save)
        ctx.scale = _drop(dropout_rate, dropout_key)[1]
        if save:
            ctx.save_for_backward(x2, w1, w2, hd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, w1, w2, hd = ctx.saved_tensors
        dx, dw1, dw2, db1, db2 = fused_ffn_bwd(
            x2, w1, w2, hd, aligned16(dy.to(x2.dtype)), ctx.scale)
        return dx, dw1, db1, dw2, db2, None, None


def fused_ffn(x, w1, b1, w2, b2, dropout_rate: float = 0.0,
              dropout_key=None):
    """relu FFN with the hidden and its dropout inside the kernels:
    x [..., D]; w1 [F, D] and w2 [D, F] (cast to x's dtype, as the dense
    layers they replace); b1 [F], b2 [D] (used in float32).
    Differentiable in x, w1, b1, w2 and b2; ``dropout_rate`` > 0 needs
    the FFN site's ``dropout_key``."""
    d = x.shape[-1]
    y = _FusedFFN.apply(
        aligned16(x.reshape(-1, d)), aligned16(w1.to(x.dtype)),
        aligned16(b1.float()), aligned16(w2.to(x.dtype)),
        aligned16(b2.float()), float(dropout_rate or 0.0), dropout_key)
    return y.reshape(x.shape)

