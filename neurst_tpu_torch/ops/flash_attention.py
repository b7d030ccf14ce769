"""Flash attention, forward and backward: hand-written CUDA kernels and
their plain PyTorch versions.

Counterpart of ``neurst_tpu/ops/flash_attention.py``.  The TPU kernels
become ``csrc/flash_attention_fwd.cu`` (``_fwd_kernel``) and
``csrc/flash_attention_bwd.cu`` (``_dq_kernel`` and ``_dkv_kernel``),
built for sm_90a and called through ctypes (see ``ops/_build.py``).
Attention-probability dropout runs inside the kernels, as on the TPU:
the normalizer sums the un-dropped probabilities, P.V takes
``keep ? p / (1 - rate) : 0`` and the backward kernels regenerate the
mask from the dropout key (``utils/rng.py``) at the absolute index
``((b N + n) Tq + q) Tk + k`` (``ops/fused_dropout.py``), with the exact
32-bit threshold ``round(rate * 2^32)``.

``flash_attention`` is differentiable: a ``torch.autograd.Function``
keeps (q, k, v, lengths, o, lse) from the forward and recomputes the
probabilities in the backward.  Each kernel wrapper
(``flash_attention_fwd``, ``flash_attention_dq``, ``flash_attention_dkv``)
launches its kernel for CUDA tensors and raises on anything it does not
take (bfloat16 views must keep every row on 16 bytes, as the kernels'
cp.async and ldmatrix staging reads them); for CPU tensors it computes
the plain version, the same math in PyTorch, which the CPU tests hold
against the JAX functions.  There is no fallback from a CUDA tensor to
the plain version.
"""

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from neurst_tpu_torch.ops.fused_dropout import (dropout_keep_mask,
                                                threshold_and_scale)
from neurst_tpu_torch.utils.rng import site_words

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_dq",
           "flash_attention_dkv", "flash_attention_bwd",
           "flash_attention_reference", "flash_attention_bwd_reference",
           "NEG_INF", "HEAD_DIMS"]

NEG_INF = -1.0e30
# head dims the CUDA kernels are compiled for
HEAD_DIMS = (64,)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _drop_consts(dropout_rate, dropout_key):
    """(threshold, inv_keep, key) of the in-kernel dropout; threshold 0
    without dropout."""
    threshold, inv_keep = threshold_and_scale(dropout_rate or 0.0, False)
    if threshold and dropout_key is None:
        raise ValueError("flash attention dropout_rate > 0 needs a "
                         "dropout_key")
    return threshold, inv_keep, dropout_key


def _keep(q, k, drop):
    """The [B, N, Tq, Tk] keep mask of the site, or None."""
    threshold, _, key = drop
    if not threshold:
        return None
    b, t_q, n, _ = q.shape
    return dropout_keep_mask((b, n, t_q, k.shape[1]), key, threshold,
                             q.device)


def _scaled(p, keep, inv_keep):
    """keep ? p * inv_keep : 0 in float32."""
    pd = p * torch.tensor(inv_keep, dtype=torch.float32, device=p.device)
    return torch.where(keep, pd, torch.zeros_like(pd))


def _full_lengths(q, k, lengths):
    if lengths is None:
        return torch.full((q.shape[0],), k.shape[1], dtype=torch.int32,
                          device=q.device)
    return lengths


def _scores(q, k, lengths, causal):
    """(s [B, N, Tq, Tk] float32, scaled and NEG_INF where masked, and
    the mask: key < length, and key <= query when causal)."""
    t_q, t_k, h = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(h))
    col = torch.arange(t_k, device=q.device)
    mask = (col[None, :] < lengths.to(q.device)[:, None])[:, None, None, :]
    if causal:
        row = torch.arange(t_q, device=q.device)
        mask = mask & (col[None, :] <= row[:, None])[None, None]
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask


def flash_attention_reference(q, k, v, lengths=None, causal: bool = False,
                              dropout_rate: float = 0.0, dropout_key=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same masking, float32
    accumulation, P (after dropout) rounded to the value dtype before
    P.V, o = 0 and lse = NEG_INF for a row without valid keys.

    q [B, Tq, N, H], k/v [B, Tk, N, H], lengths [B] valid key counts.
    Returns (o [B, Tq, N, H] in q's dtype, lse [B, N, Tq] float32)."""
    lengths = _full_lengths(q, k, lengths)
    drop = _drop_consts(dropout_rate, dropout_key)
    s, mask = _scores(q, k, lengths, causal)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l_sum = p.sum(dim=-1)
    keep = _keep(q, k, drop)
    if keep is not None:
        p = _scaled(p, keep, drop[1])
    o = torch.einsum("bnqk,bknh->bqnh", p.to(v.dtype).float(), v.float())
    o = o / l_sum.clamp_min(1e-20).transpose(1, 2)[..., None]
    lse = torch.where(l_sum > 0.0, m + torch.log(l_sum.clamp_min(1e-37)),
                      torch.full_like(m, NEG_INF))
    return o.to(q.dtype), lse


def _delta(o, do):
    """rowsum(dO * o) in float32, [B, N, Tq] like lse."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _bwd_plain(q, k, v, do, lse, delta, lengths, causal,
               drop=(0, 1.0, None)):
    """(dq, dk, dv) by recomputing p = exp(s - lse) under the forward's
    mask (zeroed after the exp, so a row without keys gives p = 0),
    dp = dO v^T and ds = p (dp - delta) in float32; with dropout
    (``drop`` = (threshold, inv_keep, key)) pm = keep ? p inv_keep : 0,
    ds = pm dp - p delta and dv takes pm.  ds and p are rounded to the
    operand dtype before each product, where the TPU kernels round
    them."""
    lengths = _full_lengths(q, k, lengths)
    s, mask = _scores(q, k, lengths, causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.where(mask, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bqnh,bknh->bnqk", do.float(), v.float())
    keep = _keep(q, k, drop)
    if keep is None:
        ds = p * (dp - delta[..., None])
    else:
        pm = _scaled(p, keep, drop[1])
        ds = pm * dp - p * delta[..., None]
        p = pm
    dq = torch.einsum("bnqk,bknh->bqnh", ds.to(k.dtype).float(),
                      k.float()) * scale
    dk = torch.einsum("bnqk,bqnh->bknh", ds.to(q.dtype).float(),
                      q.float()) * scale
    dv = torch.einsum("bnqk,bqnh->bknh", p.to(do.dtype).float(), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, lengths, o, lse, do,
                                  causal: bool = False,
                                  dropout_rate: float = 0.0,
                                  dropout_key=None):
    """Plain PyTorch version of the backward kernels: (dq, dk, dv) of
    the attention whose forward gave (o, lse), for the output gradient
    dO [B, Tq, N, H]."""
    return _bwd_plain(q, k, v, do, lse, _delta(o, do), lengths, causal,
                      _drop_consts(dropout_rate, dropout_key))


def _aligned16(x):
    """Whether every [T, N] row of the view starts on 16 bytes."""
    vec = 16 // x.element_size()
    return x.data_ptr() % 16 == 0 and all(
        s % vec == 0 for s in x.stride()[:3])


def _check_cuda_inputs(q, k, v, lengths, do=None):
    named = [("q", q), ("k", k), ("v", v)]
    if do is not None:
        named.append(("dO", do))
    for name, x in named:
        if x.dtype not in _DTYPE_CODES or x.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} has dtype "
                            f"{x.dtype}; q, k, v (and dO) must share "
                            f"float32 or bfloat16")
        if x.dim() != 4 or x.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be "
                             f"[B, T, N, H] with a contiguous head dim")
    b, t_q, n, h = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (n, h) \
            or (do is not None and do.shape != q.shape):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)}")
    if h not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {h} not in "
                         f"{HEAD_DIMS}, the dims the kernels are built for")
    if b * n > 65535 or t_q == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention: empty sequence or more "
                         "than 65535 (batch * head) slices")
    if lengths.shape != (b,):
        raise ValueError("flash_attention: lengths must be [B]")
    if q.dtype == torch.bfloat16:
        for name, x in named:
            if not _aligned16(x):
                raise ValueError(
                    f"flash_attention: bfloat16 {name} must start on 16 "
                    f"bytes with B, T and N strides of whole 16-byte "
                    f"vectors (cp.async and ldmatrix read 16-byte rows); "
                    f"got offset {x.data_ptr() % 16}, strides "
                    f"{tuple(x.stride()[:3])}")
    for name, x in named + [("lengths", lengths)]:
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"flash_attention: {name} must lie on "
                             f"q's CUDA device, got {x.device}")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point, built and typed once."""
    from neurst_tpu_torch.ops._build import load
    fn = load("flash_attention_fwd").neurst_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
                      ctypes.c_float] + [ctypes.c_uint32] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, lengths, causal, drop):
    fn = _kernel()
    b, t_q, n, h = q.shape
    t_k = k.shape[1]
    lengths = lengths.to(torch.int32).contiguous()
    o = torch.empty((b, t_q, n, h), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, t_q), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             o.data_ptr(), lse.data_ptr(), b, n, t_q, t_k, h,
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             int(causal), _DTYPE_CODES[q.dtype], drop[0], drop[1],
             *site_words(drop[2]), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA "
                           f"error {err}")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, lengths=None, causal: bool = False,
                        dropout_rate: float = 0.0, dropout_key=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B, Tq, N, H], lse [B, N, Tq] float32).

    CUDA tensors run the kernel (or raise); CPU tensors run
    ``flash_attention_reference``.  Scaling by H^-1/2 is applied inside:
    callers must not pre-scale q."""
    lengths = _full_lengths(q, k, lengths)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, lengths, causal,
                                         dropout_rate, dropout_key)
    drop = _drop_consts(dropout_rate, dropout_key)
    _check_cuda_inputs(q, k, v, lengths)
    return _launch(q, k, v, lengths, causal, drop)


flash_attention_fwd.launches = 0
flash_attention_fwd.kernel_name = "flash_attention_fwd"


@functools.lru_cache(maxsize=None)
def _bwd_kernel(name):
    """The C entry point ``neurst_flash_attention_<name>`` (dq or dkv),
    built and typed once."""
    from neurst_tpu_torch.ops._build import load
    fn = getattr(load("flash_attention_bwd"), f"neurst_flash_attention_{name}")
    n_out = 1 if name == "dq" else 2
    fn.argtypes = ([ctypes.c_void_p] * (7 + n_out) + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_bwd(name, outs, q, k, v, do, lse, delta, lengths, causal,
                drop):
    b, t_q, n, h = q.shape
    strides = (ctypes.c_longlong * 12)(*(
        x.stride(i) for x in (q, k, v, do) for i in range(3)))
    dropout = (ctypes.c_uint32 * 5)(drop[0], *site_words(drop[2]))
    lengths = lengths.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_kernel(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), lengths.data_ptr(),
        *(x.data_ptr() for x in outs), b, n, t_q, k.shape[1], h, strides,
        int(causal), _DTYPE_CODES[q.dtype], dropout, drop[1], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_{name} launch failed: CUDA "
                           f"error {err}")


def _check_stats(q, lse, delta):
    b, t_q, n, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if x.dtype != torch.float32 or x.shape != (b, n, t_q) \
                or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"float32 [B, N, Tq] tensor on q's device")


def flash_attention_dq(q, k, v, do, lse, delta, lengths=None,
                       causal: bool = False, dropout_rate: float = 0.0,
                       dropout_key=None) -> torch.Tensor:
    """dq [B, Tq, N, H] from the forward's lse and delta = rowsum(dO o),
    both [B, N, Tq] float32.  CUDA tensors run the dq kernel (or raise);
    CPU tensors run the plain version."""
    lengths = _full_lengths(q, k, lengths)
    drop = _drop_consts(dropout_rate, dropout_key)
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, lengths, causal, drop)[0]
    _check_cuda_inputs(q, k, v, lengths, do)
    _check_stats(q, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("dq", (dq,), q, k, v, do, lse, delta, lengths, causal,
                drop)
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0
flash_attention_dq.kernel_name = "flash_attention_dq"


def flash_attention_dkv(q, k, v, do, lse, delta, lengths=None,
                        causal: bool = False, dropout_rate: float = 0.0,
                        dropout_key=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each [B, Tk, N, H], as ``flash_attention_dq`` takes
    them.  CUDA tensors run the dk/dv kernel (or raise); CPU tensors run
    the plain version."""
    lengths = _full_lengths(q, k, lengths)
    drop = _drop_consts(dropout_rate, dropout_key)
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, lengths, causal,
                          drop)[1:]
    _check_cuda_inputs(q, k, v, lengths, do)
    _check_stats(q, lse, delta)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("dkv", (dk, dv), q, k, v, do, lse, delta, lengths, causal,
                drop)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0
flash_attention_dkv.kernel_name = "flash_attention_dkv"


def flash_attention_bwd(q, k, v, lengths, o, lse, do, causal: bool = False,
                        dropout_rate: float = 0.0, dropout_key=None):
    """(dq, dk, dv) of the attention whose forward gave (o, lse).  On the
    card delta is computed here and the dq and dk/dv kernels run; on the
    CPU the plain version runs once for all three."""
    delta = _delta(o, do)
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, lengths, causal,
                          _drop_consts(dropout_rate, dropout_key))
    if do.stride(-1) != 1 or (do.dtype == torch.bfloat16
                              and not _aligned16(do)):
        # a fresh copy: contiguous and 16-byte aligned
        do = do.clone(memory_format=torch.contiguous_format)
    drop = (dropout_rate, dropout_key)
    dq = flash_attention_dq(q, k, v, do, lse, delta, lengths, causal, *drop)
    return (dq,) + flash_attention_dkv(q, k, v, do, lse, delta, lengths,
                                       causal, *drop)


class _FlashAttention(torch.autograd.Function):
    """Forward kernel, backward kernels; keeps (q, k, v, lengths, o,
    lse) and the dropout site in between."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal, dropout_rate, dropout_key):
        o, lse = flash_attention_fwd(q, k, v, lengths, causal, dropout_rate,
                                     dropout_key)
        ctx.args = (causal, dropout_rate, dropout_key)
        ctx.save_for_backward(q, k, v, lengths, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lengths, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, lengths, o, lse, do,
                                         *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, lengths: Optional[torch.Tensor] = None,
                    causal: bool = False, dropout_rate: float = 0.0,
                    dropout_key=None):
    """Memory-light, differentiable attention -> [B, Tq, N, H] in q's
    dtype.

    q [B, Tq, N, H], k/v [B, Tk, N, H], lengths [B] valid KEY counts
    (padded query rows produce values the caller drops).  A
    ``dropout_rate`` > 0 drops attention probabilities inside the
    kernels and needs the site's ``dropout_key``
    (``utils.rng.DropoutKey``); without one it raises."""
    _drop_consts(dropout_rate, dropout_key)
    return _FlashAttention.apply(q, k, v, _full_lengths(q, k, lengths),
                                 causal, float(dropout_rate or 0.0),
                                 dropout_key)
