"""Flash attention forward: a hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``neurst_tpu/ops/flash_attention.py``.  The TPU kernel
(``_fwd_kernel`` behind ``_fwd_impl``) becomes
``csrc/flash_attention_fwd.cu``, built for sm_90a and called through
ctypes (see ``ops/_build.py``).  Only the forward is ported, with
attention-probability dropout 0, which is what inference runs; the
backward kernels and in-kernel dropout come with the training slice.

``flash_attention_fwd`` launches the kernel for CUDA tensors and raises
on anything it does not take; for CPU tensors it computes
``flash_attention_reference``, the same math in plain PyTorch, which the
CPU tests hold against the JAX function.  There is no fallback from a
CUDA tensor to the plain version.
"""

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_reference", "NEG_INF", "HEAD_DIMS"]

NEG_INF = -1.0e30
# head dims the CUDA kernel is compiled for
HEAD_DIMS = (64,)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _full_lengths(q, k, lengths):
    if lengths is None:
        return torch.full((q.shape[0],), k.shape[1], dtype=torch.int32,
                          device=q.device)
    return lengths


def flash_attention_reference(q, k, v, lengths=None, causal: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same masking, float32
    accumulation, P rounded to the value dtype before P.V, o = 0 and
    lse = NEG_INF for a row without valid keys.

    q [B, Tq, N, H], k/v [B, Tk, N, H], lengths [B] valid key counts.
    Returns (o [B, Tq, N, H] in q's dtype, lse [B, N, Tq] float32)."""
    lengths = _full_lengths(q, k, lengths)
    t_q, t_k, h = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(h))
    col = torch.arange(t_k, device=q.device)
    mask = (col[None, :] < lengths.to(q.device)[:, None])[:, None, None, :]
    if causal:
        row = torch.arange(t_q, device=q.device)
        mask = mask & (col[None, :] <= row[:, None])[None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l_sum = p.sum(dim=-1)
    o = torch.einsum("bnqk,bknh->bqnh", p.to(v.dtype).float(), v.float())
    o = o / l_sum.clamp_min(1e-20).transpose(1, 2)[..., None]
    lse = torch.where(l_sum > 0.0, m + torch.log(l_sum.clamp_min(1e-37)),
                      torch.full_like(m, NEG_INF))
    return o.to(q.dtype), lse


def _check_cuda_inputs(q, k, v, lengths):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in _DTYPE_CODES or x.dtype != q.dtype:
            raise TypeError(f"flash_attention_fwd: {name} has dtype "
                            f"{x.dtype}; q, k and v must share float32 "
                            f"or bfloat16")
        if x.dim() != 4 or x.stride(-1) != 1:
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             f"[B, T, N, H] with a contiguous head dim")
    b, t_q, n, h = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (n, h):
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)}")
    if h not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {h} not in "
                         f"{HEAD_DIMS}, the dims the kernel is built for")
    if b * n > 65535 or t_q == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention_fwd: empty sequence or more "
                         "than 65535 (batch * head) slices")
    if lengths.shape != (b,):
        raise ValueError("flash_attention_fwd: lengths must be [B]")
    for name, x in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} must lie on "
                             f"q's CUDA device, got {x.device}")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The kernel's C entry point, built and typed once."""
    from neurst_tpu_torch.ops._build import load
    fn = load("flash_attention_fwd").neurst_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, lengths, causal):
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
             int(causal), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA "
                           f"error {err}")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, lengths=None, causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B, Tq, N, H], lse [B, N, Tq] float32).

    CUDA tensors run the kernel (or raise); CPU tensors run
    ``flash_attention_reference``.  Scaling by H^-1/2 is applied inside:
    callers must not pre-scale q."""
    lengths = _full_lengths(q, k, lengths)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, lengths, causal)
    _check_cuda_inputs(q, k, v, lengths)
    return _launch(q, k, v, lengths, causal)


flash_attention_fwd.launches = 0
flash_attention_fwd.kernel_name = "flash_attention_fwd"


def flash_attention(q, k, v, lengths: Optional[torch.Tensor] = None,
                    causal: bool = False, dropout_rate: float = 0.0):
    """Memory-light attention -> [B, Tq, N, H] in q's dtype.

    q [B, Tq, N, H], k/v [B, Tk, N, H], lengths [B] valid KEY counts
    (padded query rows produce values the caller drops)."""
    if dropout_rate:
        raise NotImplementedError(
            "flash attention dropout is part of the training slice; "
            "the port runs the forward with dropout 0")
    return flash_attention_fwd(q, k, v, lengths, causal)[0]
