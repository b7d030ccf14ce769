"""Label-smoothed cross entropy, fused: two hand-written CUDA kernel
pairs and their plain PyTorch versions, counterparts of
``neurst_tpu/ops/fused_ce.py``.

``fused_softmax_xent`` (over logits already in memory): the TPU kernels
``_fwd_kernel`` and ``_bwd_kernel`` become ``csrc/fused_softmax_xent.cu``,
a forward that streams each row once (one block a row, online max and
sum-exp in registers) and an elementwise backward over (rows, vocabulary
tiles); its plain version is the criterion's formula in float32.
Like the JAX function it has no caller on a model path: the
criterion's logits path computes the same formula in plain ops, and the
train step takes the projection-fused kernels below.

``fused_linear_xent`` (the projection fused in): the TPU kernels ``_linear_fwd_kernel`` and ``_linear_bwd_kernel`` become
``csrc/fused_linear_xent.cu``: a forward kernel and a backward in two
kernels (a dx pass over row tiles, a dW/db pass over vocabulary tiles),
built for sm_90a and called through ctypes (see ``ops/_build.py``).  The
[R, V] logits never reach device memory.

Both are differentiable (a ``torch.autograd.Function`` that keeps the
inputs and the row log-sum-exp; ``fused_linear_xent`` recomputes the
logits in the backward).  The kernel wrappers (``*_fwd``, ``*_bwd``)
launch the kernels for CUDA tensors and raise on anything they do not
take; for CPU tensors they compute the plain versions, which the CPU
tests hold against the JAX functions.
"""

import ctypes
import functools

import torch

__all__ = ["fused_linear_xent", "fused_linear_xent_fwd",
           "fused_linear_xent_bwd", "linear_xent_reference",
           "fused_linear_ce_available", "DIMS", "fused_softmax_xent",
           "fused_softmax_xent_fwd", "fused_softmax_xent_bwd",
           "fused_ce_available"]

# model dims the CUDA kernels are compiled for
DIMS = (128, 256, 512)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def linear_xent_reference(x, w, labels, confidence: float,
                          low_confidence: float, bias=None):
    """Plain projection + label-smoothed xent, differentiable through
    plain PyTorch ops (the formula the kernels implement; the semantics of
    ``WordEmbedding.attend`` followed by ``LabelSmoothedCrossEntropy``).

    x [..., D], w [V, D] (cast to x's dtype), labels [...], bias [V] or
    None -> float32 [...] per-token xent without the normalizing
    constant."""
    logits = torch.matmul(x.float(), w.to(x.dtype).float().t())
    if bias is not None:
        logits = logits + bias.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_z = logits.gather(-1, labels.long()[..., None])[..., 0]
    sum_z = logits.sum(dim=-1)
    return (-(confidence - low_confidence) * (label_z - lse)
            - low_confidence * (sum_z - w.shape[0] * lse))


def _logits(x2, w, bias):
    """z = x W^T in float32 from the operand dtype, plus the f32 bias."""
    return torch.matmul(x2.float(), w.float().t()) + bias


def _fwd_plain(x2, w, bias, labels, confidence, low_confidence):
    z = _logits(x2, w, bias)
    lse = torch.logsumexp(z, dim=-1)
    label_z = z.gather(1, labels.long()[:, None])[:, 0]
    xent = (-(confidence - low_confidence) * (label_z - lse)
            - low_confidence * (z.sum(dim=1) - w.shape[0] * lse))
    return xent, lse


def _bwd_plain(x2, w, bias, labels, lse, g, confidence, low_confidence):
    z = _logits(x2, w, bias)
    p = torch.exp(z - lse[:, None])
    onehot = torch.zeros_like(p).scatter_(1, labels.long()[:, None], 1.0)
    dz = g[:, None] * ((confidence - low_confidence) * (p - onehot)
                       + low_confidence * (w.shape[0] * p - 1.0))
    # both products take dz in the operand dtype; db the unrounded dz
    dzc = dz.to(x2.dtype).float()
    dx = torch.matmul(dzc, w.float()).to(x2.dtype)
    dw = torch.matmul(dzc.t(), x2.float()).to(w.dtype)
    return dx, dw, dz.sum(dim=0)


def _check_cuda_inputs(x2, w, bias, labels, *row_stats):
    if x2.dtype not in _DTYPE_CODES or w.dtype != x2.dtype:
        raise TypeError(f"fused_linear_xent: x has dtype {x2.dtype} and w "
                        f"{w.dtype}; they must share float32 or bfloat16")
    if x2.dim() != 2 or w.dim() != 2 or w.shape[1] != x2.shape[1]:
        raise ValueError(f"fused_linear_xent: x must be [R, D] and w "
                         f"[V, D], got {tuple(x2.shape)}, {tuple(w.shape)}")
    rows, dim = x2.shape
    vocab = w.shape[0]
    if dim not in DIMS:
        raise ValueError(f"fused_linear_xent: dim {dim} not in {DIMS}, the "
                         f"dims the kernels are built for")
    if rows == 0 or vocab == 0:
        raise ValueError("fused_linear_xent: no rows or no vocabulary")
    if bias.dtype != torch.float32 or bias.shape != (vocab,):
        raise ValueError("fused_linear_xent: bias must be float32 [V]")
    if labels.dtype != torch.int32 or labels.shape != (rows,):
        raise ValueError("fused_linear_xent: labels must be int32 [R]")
    for x in row_stats:
        if x.dtype != torch.float32 or x.shape != (rows,):
            raise ValueError("fused_linear_xent: lse and g must be "
                             "float32 [R]")
    named = [("x", x2), ("w", w), ("bias", bias), ("labels", labels)] + [
        ("lse/g", x) for x in row_stats]
    for name, x in named:
        if not x.is_contiguous():
            raise ValueError(f"fused_linear_xent: {name} must be "
                             f"contiguous")
    for name, x in named:
        if x.device.type != "cuda" or x.device != x2.device:
            raise ValueError(f"fused_linear_xent: {name} must lie on x's "
                             f"CUDA device, got {x.device}")


@functools.lru_cache(maxsize=None)
def _kernel(name):
    """The C entry point ``neurst_linear_xent_<name>`` (fwd, dx or dw),
    built and typed once."""
    from neurst_tpu_torch.ops._build import load
    fn = getattr(load("fused_linear_xent"), f"neurst_linear_xent_{name}")
    n_ptrs = {"fwd": 6, "dx": 7, "dw": 8}[name]
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(name, tensors, x2, w, confidence, low_confidence):
    rows, dim = x2.shape
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    err = _kernel(name)(*(t.data_ptr() for t in tensors), rows, w.shape[0],
                        dim, confidence, low_confidence,
                        _DTYPE_CODES[x2.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused_linear_xent {name} launch failed: CUDA "
                           f"error {err}")


def fused_linear_xent_fwd(x2, w, bias, labels, confidence: float,
                          low_confidence: float):
    """(xent [R], lse [R]), both float32, of z = x2 W^T + bias.

    x2 [R, D] and w [V, D] of one dtype, bias float32 [V], labels int32
    [R].  CUDA tensors run the forward kernel (or raise); CPU tensors run
    the plain version."""
    if x2.device.type == "cpu":
        return _fwd_plain(x2, w, bias, labels, confidence, low_confidence)
    _check_cuda_inputs(x2, w, bias, labels)
    xent = torch.empty(x2.shape[0], dtype=torch.float32, device=x2.device)
    lse = torch.empty_like(xent)
    _launch("fwd", (x2, w, bias, labels, xent, lse), x2, w, confidence,
            low_confidence)
    fused_linear_xent_fwd.launches += 1
    return xent, lse


fused_linear_xent_fwd.launches = 0
fused_linear_xent_fwd.kernel_name = "fused_linear_xent_fwd"


def fused_linear_xent_bwd(x2, w, bias, labels, lse, g, confidence: float,
                          low_confidence: float):
    """(dx [R, D] in x2's dtype, dW [V, D] in w's dtype, db [V] float32)
    for the per-row output gradient g [R] float32.  CUDA tensors run the
    dx pass and the dW/db pass (two launches) or raise; CPU tensors run
    the plain version."""
    if x2.device.type == "cpu":
        return _bwd_plain(x2, w, bias, labels, lse, g, confidence,
                          low_confidence)
    _check_cuda_inputs(x2, w, bias, labels, lse, g)
    dx = torch.empty_like(x2)
    dw = torch.empty_like(w)
    db = torch.empty_like(bias)
    _launch("dx", (x2, w, bias, labels, lse, g, dx), x2, w, confidence,
            low_confidence)
    fused_linear_xent_bwd.launches += 1
    _launch("dw", (x2, w, bias, labels, lse, g, dw, db), x2, w, confidence,
            low_confidence)
    fused_linear_xent_bwd.launches += 1
    return dx, dw, db


fused_linear_xent_bwd.launches = 0
fused_linear_xent_bwd.kernel_name = "fused_linear_xent_bwd"


class _FusedLinearXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2, w, bias, labels, confidence, low_confidence):
        xent, lse = fused_linear_xent_fwd(x2, w, bias, labels, confidence,
                                          low_confidence)
        ctx.smoothing = (confidence, low_confidence)
        ctx.save_for_backward(x2, w, bias, labels, lse)
        return xent

    @staticmethod
    def backward(ctx, g):
        x2, w, bias, labels, lse = ctx.saved_tensors
        dx, dw, db = fused_linear_xent_bwd(
            x2, w, bias, labels, lse, g.float().contiguous(), *ctx.smoothing)
        return dx, dw, db, None, None, None


def fused_linear_xent(x, w, labels, confidence: float,
                      low_confidence: float, bias=None):
    """Per-token label-smoothed cross entropy of ``x @ w.T (+ bias)``
    without materializing the logits, and without the normalizing
    constant (the criterion subtracts it).

    x [..., D], w [V, D] (cast to x's dtype, as ``WordEmbedding.attend``
    does), labels [...], bias [V] or None.  Returns float32 [...].
    Differentiable in x, w and bias; each gradient comes back in its
    input's dtype."""
    d = x.shape[-1]
    vocab = w.shape[0]
    lead = x.shape[:-1]
    bias2 = (torch.zeros(vocab, dtype=torch.float32, device=x.device)
             if bias is None else bias.float())
    xent = _FusedLinearXent.apply(
        x.reshape(-1, d).contiguous(), w.to(x.dtype).contiguous(), bias2,
        labels.reshape(-1).to(torch.int32), float(confidence),
        float(low_confidence))
    return xent.reshape(lead)


def fused_linear_ce_available(vocab_size: int, dim: int) -> bool:
    """Whether the kernels take this vocabulary and model dim."""
    return vocab_size > 0 and dim in DIMS


# ---------------------------------------------------------------------
# fused_softmax_xent: the cross entropy of logits already in memory


def _softmax_fwd_plain(z2, labels, confidence, low_confidence):
    """The criterion's logits-path formula
    (``neurst_tpu/criterions/label_smoothed_cross_entropy.py:87-97``) in
    float32: (xent [R], lse [R])."""
    z = z2.float()
    lse = torch.logsumexp(z, dim=-1)
    label_z = z.gather(1, labels.long()[:, None])[:, 0]
    xent = (-(confidence - low_confidence) * (label_z - lse)
            - low_confidence * (z.sum(dim=1) - z.shape[1] * lse))
    return xent, lse


def _softmax_bwd_plain(z2, labels, lse, g, confidence, low_confidence):
    p = torch.exp(z2.float() - lse[:, None])
    onehot = torch.zeros_like(p).scatter_(1, labels.long()[:, None], 1.0)
    dz = g[:, None] * ((confidence - low_confidence) * (p - onehot)
                       + low_confidence * (z2.shape[1] * p - 1.0))
    return dz.to(z2.dtype)


def _check_softmax_inputs(z2, labels, *row_stats):
    if z2.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_softmax_xent: logits dtype {z2.dtype}; the "
                        f"kernels take float32 or bfloat16")
    if z2.dim() != 2 or 0 in z2.shape:
        raise ValueError(f"fused_softmax_xent: logits must be a non-empty "
                         f"[R, V], got {tuple(z2.shape)}")
    rows = z2.shape[0]
    if labels.dtype != torch.int32 or labels.shape != (rows,):
        raise ValueError("fused_softmax_xent: labels must be int32 [R]")
    for x in row_stats:
        if x.dtype != torch.float32 or x.shape != (rows,):
            raise ValueError("fused_softmax_xent: lse and g must be float32 "
                             "[R]")
    named = [("logits", z2), ("labels", labels)] + [
        ("lse/g", x) for x in row_stats]
    for name, x in named:
        if not x.is_contiguous():
            raise ValueError(f"fused_softmax_xent: {name} must be "
                             f"contiguous")
    for name, x in named:
        if x.device.type != "cuda" or x.device != z2.device:
            raise ValueError(f"fused_softmax_xent: {name} must lie on the "
                             f"logits' CUDA device, got {x.device}")


@functools.lru_cache(maxsize=None)
def _softmax_kernel(name):
    """The C entry point ``neurst_softmax_xent_<name>`` (fwd or bwd),
    built and typed once."""
    from neurst_tpu_torch.ops._build import load
    fn = getattr(load("fused_softmax_xent"), f"neurst_softmax_xent_{name}")
    fn.argtypes = ([ctypes.c_void_p] * {"fwd": 4, "bwd": 5}[name]
                   + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _softmax_launch(name, tensors, z2, confidence, low_confidence):
    stream = torch.cuda.current_stream(z2.device).cuda_stream
    err = _softmax_kernel(name)(
        *(t.data_ptr() for t in tensors), z2.shape[0], z2.shape[1],
        confidence - low_confidence, low_confidence, _DTYPE_CODES[z2.dtype],
        stream)
    if err != 0:
        raise RuntimeError(f"fused_softmax_xent {name} launch failed: CUDA "
                           f"error {err}")


def fused_softmax_xent_fwd(z2, labels, confidence: float,
                           low_confidence: float):
    """(xent [R], lse [R]), both float32, of logits z2 [R, V] and int32
    labels [R].  CUDA tensors run the forward kernel (or raise); CPU
    tensors run the plain version."""
    if z2.device.type == "cpu":
        return _softmax_fwd_plain(z2, labels, confidence, low_confidence)
    _check_softmax_inputs(z2, labels)
    xent = torch.empty(z2.shape[0], dtype=torch.float32, device=z2.device)
    lse = torch.empty_like(xent)
    _softmax_launch("fwd", (z2, labels, xent, lse), z2, confidence,
                    low_confidence)
    fused_softmax_xent_fwd.launches += 1
    return xent, lse


fused_softmax_xent_fwd.launches = 0
fused_softmax_xent_fwd.kernel_name = "fused_softmax_xent_fwd"


def fused_softmax_xent_bwd(z2, labels, lse, g, confidence: float,
                           low_confidence: float):
    """dz [R, V] in z2's dtype for the per-row output gradient g [R]
    float32.  CUDA tensors run the backward kernel (or raise); CPU
    tensors run the plain version."""
    if z2.device.type == "cpu":
        return _softmax_bwd_plain(z2, labels, lse, g, confidence,
                                  low_confidence)
    _check_softmax_inputs(z2, labels, lse, g)
    dz = torch.empty_like(z2)
    _softmax_launch("bwd", (z2, labels, lse, g, dz), z2, confidence,
                    low_confidence)
    fused_softmax_xent_bwd.launches += 1
    return dz


fused_softmax_xent_bwd.launches = 0
fused_softmax_xent_bwd.kernel_name = "fused_softmax_xent_bwd"


class _FusedSoftmaxXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, z2, labels, confidence, low_confidence):
        xent, lse = fused_softmax_xent_fwd(z2, labels, confidence,
                                           low_confidence)
        ctx.smoothing = (confidence, low_confidence)
        ctx.save_for_backward(z2, labels, lse)
        return xent

    @staticmethod
    def backward(ctx, g):
        z2, labels, lse = ctx.saved_tensors
        dz = fused_softmax_xent_bwd(z2, labels, lse, g.float().contiguous(),
                                    *ctx.smoothing)
        return dz, None, None, None


def fused_softmax_xent(logits, labels, confidence: float,
                       low_confidence: float):
    """Per-token label-smoothed cross entropy of ``logits`` [..., V]
    (float32 or bfloat16 on the card, any float dtype on the CPU) and
    ``labels`` [...], without the normalizing constant (the criterion
    subtracts it).  Returns float32 [...]; differentiable in the logits,
    whose gradient comes back in their dtype."""
    vocab = logits.shape[-1]
    xent = _FusedSoftmaxXent.apply(
        logits.reshape(-1, vocab).contiguous(),
        labels.reshape(-1).to(torch.int32).contiguous(), float(confidence),
        float(low_confidence))
    return xent.reshape(logits.shape[:-1])


def fused_ce_available(vocab_size: int) -> bool:
    """Whether ``fused_softmax_xent`` launches its kernels here: the
    JAX gate asks for a TPU backend and a lane-aligned vocabulary of at
    least one 4096-column block; the CUDA kernels take any vocabulary,
    so this asks for a CUDA device."""
    return vocab_size > 0 and torch.cuda.is_available()
