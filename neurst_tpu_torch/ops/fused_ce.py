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

``fused_linear_xent`` (the projection fused in): the TPU kernels
``_linear_fwd_kernel`` and ``_linear_bwd_kernel`` become
``csrc/fused_linear_xent.cu``, built for sm_90a and called through
ctypes (see ``ops/_build.py``).  bf16 runs on the tensor cores, over
(row tile, vocabulary split) blocks: the forward in one launch, or two
where the vocabulary splits (a pass that folds z into each row's
running max, sum-exp, label logit and sum, then a combine of the
splits' float32 partials in split order; ``fwd_plan`` plans it), the
backward in three (a dx pass that also writes round(dz) [R, Vp] and the
db partials, a dW pass over row splits, a sum of the float32 partials
in a fixed order; ``bwd_scratch`` sizes the buffers).  float32 runs FMA
loops: a forward over row tiles, then a dx pass over row tiles and a
dW/db pass over vocabulary tiles.  The [R, V] logits never reach device
memory.

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

from neurst_tpu_torch.ops._plan import aligned16, chunk_splits, row_splits

__all__ = ["fused_linear_xent", "fused_linear_xent_fwd",
           "fused_linear_xent_bwd", "fwd_plan", "fwd_launches",
           "linear_xent_reference",
           "fused_linear_ce_available", "DIMS", "fused_softmax_xent",
           "fused_softmax_xent_fwd", "fused_softmax_xent_bwd",
           "fused_ce_available"]

# model dims the CUDA kernels are compiled for
DIMS = (128, 256, 512)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# bf16 (csrc/fused_linear_xent.cu): the vocabulary chunk of the forward
# and the dx pass (kXentChunk), and the dW pass's vocabulary tile
# (kRpTileM), to which the dz buffer's columns Vp round up
_CHUNK = 64
_VOCAB_TILE = 128
_FWD_ROWS = 128  # rows of a bf16 forward tile (kFwdRows)


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
    """The float32 C entry point ``neurst_linear_xent_<name>`` (fwd, dx
    or dw), built and typed once."""
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


def fwd_plan(rows: int, vocab: int, dim: int):
    """The bf16 forward's plan, as the CUDA side takes it: (vocabulary
    splits S of each row tile's ceil(V / 64) chunks, row tiles T, tile
    rows, float32 partial elements: (m, l, z_label, sum z) [S, R] where
    S > 1, else none).  Tiles are 128 rows at every D (kFwdRows; at D 512
    each W chunk comes through the ring in two halves, so that x
    [128, 512] and the ring fit an SM's shared memory)."""
    tiles = -(-rows // _FWD_ROWS)
    splits = chunk_splits(tiles, -(-vocab // _CHUNK))
    return splits, tiles, _FWD_ROWS, 4 * splits * rows if splits > 1 else 0


def fwd_launches(rows: int, vocab: int, dim: int, dtype) -> int:
    """Kernel launches of one forward call: bf16 the split pass, and the
    combine where the vocabulary splits; float32 one."""
    if dtype != torch.bfloat16:
        return 1
    return 1 + (fwd_plan(rows, vocab, dim)[0] > 1)


def _check_aligned16(x2, w):
    for name, t in (("x", x2), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"fused_linear_xent: bf16 {name} must be "
                             f"16-byte aligned")


def _fwd_bf16(x2, w, bias, labels, xent, lse, confidence, low_confidence):
    """The bf16 forward's one or two launches."""
    _check_aligned16(x2, w)
    rows, dim = x2.shape
    vocab = w.shape[0]
    splits, _, _, partial_size = fwd_plan(rows, vocab, dim)
    partials = (torch.empty(partial_size, dtype=torch.float32,
                            device=x2.device) if splits > 1 else None)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    smoothing = (confidence, low_confidence)
    launches = [("fwd", (x2, w, bias, labels, xent, lse, partials, rows,
                         vocab, dim, splits) + smoothing)]
    if splits > 1:
        launches.append(("combine", (partials, xent, lse, rows, vocab,
                                     splits) + smoothing))
    for name, args in launches:
        _launch_bf16(name, args, stream)
        fused_linear_xent_fwd.launches += 1


def fused_linear_xent_fwd(x2, w, bias, labels, confidence: float,
                          low_confidence: float):
    """(xent [R], lse [R]), both float32, of z = x2 W^T + bias.

    x2 [R, D] and w [V, D] of one dtype, bias float32 [V], labels int32
    [R].  CUDA tensors run the forward kernel (bf16: the split pass, and
    the combine of its partials where ``fwd_plan`` splits the
    vocabulary) or raise; CPU tensors run the plain version."""
    if x2.device.type == "cpu":
        return _fwd_plain(x2, w, bias, labels, confidence, low_confidence)
    _check_cuda_inputs(x2, w, bias, labels)
    xent = torch.empty(x2.shape[0], dtype=torch.float32, device=x2.device)
    lse = torch.empty_like(xent)
    if x2.dtype == torch.bfloat16:
        _fwd_bf16(x2, w, bias, labels, xent, lse, confidence, low_confidence)
        return xent, lse
    _launch("fwd", (x2, w, bias, labels, xent, lse), x2, w, confidence,
            low_confidence)
    fused_linear_xent_fwd.launches += 1
    return xent, lse


fused_linear_xent_fwd.launches = 0
fused_linear_xent_fwd.kernel_name = "fused_linear_xent_fwd"


def dx_rows(dim: int) -> int:
    """Rows of a bf16 dx-pass tile (XentTile::kRows): 128, or 64 at D 512,
    where 128 rows of dx would take 256 accumulators a thread."""
    return 64 if dim == 512 else 128


def bwd_scratch(rows: int, vocab: int, dim: int):
    """The bf16 backward's plan and scratch, as the CUDA side sizes it:
    (vocabulary splits Sx of the dx pass, row splits Sw of the dW pass,
    dx row tiles T, Vp, dz elements (bf16 [R, Vp]), float32 partial
    elements (dx [Sx, R, D], dW [Sw, Vp, D], db [T, Vp])).  Vp is V
    rounded up to the dW pass's 128-row tiles."""
    vpad = -(-vocab // _VOCAB_TILE) * _VOCAB_TILE
    tiles = -(-rows // dx_rows(dim))
    dx_splits = chunk_splits(tiles, vpad // _CHUNK)
    dw_splits = row_splits((vpad // _VOCAB_TILE) * (dim // min(dim, 256)),
                           rows)
    partials = (dx_splits * rows * dim + dw_splits * vpad * dim
                + tiles * vpad)
    return dx_splits, dw_splits, tiles, vpad, rows * vpad, partials


def bwd_launches(dtype) -> int:
    """Kernel launches of one backward call: bf16 three (dx pass, dW
    pass, sum), float32 two (dx pass, dW/db pass)."""
    return 3 if dtype == torch.bfloat16 else 2


@functools.lru_cache(maxsize=None)
def _bf16_kernel(name):
    """The bf16 C entry point ``neurst_linear_xent_<name>_bf16``: the
    forward's fwd and combine, the backward's dx, dw and sum; built and
    typed once."""
    from neurst_tpu_torch.ops._build import load
    fn = getattr(load("fused_linear_xent"), f"neurst_linear_xent_{name}_bf16")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = {
        "fwd": [ptr] * 7 + [i32] * 4 + [f32] * 2 + [ptr],
        "combine": [ptr] * 3 + [i32] * 3 + [f32] * 2 + [ptr],
        "dx": [ptr] * 8 + [i32] * 5 + [f32] * 2 + [ptr],
        "dw": [ptr] * 3 + [i32] * 5 + [ptr],
        "sum": [ptr] * 4 + [i32] * 5 + [ptr],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _launch_bf16(name, args, stream):
    """One launch of a bf16 entry point: tensors pass their pointers,
    other arguments (ints, floats, None for NULL) as they are; a launch
    that fails raises."""
    err = _bf16_kernel(name)(
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
        stream)
    if err != 0:
        raise RuntimeError(f"fused_linear_xent bf16 {name} launch failed: "
                           f"CUDA error {err}")


def _bwd_bf16(x2, w, bias, labels, lse, g, confidence, low_confidence):
    """The bf16 backward's three launches."""
    _check_aligned16(x2, w)
    rows, dim = x2.shape
    vocab = w.shape[0]
    dx_splits, dw_splits, _, _, dz_size, partial_size = bwd_scratch(
        rows, vocab, dim)
    dz = torch.empty(dz_size, dtype=x2.dtype, device=x2.device)
    partials = torch.empty(partial_size, dtype=torch.float32,
                           device=x2.device)
    dx = torch.empty_like(x2)
    dw = torch.empty_like(w)
    db = torch.empty_like(bias)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    plan = (rows, vocab, dim, dx_splits, dw_splits)
    for name, args in (
            ("dx", (x2, w, bias, labels, lse, g, dz, partials) + plan
             + (confidence, low_confidence)),
            ("dw", (x2, dz, partials) + plan),
            ("sum", (partials, dx, dw, db) + plan)):
        _launch_bf16(name, args, stream)
        fused_linear_xent_bwd.launches += 1
    return dx, dw, db


def fused_linear_xent_bwd(x2, w, bias, labels, lse, g, confidence: float,
                          low_confidence: float):
    """(dx [R, D] in x2's dtype, dW [V, D] in w's dtype, db [V] float32)
    for the per-row output gradient g [R] float32.  CUDA tensors run the
    kernels (bf16: the dx pass, the dW pass and the sum of their
    partials; float32: the dx pass and the dW/db pass) or raise; CPU
    tensors run the plain version."""
    if x2.device.type == "cpu":
        return _bwd_plain(x2, w, bias, labels, lse, g, confidence,
                          low_confidence)
    _check_cuda_inputs(x2, w, bias, labels, lse, g)
    if x2.dtype == torch.bfloat16:
        return _bwd_bf16(x2, w, bias, labels, lse, g, confidence,
                         low_confidence)
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
        aligned16(x.reshape(-1, d)), aligned16(w.to(x.dtype)), bias2,
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
