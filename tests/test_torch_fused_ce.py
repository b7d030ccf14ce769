"""The port's fused label-smoothed cross entropies against the JAX
package's: the projection-fused ``fused_linear_xent`` (rows 4-5) and
``fused_softmax_xent`` over logits in memory (rows 6-7).

On the CPU the kernel wrappers (``fused_linear_xent_fwd`` and
``fused_linear_xent_bwd``) compute their plain PyTorch versions; through
``fused_linear_xent`` (the autograd function) they are held against the
JAX ``fused_linear_xent`` with the Pallas kernels (``_linear_fwd_kernel``
and ``_linear_bwd_kernel``) in interpret mode, on the same numpy-seeded
inputs: the per-token xent and dx / dW / db for the same output
gradient.  ``fused_softmax_xent`` is held against the JAX function with
``_fwd_kernel`` / ``_bwd_kernel`` in interpret mode the same way, at the
shapes of ``tests/layers/test_fused_ce.py``.  The CUDA kernels are held
against the same plain versions on the card by ``chip_smoke.py``; here
only the wrappers' input checks and their routing by device run.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from neurst_tpu.ops.fused_ce import \
    fused_linear_xent as jax_fused_linear_xent  # noqa: E402
from neurst_tpu.ops.fused_ce import \
    fused_softmax_xent as jax_fused_softmax_xent  # noqa: E402
from neurst_tpu.ops.fused_ce import \
    linear_xent_reference as jax_linear_xent_reference  # noqa: E402
from neurst_tpu_torch.ops import fused_ce as port  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

# (lead shape, dim, vocab, bias, dtype): the shapes of the JAX package's
# own test (ragged vocabulary 650 included) and a bf16 case
CASES = [((2, 5), 128, 512, False, "float32"),
         ((3, 4), 128, 640, True, "float32"),
         ((2, 3), 256, 650, True, "float32"),
         ((3, 7), 128, 650, True, "bfloat16")]
# max abs error of xent, and of each gradient relative to its largest
# |value|.  float32: sums in other orders.  bf16: both sides take bf16
# products with float32 sums, the JAX one rounds dx/dW to bf16 as the
# port does (2^-8 relative), and dz rounds where a value one rounding
# step away flips one bf16 ulp of a summand
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-4, 1e-2)}


def _inputs(seed, lead, dim, vocab, bias_on, dtype):
    rng = np.random.RandomState(seed)
    x = rng.randn(*lead, dim).astype(np.float32)
    w = (rng.randn(vocab, dim) * 0.1).astype(np.float32)
    if dtype == "bfloat16":
        x, w = (torch.from_numpy(a).bfloat16().float().numpy()
                for a in (x, w))
    labels = rng.randint(0, vocab, size=lead).astype(np.int32)
    bias = rng.randn(vocab).astype(np.float32) if bias_on else None
    g = rng.rand(*lead).astype(np.float32)
    return x, w, labels, bias, g


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[2]}-{c[4]}")
def test_values_and_grads_match_pallas_interpret(case):
    lead, dim, vocab, bias_on, dtype = case
    x, w, labels, bias, g = _inputs(vocab + dim, lead, dim, vocab, bias_on,
                                    dtype)
    c, low = 0.9, 0.1 / (vocab - 1)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jargs = [jnp.asarray(x, jdt), jnp.asarray(w, jdt)] + (
        [jnp.asarray(bias)] if bias_on else [])

    def jax_loss(*a):
        xent = jax_fused_linear_xent(a[0], a[1], jnp.asarray(labels), c, low,
                                     bias=a[2] if bias_on else None,
                                     interpret=True)
        return jnp.sum(xent * g), xent

    (_, ref), ref_grads = jax.value_and_grad(
        jax_loss, argnums=tuple(range(len(jargs))), has_aux=True)(*jargs)

    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(),
              torch.from_numpy(w).to(tdt).requires_grad_()] + (
        [torch.from_numpy(bias).requires_grad_()] if bias_on else [])
    xent = port.fused_linear_xent(leaves[0], leaves[1],
                                  torch.from_numpy(labels), c, low,
                                  bias=leaves[2] if bias_on else None)
    grads = torch.autograd.grad((xent * torch.from_numpy(g)).sum(), leaves)
    xent_tol, grad_tol = TOL[dtype]
    assert xent.dtype == torch.float32 and xent.shape == lead
    assert np.abs(xent.detach().numpy() - np.asarray(ref)).max() <= xent_tol
    for got, want, leaf in zip(grads, ref_grads, leaves):
        assert got.dtype == leaf.dtype
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= grad_tol * np.abs(want).max()


def test_reference_matches_the_jax_reference():
    """``linear_xent_reference`` (the formula, through plain autograd)
    against the JAX ``linear_xent_reference``."""
    x, w, labels, bias, _ = _inputs(3, (2, 6), 128, 300, True, "float32")
    c, low = 0.8, 0.2 / 299
    ours = port.linear_xent_reference(torch.from_numpy(x),
                                      torch.from_numpy(w),
                                      torch.from_numpy(labels), c, low,
                                      bias=torch.from_numpy(bias))
    ref = jax_linear_xent_reference(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(labels), c, low,
                                    bias=jnp.asarray(bias))
    assert np.abs(ours.numpy() - np.asarray(ref)).max() <= 2e-5


def test_cpu_tensors_take_the_plain_versions_without_launching():
    x, w, labels, _, g = _inputs(5, (9,), 128, 200, False, "float32")
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.zeros(200),
            torch.from_numpy(labels))
    before = (port.fused_linear_xent_fwd.launches,
              port.fused_linear_xent_bwd.launches)
    xent, lse = port.fused_linear_xent_fwd(*args, 0.9, 0.1 / 199)
    assert torch.allclose(lse, torch.logsumexp(args[0] @ args[1].t(), -1))
    dx, dw, db = port.fused_linear_xent_bwd(*args, lse, torch.from_numpy(g),
                                            0.9, 0.1 / 199)
    assert dx.shape == (9, 128) and dw.shape == (200, 128)
    assert db.shape == (200,) and db.dtype == torch.float32
    assert (port.fused_linear_xent_fwd.launches,
            port.fused_linear_xent_bwd.launches) == before


@pytest.mark.parametrize("what, match", [
    ("dim", "dim 64"), ("device", "CUDA device"), ("dtype", "dtype"),
    ("labels", "labels"), ("bias", "bias"), ("contiguous", "contiguous")])
def test_kernel_input_checks_refuse(what, match):
    """What the CUDA kernels do not take is refused before any launch."""
    x = torch.zeros(6, 128)
    w = torch.zeros(50, 128)
    bias = torch.zeros(50)
    labels = torch.zeros(6, dtype=torch.int32)
    if what == "dim":
        x, w = torch.zeros(6, 64), torch.zeros(50, 64)
    elif what == "dtype":
        w = w.bfloat16()
    elif what == "labels":
        labels = labels.long()
    elif what == "bias":
        bias = bias[:40]
    elif what == "contiguous":
        w = torch.zeros(128, 50).t()
    with pytest.raises((ValueError, TypeError), match=match):
        port._check_cuda_inputs(x, w, bias, labels)


def test_fused_linear_ce_available():
    assert port.fused_linear_ce_available(8192, 256)
    assert not port.fused_linear_ce_available(8192, 384)


# (lead shape, vocab, dtype, labels from): the JAX tests' shapes; the
# last has V = 4096 + 1024 with every label in the ragged last block
SOFTMAX_CASES = [((4, 6), 512, "float32", 0), ((3, 5), 640, "float32", 0),
                 ((67,), 512, "bfloat16", 0), ((9,), 5120, "float32", 4096)]


def _softmax_inputs(seed, lead, vocab, dtype, labels_from):
    rng = np.random.RandomState(seed)
    logits = (2.0 * rng.randn(*lead, vocab)).astype(np.float32)
    if dtype == "bfloat16":
        logits = torch.from_numpy(logits).bfloat16().float().numpy()
    labels = rng.randint(labels_from, vocab, size=lead).astype(np.int32)
    return logits, labels, rng.rand(*lead).astype(np.float32)


def _jax_formula(logits, labels, c, low):
    """The criterion's jnp formula (label_smoothed_cross_entropy.py:87-97)."""
    z = logits.astype(jnp.float32)
    lse = jax.scipy.special.logsumexp(z, axis=-1)
    label_z = jnp.take_along_axis(z, labels[..., None], axis=-1)[..., 0]
    return (-(c - low) * (label_z - lse)
            - low * (jnp.sum(z, axis=-1) - z.shape[-1] * lse))


@pytest.mark.parametrize("case", SOFTMAX_CASES,
                         ids=lambda c: f"{c[1]}-{c[2]}-{len(c[0])}d")
def test_softmax_xent_values_and_grads_match_pallas_interpret(case):
    lead, vocab, dtype, labels_from = case
    logits, labels, g = _softmax_inputs(vocab, lead, vocab, dtype,
                                        labels_from)
    c, low = 0.9, 0.1 / (vocab - 1)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def jax_loss(z):
        xent = jax_fused_softmax_xent(z, jnp.asarray(labels), c, low,
                                      interpret=True)
        return jnp.sum(xent * g), xent

    (_, ref), ref_grad = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(logits, jdt))
    leaf = torch.from_numpy(logits).to(getattr(torch, dtype))
    leaf.requires_grad_()
    before = (port.fused_softmax_xent_fwd.launches,
              port.fused_softmax_xent_bwd.launches)
    xent = port.fused_softmax_xent(leaf, torch.from_numpy(labels), c, low)
    (grad,) = torch.autograd.grad((xent * torch.from_numpy(g)).sum(), leaf)
    assert (port.fused_softmax_xent_fwd.launches,
            port.fused_softmax_xent_bwd.launches) == before
    assert xent.dtype == torch.float32 and xent.shape == lead
    np.testing.assert_allclose(xent.detach().numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
    assert grad.dtype == leaf.dtype
    np.testing.assert_allclose(grad.float().numpy(),
                               np.asarray(ref_grad, np.float32),
                               rtol=1e-4, atol=1e-5)


def test_softmax_xent_reference_is_the_criterion_formula():
    logits, labels, _ = _softmax_inputs(1, (5, 7), 300, "float32", 0)
    c, low = 0.8, 0.2 / 299
    ours = port.fused_softmax_xent(torch.from_numpy(logits),
                                   torch.from_numpy(labels), c, low)
    ref = _jax_formula(jnp.asarray(logits), jnp.asarray(labels), c, low)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.3])
def test_library_cross_entropy_computes_the_same_function(smoothing):
    """``F.cross_entropy(z, y, label_smoothing=V low)`` puts ``low`` on
    every non-label class and ``c`` on the label: NeurST's xent without
    its constant (the library yardstick chip_smoke times)."""
    from torch.nn import functional as F
    vocab = 512
    logits, labels, _ = _softmax_inputs(2, (40,), vocab, "float32", 0)
    z, y = torch.from_numpy(logits), torch.from_numpy(labels)
    c, low = 1.0 - smoothing, smoothing / (vocab - 1)
    library = F.cross_entropy(z, y.long(), label_smoothing=vocab * low,
                              reduction="none")
    ours = port.fused_softmax_xent(z, y, c, low)
    np.testing.assert_allclose(library.numpy(), ours.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("what, match", [
    ("device", "CUDA device"), ("dtype", "dtype"), ("labels", "labels"),
    ("lse", "lse"), ("contiguous", "contiguous"), ("empty", "non-empty")])
def test_softmax_kernel_input_checks_refuse(what, match):
    z = torch.zeros(6, 50)
    labels = torch.zeros(6, dtype=torch.int32)
    stats = []
    if what == "dtype":
        z = z.half()
    elif what == "labels":
        labels = labels.long()
    elif what == "lse":
        stats = [torch.zeros(5)]
    elif what == "contiguous":
        z = torch.zeros(50, 6).t()
    elif what == "empty":
        z = torch.zeros(0, 50)
    with pytest.raises((ValueError, TypeError), match=match):
        port._check_softmax_inputs(z, labels, *stats)


def test_softmax_xent_off_the_cpu_launches_or_raises():
    """Tensors that are not on the CPU never take the plain version: here,
    without a card, a device tensor is refused before any launch."""
    z = torch.zeros(4, 64, device="meta")
    labels = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        port.fused_softmax_xent(z, labels, 0.9, 0.1 / 63)
    with pytest.raises(ValueError, match="CUDA device"):
        port.fused_softmax_xent_bwd(z, labels, torch.zeros(4, device="meta"),
                                    torch.zeros(4, device="meta"), 0.9, 0.1)
    assert port.fused_ce_available(8192) == torch.cuda.is_available()


# (rows, vocab, dim): the training slice's decoder rows, a ragged 37 and
# transformer_base's 32768 rows, at each dim the kernels are built for
PLAN_CASES = [(rows, vocab, dim) for rows, vocab in
              ((6000, 8192), (37, 650), (32768, 32768))
              for dim in (128, 256, 512)]


@pytest.mark.parametrize("rows, vocab, dim", PLAN_CASES)
def test_bwd_plan_fills_the_card(rows, vocab, dim):
    """The bf16 backward's dx pass takes 128-row tiles (64 at D 512, 128
    accumulators a thread either way) and splits each tile's vocabulary
    where the tiles alone would leave SMs idle; its dW pass splits rows
    until its output tiles (128 words by min(D, 256) dims) fill the
    card's 132 SMs once; Vp rounds V up to those tiles."""
    dx_splits, dw_splits, tiles, vpad, _, _ = port.bwd_scratch(rows, vocab,
                                                               dim)
    assert port.dx_rows(dim) == (64 if dim == 512 else 128)
    assert tiles == -(-rows // port.dx_rows(dim))
    assert vpad % 128 == 0 and vpad - 128 < vocab <= vpad
    chunks = vpad // 64

    def path(s):  # waves of blocks times chunks a block
        return -(-tiles * s // 132) * -(-chunks // s)
    # splits of at least 8 chunks; the fewest within 1/8 of the shortest
    # path
    shortest = min(path(s) for s in range(1, max(1, chunks // 8) + 1))
    assert chunks // dx_splits >= 8 or dx_splits == 1
    assert 8 * path(dx_splits) <= 9 * shortest
    assert all(8 * path(s) > 9 * shortest for s in range(1, dx_splits))
    out_tiles = (vpad // 128) * (dim // min(dim, 256))
    assert dw_splits == 1 or out_tiles * dw_splits <= 132 \
        < out_tiles * (dw_splits + 1)


@pytest.mark.parametrize("rows, vocab, dim, want", [
    # R 6000, V 8192: 47 tiles x 5 vocabulary splits (two waves of 26
    # chunks), 64 dW tiles x 2 row splits
    (6000, 8192, 256, (5, 2, 47, 8192)),
    # a ragged vocabulary pads to the dW pass's tiles
    (37, 650, 256, (1, 1, 1, 768)),
    (4096, 32768, 512, (2, 1, 64, 32768)),
])
def test_bwd_scratch_sizes(rows, vocab, dim, want):
    """The bf16 backward's scratch, as the CUDA side lays it out: dz
    [R, Vp] bf16, then float32 dx partials [Sx, R, D], dW partials
    [Sw, Vp, D] and db partials [T, Vp]."""
    dx_splits, dw_splits, tiles, vpad = want
    assert port.bwd_scratch(rows, vocab, dim) == (
        dx_splits, dw_splits, tiles, vpad, rows * vpad,
        dx_splits * rows * dim + dw_splits * vpad * dim + tiles * vpad)
    assert port.bwd_launches(torch.bfloat16) == 3
    assert port.bwd_launches(torch.float32) == 2


@pytest.mark.parametrize("rows, vocab, dim", PLAN_CASES)
def test_fwd_plan_fills_the_card(rows, vocab, dim):
    """The bf16 forward takes 128-row tiles at every D (at D 512 its W
    chunks come through the ring in halves, so that x and the ring fit an
    SM's shared memory) and splits each tile's ceil(V / 64) chunks by the
    backward's rule: the
    fewest splits whose waves x chunks path is within 1/8 of the
    shortest, each of at least 8 chunks.  Where it splits, it writes
    float32 (m, l, z_label, sum z) partials [S, R] and launches the
    combine after the split pass."""
    splits, tiles, tile_rows, partial_size = port.fwd_plan(rows, vocab, dim)
    assert tile_rows == 128
    assert tiles == -(-rows // tile_rows)
    chunks = -(-vocab // 64)

    def path(s):  # waves of blocks times chunks a block
        return -(-tiles * s // 132) * -(-chunks // s)
    shortest = min(path(s) for s in range(1, max(1, chunks // 8) + 1))
    assert chunks // splits >= 8 or splits == 1
    assert 8 * path(splits) <= 9 * shortest
    assert all(8 * path(s) > 9 * shortest for s in range(1, splits))
    assert partial_size == (4 * splits * rows if splits > 1 else 0)
    assert port.fwd_launches(rows, vocab, dim, torch.bfloat16) \
        == 1 + (splits > 1)
    assert port.fwd_launches(rows, vocab, dim, torch.float32) == 1


@pytest.mark.parametrize("rows, vocab, dim, want", [
    # R 6000, V 8192: 47 tiles x 5 splits (two waves of 26 chunks)
    (6000, 8192, 256, (5, 47, 128, 4 * 5 * 6000)),
    # one tile of 11 chunks: no split, no combine
    (37, 650, 256, (1, 1, 128, 0)),
    # D 512: 32 tiles x 4 splits, one wave of 128 chunks a block
    (4096, 32768, 512, (4, 32, 128, 4 * 4 * 4096)),
])
def test_fwd_plan_at_the_kernel_shapes(rows, vocab, dim, want):
    assert port.fwd_plan(rows, vocab, dim) == want
    assert port.fwd_launches(rows, vocab, dim, torch.bfloat16) \
        == 1 + (want[0] > 1)


def _split_fwd(x2, w, bias, labels, confidence, low_confidence, splits):
    """The bf16 forward's split pass and combine in plain torch: for each
    split of ceil(V / 64) chunks of 64 columns (the last splits may hold
    no column), a row's (max, sum-exp, label logit, sum of logits),
    merged in split order as the combine kernel merges them; a split
    without columns is (-1e30, 0, 0, 0)."""
    rows, vocab = x2.shape[0], w.shape[0]
    z = port._logits(x2, w, bias)
    lab = labels.long()
    per = -(-(-(-vocab // 64)) // splits) * 64  # columns a split
    m = torch.full((rows,), -1e30)
    l, zy, sz = (torch.zeros(rows) for _ in range(3))
    for s in range(splits):
        lo, hi = min(vocab, s * per), min(vocab, (s + 1) * per)
        zs = z[:, lo:hi]
        if hi > lo:
            ms = zs.max(dim=1).values
            ls = torch.exp(zs - ms[:, None]).sum(dim=1)
        else:
            ms, ls = torch.full((rows,), -1e30), torch.zeros(rows)
        mm = torch.maximum(m, ms)
        l = l * torch.exp(m - mm) + ls * torch.exp(ms - mm)
        m = mm
        zy = zy + torch.where((lab >= lo) & (lab < hi),
                              z.gather(1, lab[:, None])[:, 0], 0.0)
        sz = sz + zs.sum(dim=1)
    lse = m + torch.log(l.clamp_min(1e-37))
    xent = (-(confidence - low_confidence) * (zy - lse)
            - low_confidence * (sz - vocab * lse))
    return xent, lse


# (rows, dim, vocab, dtype, splits): ragged vocabularies, 11 chunks in 3
# splits, in 5 (the last split holds no column) and in 2 (bf16), and 8
# one-chunk splits
SPLIT_CASES = [(21, 128, 650, "float32", 3), (21, 128, 650, "float32", 5),
               (13, 256, 650, "bfloat16", 2), (9, 128, 512, "float32", 8)]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: f"{c[2]}-{c[3]}-s{c[4]}")
def test_split_fwd_matches_plain_and_pallas_interpret(case):
    """The split forward's statistics, merged in the kernel's order, give
    the plain version's xent and lse and the JAX ``fused_linear_xent``'s
    xent (its Pallas forward kernel in interpret mode)."""
    rows, dim, vocab, dtype, splits = case
    x, w, labels, bias, _ = _inputs(rows + vocab, (rows,), dim, vocab, True,
                                    dtype)
    c, low = 0.9, 0.1 / (vocab - 1)
    tdt = getattr(torch, dtype)
    args = (torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
            torch.from_numpy(bias), torch.from_numpy(labels), c, low)
    xent, lse = _split_fwd(*args, splits)
    ref_xent, ref_lse = port._fwd_plain(*args)
    tol = TOL[dtype][0]
    assert (xent - ref_xent).abs().max() <= tol
    assert (lse - ref_lse).abs().max() <= tol
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jax_xent = jax_fused_linear_xent(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(labels), c, low,
        bias=jnp.asarray(bias), interpret=True)
    assert np.abs(xent.numpy() - np.asarray(jax_xent)).max() <= tol


def test_bf16_operands_must_be_16_byte_aligned():
    """The bf16 kernels stage 16-byte vectors: a view that starts
    mid-vector is refused (``fused_linear_xent`` hands them aligned
    copies)."""
    buf = torch.zeros(6 * 128 + 1, dtype=torch.bfloat16)
    aligned = buf[:6 * 128].view(6, 128)
    shifted = buf[1:].view(6, 128)
    port._check_aligned16(aligned, aligned)
    with pytest.raises(ValueError, match="x must be 16-byte aligned"):
        port._check_aligned16(shifted, aligned)
    with pytest.raises(ValueError, match="w must be 16-byte aligned"):
        port._check_aligned16(aligned, shifted)
