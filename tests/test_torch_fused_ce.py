"""The port's fused projection + label-smoothed cross entropy against the
JAX package's.

On the CPU the kernel wrappers (``fused_linear_xent_fwd`` and
``fused_linear_xent_bwd``) compute their plain PyTorch versions; through
``fused_linear_xent`` (the autograd function) they are held against the
JAX ``fused_linear_xent`` with the Pallas kernels (``_linear_fwd_kernel``
and ``_linear_bwd_kernel``) in interpret mode, on the same numpy-seeded
inputs: the per-token xent and dx / dW / db for the same output
gradient.  The CUDA kernels are held against the same plain versions on
the card by ``chip_smoke.py``; here only the wrappers' input checks run.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from neurst_tpu.ops.fused_ce import \
    fused_linear_xent as jax_fused_linear_xent  # noqa: E402
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
