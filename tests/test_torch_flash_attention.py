"""The port's flash attention, forward and backward, against the JAX
package's.

On the CPU each kernel wrapper computes its plain PyTorch version; the
forward (``flash_attention_reference``) is held against the Pallas
kernel in interpret mode (``neurst_tpu.ops.flash_attention``) on the
same numpy-seeded inputs (o and the row log-sum-exp of ``_fwd_impl``),
and the backward (``flash_attention_bwd_reference``, the dq and dk/dv
wrappers, and autograd through ``flash_attention``) against ``jax.vjp``
of the Pallas custom VJP in interpret mode.  The CUDA kernels themselves
are held against the same plain versions on the card by
``chip_smoke.py``; here only the wrappers' input checks run.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from neurst_tpu.ops.flash_attention import _fwd_impl  # noqa: E402
from neurst_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention  # noqa: E402
from neurst_tpu_torch.ops import flash_attention as port  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# (name, batch, t_q, t_k, heads, head_dim, lengths, causal)
CASES = [
    ("full", 2, 64, 64, 2, 32, [64, 64], False),
    ("lengths_0_1_mid_full", 4, 48, 104, 2, 32, [0, 1, 50, 104], False),
    ("ragged_causal", 4, 40, 40, 2, 16, [40, 0, 1, 23], True),
    ("causal_head64", 2, 72, 72, 2, 64, [72, 37], True),
]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# backward, max abs error relative to the largest |gradient| (measured
# at most 2e-6 in float32 and 7e-4 in bf16 over CASES): float32 sums in
# other orders; bf16 also rounds ds and p before each product, where a
# value one rounding step away from the other side's flips one bf16 ulp
# (2^-8 relative) of a summand
BWD_TOL = {"float32": 1e-5, "bfloat16": 5e-3}


def _inputs(seed, b, t_q, t_k, n, h, dtype):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, t, n, h).astype(np.float32)
               for t in (t_q, t_k, t_k))
    if dtype == "bfloat16":
        # round once in numpy-compatible f32 so both sides see the same
        # bf16 values
        q, k, v = (torch.from_numpy(x).bfloat16().float().numpy()
                   for x in (q, k, v))
    return q, k, v


def _jax(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16"
                       else jnp.float32)


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_output_and_lse_match_pallas_interpret(case, dtype):
    _, b, t_q, t_k, n, h, lengths, causal = case
    q, k, v = _inputs(len(lengths) + t_q, b, t_q, t_k, n, h, dtype)
    lens = np.asarray(lengths, np.int32)

    o_jax, (_, lse_jax) = _fwd_impl(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype), jnp.asarray(lens),
        jnp.zeros([2], jnp.uint32), causal, 32, 32, True, 0.0)
    o_jax = np.asarray(o_jax, np.float32)
    lse_jax = np.asarray(lse_jax, np.float32)[:, 0, :t_q].reshape(b, n, t_q)

    o, lse = port.flash_attention_fwd(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
        torch.from_numpy(lens), causal)
    assert o.dtype == getattr(torch, dtype) and o.shape == (b, t_q, n, h)
    assert lse.dtype == torch.float32 and lse.shape == (b, n, t_q)
    assert np.abs(o.float().numpy() - o_jax).max() <= TOL[dtype]
    assert np.abs(lse.numpy() - lse_jax).max() <= 1e-4


@pytest.mark.parametrize("causal", [False, True])
def test_public_function_matches_jax(causal):
    """``flash_attention`` (the layers' entry) against the JAX public
    function, lengths defaulting to the full key length."""
    q, k, v = _inputs(7, 2, 40, 40, 2, 16, "float32")
    ours = port.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                causal=causal)
    ref = jax_flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                              causal=causal, interpret=True)
    assert np.abs(ours.numpy() - np.asarray(ref)).max() <= 1e-5


def test_fully_masked_rows_give_zero_and_neg_inf():
    q, k, v = (torch.from_numpy(x) for x in
               _inputs(3, 2, 8, 8, 1, 16, "float32"))
    o, lse = port.flash_attention_fwd(q, k, v,
                                      torch.tensor([0, 8], dtype=torch.int32))
    assert torch.all(o[0] == 0) and torch.all(lse[0] == port.NEG_INF)
    assert torch.isfinite(lse[1]).all()


def test_cpu_tensors_take_the_plain_version_without_launching():
    q, k, v = (torch.from_numpy(x) for x in
               _inputs(5, 2, 16, 16, 2, 64, "float32"))
    before = port.flash_attention_fwd.launches
    o, lse = port.flash_attention_fwd(q, k, v, None, True)
    o_ref, lse_ref = port.flash_attention_reference(q, k, v, None, True)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert port.flash_attention_fwd.launches == before


@pytest.mark.parametrize("what, match", [
    ("head_dim", "head_dim 32"), ("device", "CUDA device"),
    ("dtype", "dtype"), ("lengths", "lengths")])
def test_kernel_input_checks_refuse(what, match):
    """What the CUDA kernel does not take is refused before any launch:
    a head dim it is not built for, tensors off the card, mixed dtypes,
    lengths of the wrong shape."""
    q, k, v = (torch.from_numpy(x) for x in
               _inputs(9, 2, 16, 16, 2, 64, "float32"))
    lens = torch.tensor([16, 5], dtype=torch.int32)
    if what == "head_dim":
        q, k, v = q[..., :32], k[..., :32], v[..., :32]
    elif what == "dtype":
        k = k.bfloat16()
    elif what == "lengths":
        lens = lens[:1]
    with pytest.raises((ValueError, TypeError), match=match):
        port._check_cuda_inputs(q, k, v, lens)


def test_dropout_is_refused():
    q = torch.zeros(1, 4, 1, 64)
    with pytest.raises(NotImplementedError):
        port.flash_attention(q, q, q, dropout_rate=0.1)


def _rel_err(ours, ref):
    ours = ours.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-6))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_matches_pallas_interpret(case, dtype):
    """dq, dk, dv of the plain backward, of the dq / dk-dv wrappers and of
    autograd through ``flash_attention`` against ``jax.vjp`` of the
    Pallas kernels (``_dq_kernel``, ``_dkv_kernel``) in interpret mode,
    for the same output gradient."""
    _, b, t_q, t_k, n, h, lengths, causal = case
    q, k, v = _inputs(len(lengths) + t_k, b, t_q, t_k, n, h, dtype)
    do = _inputs(t_q, b, t_q, t_q, n, h, dtype)[0]
    lens = np.asarray(lengths, np.int32)

    _, vjp = jax.vjp(lambda *a: jax_flash_attention(
        *a, lengths=jnp.asarray(lens), causal=causal, interpret=True),
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype))
    ref = vjp(_jax(do, dtype))

    tq, tk, tv, tdo = (_torch(x, dtype) for x in (q, k, v, do))
    tlens = torch.from_numpy(lens)
    o, lse = port.flash_attention_fwd(tq, tk, tv, tlens, causal)
    plain = port.flash_attention_bwd_reference(tq, tk, tv, tlens, o, lse,
                                               tdo, causal)
    delta = port._delta(o, tdo)
    wrappers = (port.flash_attention_dq(tq, tk, tv, tdo, lse, delta, tlens,
                                        causal),
                *port.flash_attention_dkv(tq, tk, tv, tdo, lse, delta,
                                          tlens, causal))
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = port.flash_attention(*leaves, tlens, causal)
    autograd = torch.autograd.grad(out, leaves, tdo)
    for ours in (plain, wrappers, autograd):
        for got, want in zip(ours, ref):
            assert got.dtype == getattr(torch, dtype)
            assert _rel_err(got, want) <= BWD_TOL[dtype]


def test_backward_of_a_row_without_keys_is_zero():
    """Length 0: lse is NEG_INF and exp(NEG_INF - NEG_INF) = 1, so p must
    be masked after the exp; the slice's dq, dk and dv are zero."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in
               _inputs(4, 2, 8, 8, 1, 16, "float32"))
    out = port.flash_attention(q, k, v,
                               torch.tensor([0, 8], dtype=torch.int32))
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    for g in grads:
        assert torch.all(g[0] == 0) and torch.isfinite(g).all()
        assert g[1].abs().sum() > 0


def test_backward_wrappers_refuse_a_mismatched_output_gradient():
    q, k, v = (torch.from_numpy(x) for x in
               _inputs(6, 2, 16, 16, 2, 64, "float32"))
    lens = torch.tensor([16, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="shapes"):
        port._check_cuda_inputs(q, k, v, lens, q[:, :8])
    with pytest.raises(TypeError, match="dtype"):
        port._check_cuda_inputs(q, k, v, lens, q.bfloat16())
