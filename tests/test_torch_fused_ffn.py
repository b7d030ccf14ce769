"""The port's fused FFN (``neurst_tpu_torch/ops/fused_ffn.py``) against
the JAX package's Pallas kernels in interpret mode, against plain
autograd of the port's own composite, and its gate against the JAX
package's and the recorded H100 sweep.

On the CPU the kernel wrappers compute the plain versions.  The forward
is held against ``neurst_tpu.ops.fused_ffn.fused_ffn(..., interpret=True)``
at rate 0 (the TPU hardware generator has no interpret mode).  The
backward is held against ``_ffn_bwd_impl(..., interpret=True)`` called
directly and fed the port's post-dropout hidden ``hd``, at rate 0 and at
rate 0.1: that kernel reads its masks from ``hd > 0``, and calling it
directly sidesteps the reference's broken ``custom_vjp`` (ROADMAP R1)
without editing the JAX package.  The CUDA kernels are held against the
same plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from neurst_tpu.ops.fused_ffn import _ffn_bwd_impl  # noqa: E402
from neurst_tpu.ops.fused_ffn import \
    _threshold_and_scale as jax_threshold_and_scale  # noqa: E402
from neurst_tpu.ops.fused_ffn import \
    fused_ffn as jax_fused_ffn  # noqa: E402
from neurst_tpu.ops.kernel_gates import \
    gate_min_rows as jax_gate_min_rows  # noqa: E402
from neurst_tpu_torch.ops import fused_dropout as fd  # noqa: E402
from neurst_tpu_torch.ops import fused_ffn as port  # noqa: E402
from neurst_tpu_torch.ops import kernel_gates  # noqa: E402
from neurst_tpu_torch.utils.rng import DropoutKey  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

D, F = 128, 256
KEY = DropoutKey(2024, 7, stream=4, micro=0)
# float32 through two products of D and F terms, summed in other orders
FWD_ATOL = 1e-5
BWD_REL = 2e-5


def _inputs(rows, seed=0, d=D):
    r = np.random.RandomState(seed + rows)
    return {"x": r.randn(rows, d).astype(np.float32),
            # JAX layout: w1 [D, F], w2 [F, D]
            "w1": (r.randn(d, F) / np.sqrt(d)).astype(np.float32),
            "b1": (0.1 * r.randn(F)).astype(np.float32),
            "w2": (r.randn(F, d) / np.sqrt(F)).astype(np.float32),
            "b2": (0.1 * r.randn(d)).astype(np.float32),
            "dy": r.randn(rows, d).astype(np.float32)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(ours, ref):
    ours = ours.detach().float().numpy()
    if isinstance(ref, torch.Tensor):
        ref = ref.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


def _check_forward(rows, d):
    a = _inputs(rows, d=d)
    ref = jax_fused_ffn(*(jnp.asarray(a[k]) for k in
                          ("x", "w1", "b1", "w2", "b2")), interpret=True)
    y, hd = port.fused_ffn_fwd(_t(a["x"]), _t(a["w1"].T), _t(a["b1"]),
                               _t(a["w2"].T), _t(a["b2"]),
                               save_hidden=True)
    assert y.shape == (rows, d) and hd.shape == (rows, F)
    assert np.abs(y.numpy() - np.asarray(ref)).max() <= FWD_ATOL
    public = port.fused_ffn(_t(a["x"])[None], _t(a["w1"].T), _t(a["b1"]),
                            _t(a["w2"].T), _t(a["b2"]))
    assert torch.equal(public[0], y)


@pytest.mark.parametrize("rows", [9, 12, 2000])
def test_forward_matches_pallas_interpret(rows):
    _check_forward(rows, D)


@pytest.mark.parametrize("rows", [9, 130])
def test_forward_matches_pallas_interpret_at_d512(rows):
    """The plain forward at D 512, the transformer_base width the CUDA
    kernels are also built for."""
    _check_forward(rows, 512)


def _check_backward(rows, rate, d):
    a = _inputs(rows, seed=1, d=d)
    key = KEY if rate else None
    _, hd = port.fused_ffn_fwd(_t(a["x"]), _t(a["w1"].T), _t(a["b1"]),
                               _t(a["w2"].T), _t(a["b2"]), rate, key,
                               save_hidden=True)
    t8, inv_keep = jax_threshold_and_scale(rate)
    _, scale = fd.threshold_and_scale(rate, True)
    assert scale == inv_keep
    if rate:
        dropped = float((hd == 0).float().mean())
        assert 0.05 < dropped < 0.8  # relu zeros plus the dropped share
    ref = _ffn_bwd_impl(jnp.asarray(a["x"]), jnp.asarray(a["w1"]),
                        jnp.asarray(a["w2"]), jnp.asarray(hd.numpy()),
                        jnp.asarray(a["dy"]), t8, inv_keep, True)
    dx, dw1, dw2, db1, db2 = port.fused_ffn_bwd(
        _t(a["x"]), _t(a["w1"].T), _t(a["w2"].T), hd, _t(a["dy"]), scale)
    want = (ref[0], np.asarray(ref[1]).T, np.asarray(ref[2]).T,
            np.asarray(ref[3])[0], np.asarray(ref[4])[0])
    for name, got, w in zip(("dx", "dw1", "dw2", "db1", "db2"),
                            (dx, dw1, dw2, db1, db2), want):
        assert got.shape == np.asarray(w).shape, name
        assert _rel(got, w) <= BWD_REL, name


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("rows", [9, 12, 2000])
def test_backward_matches_pallas_interpret(rows, rate):
    """dx, dW1, dW2, db1, db2 from the port's hd against the Pallas
    backward on the same hd (rel 2e-5 of each gradient's largest
    value)."""
    _check_backward(rows, rate, D)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_matches_pallas_interpret_at_d512(rate):
    _check_backward(130, rate, 512)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matches_autograd_of_the_composite(rate, dtype):
    """``fused_ffn`` (forward and its backward) against plain autograd of
    linear -> relu -> the FFN site's dropout (quantized rate, same mask)
    -> linear on the same parameters.  float32 within 1e-5; bf16 within
    the rounding of hd and dh to bf16 (2^-8 relative of a summand)."""
    a = _inputs(40, seed=2)
    leaves = [_t(a[k]).to(dtype).requires_grad_() for k in ("x",)] + [
        _t(a["w1"].T.copy()).requires_grad_(), _t(a["b1"]).requires_grad_(),
        _t(a["w2"].T.copy()).requires_grad_(), _t(a["b2"]).requires_grad_()]
    key = KEY if rate else None
    y = port.fused_ffn(*leaves, rate, key)
    dy = _t(a["dy"]).to(dtype)
    grads = torch.autograd.grad(y, leaves, dy)

    x, w1, b1, w2, b2 = leaves
    h = torch.relu(x.float() @ w1.to(dtype).float().t() + b1)
    threshold, scale = fd.threshold_and_scale(rate, True)
    keep = fd.dropout_keep_mask(h.shape, key, threshold) if rate else \
        torch.ones_like(h, dtype=torch.bool)
    h = torch.where(keep, h * scale, torch.zeros_like(h)).to(dtype).float()
    y_ref = (h @ w2.to(dtype).float().t() + b2).to(dtype)
    ref = torch.autograd.grad(y_ref, leaves, dy)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert _rel(y, y_ref.detach()) <= tol
    for name, got, want in zip(("dx", "dw1", "db1", "dw2", "db2"), grads,
                               ref):
        assert got.shape == want.shape, name
        assert _rel(got, want.detach()) <= tol, name


@pytest.mark.parametrize("d", [128, 256, 512, 1024])
@pytest.mark.parametrize("mode", ["train", "train_drop", "infer"])
def test_gate_is_the_jax_packages(mode, d):
    """The JAX package's gate, but for D 256 and 512 in training, which
    follow the H100 sweeps recorded in ``ops/kernel_gates.py``: the
    smallest row count from which the fused FFN wins at every larger
    one, or the JAX package's threshold where it loses at every row
    count."""
    want = jax_gate_min_rows("fused_ffn", mode, d=d)
    if d in kernel_gates.H100_SWEEP and mode != "infer":
        swept = kernel_gates.min_rows_from_sweep(
            kernel_gates.H100_SWEEP[d][mode])
        want = want if swept is None else swept
    assert kernel_gates.fused_ffn_min_rows(mode, d) == want


@pytest.mark.parametrize("table, want", [
    ({1: (2.0, 1.0), 2: (1.0, 2.0), 3: (1.0, 2.0)}, 2),
    # a win below a loss does not count
    ({1: (1.0, 2.0), 2: (2.0, 1.0), 3: (1.0, 2.0)}, 3),
    ({1: (1.0, 2.0), 2: (2.0, 1.0)}, None),
    ({1: (1.0, 2.0), 2: (1.0, 2.0)}, 1),
])
def test_min_rows_from_sweep(table, want):
    assert kernel_gates.min_rows_from_sweep(table) == want


def test_h100_sweep_keeps_the_jax_gate_at_d512():
    """At D 512 the fused FFN loses at every measured row count and
    mode, so the training thresholds stay the JAX package's 16384 and the
    NMT cell's 32768-row FFNs still run the ported kernels."""
    sweep = kernel_gates.H100_SWEEP[512]
    for mode in ("train", "train_drop", "infer"):
        assert kernel_gates.min_rows_from_sweep(sweep[mode]) is None
        assert max(sweep[mode]) == 32768
    for mode in ("train", "train_drop"):
        assert kernel_gates.fused_ffn_min_rows(mode, 512) == 16384


def test_h100_sweep_sets_the_d256_training_gate():
    """As measured: with dropout the fused FFN wins from 16384 rows up;
    at dropout 0 and in inference it loses at the largest row count."""
    sweep = kernel_gates.H100_SWEEP[256]
    assert kernel_gates.min_rows_from_sweep(sweep["train_drop"]) == 16384
    assert kernel_gates.min_rows_from_sweep(sweep["train"]) is None
    assert kernel_gates.min_rows_from_sweep(sweep["infer"]) is None


@pytest.mark.parametrize("rows, training, rate, want", [
    (30000, True, 0.1, True),    # the recipe's encoder FFNs
    (6000, True, 0.1, False),    # its decoder FFNs: the composite wins
    (1023, True, 0.1, False),
    (30000, True, 0.0, True),    # dropout 0: the encoder FFNs
    (6000, True, 0.0, False),    # ... but not the decoder's
    (30000, False, 0.0, False),  # decode: never
])
def test_gate_at_the_recipe_shapes(rows, training, rate, want):
    assert port.fused_ffn_available(256, 2048, "relu", rows, training,
                                    rate) == want
    assert not port.fused_ffn_available(256, 2048, "gelu", rows, training,
                                        rate)


@pytest.mark.parametrize("rows, training, rate, want", [
    (32768, True, 0.1, True),    # the NMT cell's 12 FFNs
    (32768, True, 0.0, True),
    (16383, True, 0.1, False),
    (32768, False, 0.0, False),  # decode: never
])
def test_gate_at_the_nmt_cell(rows, training, rate, want):
    """transformer_base at [256, 128] (32768 rows a side) runs the fused
    FFN at D 512 in every layer of both stacks."""
    assert port.fused_ffn_available(512, 2048, "relu", rows, training,
                                    rate) == want


def test_cpu_tensors_take_the_plain_version_and_dropout_needs_a_key():
    a = _inputs(12)
    args = (_t(a["x"]), _t(a["w1"].T), _t(a["b1"]), _t(a["w2"].T),
            _t(a["b2"]))
    before = (port.fused_ffn_fwd.launches, port.fused_ffn_bwd.launches)
    y, _ = port.fused_ffn_fwd(*args)
    assert torch.equal(y, port._fwd_plain(*args, (0, 1.0, None), False)[0])
    assert (port.fused_ffn_fwd.launches,
            port.fused_ffn_bwd.launches) == before
    with pytest.raises(ValueError, match="dropout_key"):
        port.fused_ffn_fwd(*args, 0.1)


def test_kernel_input_checks_refuse():
    a = _inputs(12)
    x, w1, w2 = _t(a["x"]), _t(a["w1"].T.copy()), _t(a["w2"].T.copy())
    with pytest.raises(TypeError, match="share"):
        port._check_cuda_inputs(x, w1.bfloat16(), w2)
    with pytest.raises(ValueError, match="want"):
        port._check_cuda_inputs(x, w2, w1)
    # the kernels are built for D = 256 and 512 only
    with pytest.raises(ValueError, match="not in"):
        port._check_cuda_inputs(x, w1, w2)
    assert not port.fused_ffn_available(D, 2048, "relu", 30000, True, 0.1)
    w1, w2 = torch.zeros(F, 384), torch.zeros(384, F)
    with pytest.raises(ValueError, match="not in"):
        port._check_cuda_inputs(torch.zeros(12, 384), w1, w2)
    assert not port.fused_ffn_available(384, 1536, "relu", 30000, True, 0.1)
    x, w1, w2 = torch.zeros(12, 256), torch.zeros(F, 256), torch.zeros(256, F)
    with pytest.raises(ValueError, match="CUDA"):
        port._check_cuda_inputs(x, w1, w2)


def test_dw_splits_cover_the_card():
    """At the recipe's shapes the bf16 dW pass fills the card's resident
    blocks in one whole wave: its 32 output tiles (both products, 128
    filter rows by all 256 dims; 64 at D 512, two 256-column tiles a
    row) times the splits fit the one block an SM of 132 SMs and leave
    fewer free slots than one more split would take; a ragged 37 rows
    takes one split.  The float32 pass keeps well over 132 blocks."""
    slots = port._SMS * port._DW_BLOCKS_PER_SM
    for dim, rows in ((256, 30000), (256, 6000), (512, 32768)):
        tiles = 2 * (2048 // port._DW_TILE_F) * (dim // port._DW_TILE_D)
        splits = port.dw_splits(rows, 2048, dim, torch.bfloat16)
        assert tiles * splits <= slots < tiles * (splits + 1)
        f32 = port.dw_splits(rows, 2048, dim, torch.float32)
        assert 2048 // port._DW_COLS_F32 * f32 >= 264
    assert port.dw_splits(37, 2048, 256, torch.bfloat16) == 1


@pytest.mark.parametrize("rows, dtype, want", [
    # bf16: 4 splits; 235 dx tiles of 128 rows, or 94 (1) of 64 where 128
    # rows a tile would not fill the 132 SMs once; dh [R, F]
    (30000, torch.bfloat16, (4, 235, 30000 * 2048,
                             2 * 4 * 2048 * 256 + 235 * (2048 + 256))),
    (6000, torch.bfloat16, (4, 94, 6000 * 2048,
                            2 * 4 * 2048 * 256 + 94 * (2048 + 256))),
    (37, torch.bfloat16, (1, 1, 37 * 2048, 2 * 2048 * 256 + 2048 + 256)),
    # float32 recomputes dh in its dW pass: no dh, one bias partial a split
    (30000, torch.float32, (9, 9, 0, 2 * 9 * 2048 * 256 + 9 * (2048 + 256))),
])
def test_bwd_scratch_sizes(rows, dtype, want):
    """The backward's scratch: the dh buffer the bf16 dx pass writes and
    its dW pass reads, and the float32 partials the sum kernel adds (dW1
    and dW2 per split, db1 and db2 per bias partial)."""
    assert port.bwd_scratch(rows, 2048, 256, dtype) == want


@pytest.mark.parametrize("rows, dtype, want", [
    # the NMT cell: 2 splits of 64 tiles; 512 dx tiles of 64 rows
    (32768, torch.bfloat16, (2, 512, 32768 * 2048,
                             2 * 2 * 2048 * 512 + 512 * (2048 + 512))),
    (2000, torch.bfloat16, (2, 32, 2000 * 2048,
                            2 * 2 * 2048 * 512 + 32 * (2048 + 512))),
    (37, torch.bfloat16, (1, 1, 37 * 2048, 2 * 2048 * 512 + 2048 + 512)),
    (32768, torch.float32, (9, 9, 0,
                            2 * 9 * 2048 * 512 + 9 * (2048 + 512))),
])
def test_bwd_scratch_sizes_at_d512(rows, dtype, want):
    """At D 512 every bf16 dx tile has 64 rows and the dW pass's output
    tiles double (two 256-column tiles a row)."""
    assert port.bwd_scratch(rows, 2048, 512, dtype) == want


@pytest.mark.parametrize("rows, want", [
    # 235 tiles of 128 rows already fill the 132 SMs: no split
    (30000, 1),
    # the decoder's 47 tiles: two blocks a tile (94 blocks, one wave;
    # three would take a second wave)
    (6000, 2),
    # one tile: the filter's 32 chunks over four blocks of eight
    (37, 4),
])
def test_fwd_splits_fill_the_card(rows, want):
    """The bf16 forward splits a row tile's filter over S blocks where
    its tiles alone would leave SMs idle, each split taking at least 8 of
    the 32 chunks, and then takes two launches (the forward and the sum
    of its float32 partials); float32 never splits."""
    _check_fwd_splits(rows, 256, want)


def _check_fwd_splits(rows, dim, want):
    tiles = -(-rows // port.fwd_rows(dim))
    splits = port.fwd_splits(rows, 2048, dim, torch.bfloat16)
    assert splits == want
    assert 2048 // port._CHUNK // splits >= 8
    assert -(-tiles * splits // port._SMS) <= -(-tiles // port._SMS)
    assert port.fwd_launches(rows, 2048, dim, torch.bfloat16) \
        == 1 + (want > 1)
    assert port.fwd_splits(rows, 2048, dim, torch.float32) == 1
    assert port.fwd_launches(rows, 2048, dim, torch.float32) == 1


@pytest.mark.parametrize("rows, want", [
    # the NMT cell: 512 tiles of 64 rows fill the card almost four times
    (32768, 1),
    # 32 tiles: four blocks a tile (128 blocks, one wave)
    (2000, 4),
    (37, 4),
])
def test_fwd_splits_fill_the_card_at_d512(rows, want):
    """At D 512 the forward's tiles have 64 rows; the splits follow the
    same rule."""
    assert port.fwd_rows(512) == 64 and port.fwd_rows(256) == 128
    _check_fwd_splits(rows, 512, want)
