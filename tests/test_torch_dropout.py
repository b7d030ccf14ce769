"""The port's dropout: the counter-based Philox4x32-10 mask
(``neurst_tpu_torch/ops/fused_dropout.py``, ``utils/rng.py``), its rates
against the JAX package's, its statistics, its backward, which sites of
``speech_transformer_s`` quantize the rate, and the kernel build's hash
of shared headers.

On the CPU the kernel wrapper computes the plain version; the CUDA kernel
(``csrc/fused_dropout.cu``) is held bitwise against it on the card by
``chip_smoke.py``.  The TPU's hardware generator cannot be matched bit for
bit, so against JAX the tests compare rates, thresholds and scales.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from neurst_tpu.ops.flash_attention import \
    _drop_consts as jax_flash_consts  # noqa: E402
from neurst_tpu.ops.fused_dropout import \
    _threshold_and_scale as jax_threshold_and_scale  # noqa: E402
from neurst_tpu_torch.ops import _build  # noqa: E402
from neurst_tpu_torch.ops import fused_dropout as fd  # noqa: E402
from neurst_tpu_torch.utils import rng  # noqa: E402

# Random123's published known-answer vectors of Philox4x32-10
# (counter, key, result)
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter, key, want", KAT,
                         ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    """On Python integers (key derivation) and on int64 tensors (the
    kernels' plain twin) the generator reproduces the vectors."""
    assert rng.philox4x32_10(*counter, *key) == want
    words = rng.philox4x32_10(*(torch.tensor([c, c]) for c in counter),
                              *key)
    assert [w.tolist() for w in words] == [[v, v] for v in want]


def test_words_follow_the_absolute_index():
    """Element i reads word i & 3 of the group i >> 2, and a slice of a
    longer site's words is the shorter site's words."""
    key = rng.DropoutKey(11, 22, stream=5, micro=1)
    words = fd.dropout_words(10, key)
    want = [w for g in range(3) for w in rng.philox4x32_10(
        g, 0, 5, 1, 11, 22)][:10]
    assert words.tolist() == want
    assert torch.equal(fd.dropout_words(1000, key)[:10], words)


def test_masks_are_deterministic_and_differ_by_stream_step_and_micro():
    key = rng.make_key(1234)
    step0, step1 = rng.fold_in(key, 0), rng.fold_in(key, 1)
    micro0, micro1 = rng.split(step0, 2)
    variants = {
        "base": step0, "step": step1, "micro0": micro0, "micro1": micro1,
        "stream": rng.at_site(step0, 3), "other_seed": rng.make_key(1235)}
    threshold, _ = fd.threshold_and_scale(0.1, False)
    masks = {name: fd.dropout_keep_mask((64, 128), k, threshold)
             for name, k in variants.items()}
    assert torch.equal(masks["base"],
                       fd.dropout_keep_mask((64, 128), rng.fold_in(key, 0),
                                            threshold))
    names = sorted(masks)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            assert not torch.equal(masks[a], masks[b]), (a, b)
    assert (micro0.micro, micro1.micro) == (0, 1)
    assert (micro0.k0, micro0.k1) != (micro1.k0, micro1.k1)


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.001, 0.999])
def test_rates_follow_the_jax_package(rate):
    """Quantized sites: t8 and the realized-rate scale of
    ``neurst_tpu.ops.fused_dropout._threshold_and_scale`` (0.1 -> 26/256);
    exact sites: the 32-bit threshold and scale of the flash kernels."""
    t8, scale = jax_threshold_and_scale(rate)
    assert fd.threshold_and_scale(rate, True) == (t8 << 24, scale)
    assert fd.threshold_and_scale(rate, False) == jax_flash_consts(rate)
    assert fd.threshold_and_scale(0.0, True) == (0, 1.0)
    if rate == 0.1:
        assert t8 == 26 and abs(scale - 1.0 / (1.0 - 26 / 256)) < 1e-15


RECIPE_SITES = {
    # (shape a site sees in the recipe's 40 x 3000 bucket, quantized)
    "encoder postprocess": ((40, 750, 256), True),
    "decoder postprocess": ((40, 150, 256), True),
    "decoder self-attention weights": ((40, 4, 150, 150), False),
    "decoder cross-attention weights": ((40, 4, 150, 750), False),
    "unfused FFN hidden": ((40, 150, 2048), True),
    "small hidden": ((1, 16, 2048), False),
}


@pytest.mark.parametrize("site", sorted(RECIPE_SITES))
def test_which_sites_of_the_recipe_quantize(site):
    """The TPU path's gate (``neurst_tpu/layers/common_layers.py:77-78``:
    at least 65536 elements and a last dim divisible by 128)."""
    shape, quantized = RECIPE_SITES[site]
    size = int(np.prod(shape))
    assert (size >= (1 << 16) and shape[-1] % 128 == 0) == quantized
    assert fd.quantized_site(shape) == quantized


def test_speech_transformer_s_sites_in_a_training_step(monkeypatch):
    """Every ``apply_dropout`` site of a speech_transformer_s training
    forward (full width, one encoder and one decoder layer, encoder flash
    attention, a small batch): its shape decides its rate, each site draws
    from its own stream, and the stream numbers follow (side, layer,
    site)."""
    import neurst_tpu_torch
    from neurst_tpu_torch.layers import common_layers
    from neurst_tpu_torch.models.speech_transformer import SpeechTransformer
    cfg = SpeechTransformer.build_model_args_by_name("speech_transformer_s")
    params = dict(cfg["model.params"], dtype="float32",
                  **{"encoder.num_layers": 1, "decoder.num_layers": 1,
                     "encoder.enable_flash_attention": True})
    model = neurst_tpu_torch.build_model(
        dict(cfg, **{"model.params": params}),
        src_meta={"audio_feature_dim": 80}, trg_meta={"vocab_size": 64,
                                                      "eos_id": 1},
        device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    seen = []

    def record(x, rate, key, quantized):
        seen.append((tuple(x.shape), quantized, key.stream))
        return fd.dropout(x, rate, key, quantized)

    monkeypatch.setattr(common_layers, "dropout", record)
    r = np.random.RandomState(0)
    inputs = {"src": r.randn(2, 256, 80).astype(np.float32),
              "src_length": np.asarray([256, 200]),
              "trg_input": r.randint(0, 64, (2, 16))}
    model.call_train(inputs, dropout_key=rng.make_key(0))
    enc, dec = rng.SIDE_ENCODER << 16, rng.SIDE_DECODER << 16
    assert seen == [
        ((2, 64, 256), False, enc | 1),        # self-attention out
        ((2, 64, 2048), True, enc | 4),        # FFN hidden (unfused)
        ((2, 64, 256), False, enc | 5),        # FFN out
        ((2, 4, 16, 16), False, dec | 0),      # self-attention weights
        ((2, 16, 256), False, dec | 1),
        ((2, 4, 16, 64), False, dec | 2),      # cross-attention weights
        ((2, 16, 256), False, dec | 3),
        ((2, 16, 2048), True, dec | 4),
        ((2, 16, 256), False, dec | 5)]
    for shape, quantized, _ in seen:
        assert fd.quantized_site(shape) == quantized


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rate_and_mean_within_five_sigma(rate, quantized):
    """Over 2^20 elements the kept share lies within 5 sigma of its
    binomial expectation, and E[y] = x: with x = 1, mean(y) = kept share
    x scale within 5 sigma x scale of 1."""
    n = 1 << 20
    threshold, scale = fd.threshold_and_scale(rate, quantized)
    keep_p = 1.0 - threshold / 2.0 ** 32
    y = fd.dropout_reference(torch.ones(n), rng.make_key(7), threshold,
                             scale)
    kept = float((y != 0).float().mean())
    sigma = math.sqrt(keep_p * (1.0 - keep_p) / n)
    assert abs(kept - keep_p) <= 5 * sigma
    assert abs(float(y.mean()) - 1.0) <= 5 * sigma * scale
    assert set(torch.unique(y).tolist()) == {0.0, float(np.float32(scale))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_mask_equals_forward_mask(dtype):
    x = torch.from_numpy(np.random.RandomState(1).rand(300, 256).astype(
        np.float32) + 0.5).to(dtype).requires_grad_()
    key = rng.DropoutKey(3, 4, stream=9)
    y = fd.dropout(x, 0.1, key, True)
    (g,) = torch.autograd.grad(y, x, torch.ones_like(y))
    assert torch.equal(g != 0, y != 0)
    _, scale = fd.threshold_and_scale(0.1, True)
    assert torch.equal(g[g != 0].float(),
                       torch.full_like(g[g != 0].float(),
                                       float(torch.tensor(scale).to(dtype))))
    assert torch.equal(y, fd.dropout_reference(x.detach(), key,
                                               *fd.threshold_and_scale(
                                                   0.1, True)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mask_follows_the_element_index_not_the_address(dtype):
    """A view whose pointer the kernel's 16-byte vectors do not align
    with, and a length that is not a whole number of vectors, draw the
    mask of their element indices: the same output as an aligned copy,
    element i kept where word i & 3 of group i >> 2 reaches the
    threshold."""
    n = 37 * 199
    buf = torch.from_numpy(np.random.RandomState(2).rand(n + 1).astype(
        np.float32) + 0.5).to(dtype)
    x = buf[1:]
    assert x.storage_offset() == 1 and x.is_contiguous()
    key = rng.DropoutKey(5, 6, stream=3)
    threshold, scale = fd.threshold_and_scale(0.1, False)
    y = fd.fused_dropout_apply(x, key, threshold, scale)
    assert torch.equal(y, fd.fused_dropout_apply(x.clone(), key, threshold,
                                                 scale))
    assert torch.equal(y != 0, fd.dropout_words(n, key) >= threshold)


def test_rate_zero_and_cpu_tensors_launch_nothing():
    x = torch.ones(8, 128)
    assert fd.dropout(x, 0.0, rng.make_key(0), True) is x
    before = fd.fused_dropout_apply.launches
    fd.fused_dropout_apply(x, rng.make_key(0), *fd.threshold_and_scale(
        0.1, True))
    assert fd.fused_dropout_apply.launches == before


def test_library_hash_follows_included_headers(tmp_path, monkeypatch):
    """An edit of a header a kernel includes renames (so rebuilds) its
    library; an edit of a header it does not include does not."""
    (tmp_path / "a.cu").write_text('#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text('#include "c.cuh"\nint b;\n')
    (tmp_path / "c.cuh").write_text("int c;\n")
    (tmp_path / "d.cuh").write_text("int d;\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "KERNEL_SOURCES", {"a": "a.cu"})
    first = _build.library_path("a")
    (tmp_path / "d.cuh").write_text("int d2;\n")
    assert _build.library_path("a") == first
    (tmp_path / "c.cuh").write_text("int c2;\n")
    second = _build.library_path("a")
    assert second != first and second.name.startswith("liba-")
    (tmp_path / "a.cu").write_text('#include "b.cuh"\nint a2;\n')
    assert _build.library_path("a") not in (first, second)


def test_every_kernel_source_hashes_its_philox_header():
    """Each masking kernel's library name covers philox.cuh and the other
    local headers it includes (the tensor-core helpers of mma.cuh, the
    product over rows of row_product.cuh, the flash kernels' keep-bit
    tiles of flash_tile.cuh), in include order."""
    flash = ["flash_tile.cuh", "philox.cuh", "mma.cuh"]
    for name, headers in (("fused_dropout", ["philox.cuh"]),
                          ("fused_ffn", ["mma.cuh", "philox.cuh",
                                         "row_product.cuh"]),
                          ("flash_attention_fwd", flash),
                          ("flash_attention_bwd", flash)):
        sources = _build._sources(_build.CSRC_DIR
                                  / _build.KERNEL_SOURCES[name])
        assert [p.name for p in sources][1:] == headers, name
