"""The port's sampling search against the JAX package's.

The deterministic parts are held exactly (up to float32 rounding): the
step distribution ``masked_step_log_probs`` (temperature, UNK, minimum
length), the top-k and top-p filters, and ``top_k=1`` sampling on a small
Transformer from the JAX initializers (ids equal, scores within 1e-5
relative).  The draws themselves come from a ``torch.Generator`` and
cannot be JAX's threefry draws, so they are held statistically: 20,000
draws at a fixed seed from a toy logit table through ``sequence_sampling``
fall only on the tokens the JAX filters keep, within a total-variation
distance of 0.02 of the JAX distribution (the expected distance at this
count is ~0.006).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import neurst_tpu_torch  # noqa: E402
from neurst_tpu.layers.search import sampling as jsampling  # noqa: E402
from neurst_tpu.models.model import build_model as jax_build  # noqa: E402
from neurst_tpu.utils.checkpoints import flatten_params  # noqa: E402
from neurst_tpu_torch.layers.search import sampling  # noqa: E402
from neurst_tpu_torch.layers.search.sequence_search import \
    build_search_layer  # noqa: E402
from neurst_tpu_torch.utils.param_bridge import \
    load_flat_params  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

V = 12


def _logits(seed, rows=3, vocab=V):
    return (2.0 * np.random.RandomState(seed).randn(rows, vocab)).astype(
        np.float32)


@pytest.mark.parametrize("temperature, unk_id, min_len, emit", [
    (1.0, None, 0, 0), (0.7, 3, 0, 2), (1.5, 3, 4, 1), (1.0, None, 4, 3),
    (1.0, 5, 2, np.asarray([0, 1, 5]))])
def test_masked_step_log_probs_match_jax(temperature, unk_id, min_len,
                                         emit):
    logits = _logits(1)
    ours = sampling.masked_step_log_probs(
        torch.from_numpy(logits), emit if np.isscalar(emit)
        else torch.from_numpy(emit), 1, unk_id, temperature, min_len)
    want = jsampling.masked_step_log_probs(jnp.asarray(logits), emit, 1,
                                           unk_id, temperature, min_len)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 5, V])
def test_top_k_filter_matches_jax(k):
    lp = torch.log_softmax(torch.from_numpy(_logits(2)), -1)
    lp[1, 4] = lp[1, 7]   # a tie at the k-th value keeps both
    ours = sampling._filter_top_k(lp, k)
    want = jsampling._filter_top_k(jnp.asarray(lp.numpy()), k)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", [0.05, 0.3, 0.8, 0.99, 1.0])
def test_top_p_filter_matches_jax(p):
    lp = torch.log_softmax(torch.from_numpy(_logits(3)), -1)
    ours = sampling._filter_top_p(lp, p)
    want = jsampling._filter_top_p(jnp.asarray(lp.numpy()), p)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))


def test_flags_and_registered_names_match_jax():
    def flags(cls):
        return {f.name: f.default for f in cls.class_or_method_args()}
    assert flags(sampling.TopSampling) == flags(jsampling.TopSampling)
    for name in ("top_sampling", "sampling", "TopSampling"):
        layer = build_search_layer({"search_method.class": name})
        assert isinstance(layer, sampling.TopSampling)


@pytest.fixture(scope="module")
def toy_models():
    meta = {"vocab_size": 64, "eos_id": 1, "bos_id": 2, "unk_id": 3}
    params = {"modality.dim": 16, "modality.timing": "sinusoids",
              "modality.share_embedding_and_softmax_weights": True,
              "dtype": "float32"}
    for side in ("encoder", "decoder"):
        params.update({f"{side}.num_layers": 1, f"{side}.hidden_size": 16,
                       f"{side}.num_attention_heads": 2,
                       f"{side}.filter_size": 32})
    cfg = {"model.class": "transformer", "model.params": params}
    jm = jax_build(cfg, src_meta=meta, trg_meta=meta)
    jparams = jm.init_params(jax.random.PRNGKey(4))
    tm = neurst_tpu_torch.build_model(cfg, src_meta=meta, trg_meta=meta,
                                      device="cpu")
    load_flat_params(tm, {k: np.asarray(v) for k, v in
                          flatten_params(jparams).items()})
    return jm, jparams, tm


@pytest.mark.parametrize("args", [
    {"top_k": 1, "maximum_decode_length": 9},
    {"top_k": 1, "num_samples": 2, "minimum_decode_length": 3,
     "maximum_decode_length": 9, "extra_decode_length": 2},
    {"top_k": 1, "temperature": 0.5, "enable_unk": True,
     "maximum_decode_length": 6}])
def test_top_k_1_sampling_equals_jax(toy_models, args):
    """``top_k=1`` is the argmax of the masked distribution: the ids and
    summed log-probs of the JAX layer, to the length limit or EOS."""
    jm, jparams, tm = toy_models
    rng = np.random.RandomState(5)
    inputs = {"src": rng.randint(4, 64, (3, 5)).astype(np.int32),
              "src_padding": (np.arange(5)[None] >= np.asarray(
                  [5, 2, 4])[:, None]).astype(np.float32)}
    ours = build_search_layer({"search_method.class": "top_sampling",
                               "search_method.params": args})
    ours.set_model(tm)
    ids, scores = ours(inputs)
    theirs = jsampling.TopSampling(args)
    theirs.set_model(jm)
    jids, jscores = theirs(jparams, inputs)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=1e-5)
    assert ids.shape[0] == 3 * args.get("num_samples", 1)


@pytest.mark.parametrize("top_k, top_p, temperature", [
    (0, 1.0, 1.0), (5, 1.0, 1.0), (0, 0.8, 1.0), (4, 0.9, 0.7)])
def test_sampled_frequencies_match_the_jax_distribution(top_k, top_p,
                                                        temperature):
    n = 20000
    table = _logits(6, rows=1)

    def symbols_to_logits_fn(ids, cache, time):
        return torch.from_numpy(table).expand(ids.shape[0], V), cache

    init = {"decoder_input": torch.full((n,), 2), "eos_id": 1,
            "unk_id": 3, "decoder_internal_cache": {}}
    gen = torch.Generator().manual_seed(11)
    ids, scores = sampling.sequence_sampling(
        symbols_to_logits_fn, init, gen, top_k=top_k, top_p=top_p,
        temperature=temperature, maximum_decode_length=1)
    counts = np.bincount(ids[:, 0].numpy(), minlength=V) / n
    lp = jsampling.masked_step_log_probs(jnp.asarray(table), 0, 1, 3,
                                         temperature, 0)
    filtered = lp
    if top_k:
        filtered = jsampling._filter_top_k(filtered, top_k)
    if top_p < 1.0:
        filtered = jsampling._filter_top_p(filtered, top_p)
    want = np.asarray(jax.nn.softmax(filtered, axis=-1))[0]
    assert set(np.nonzero(counts)[0]) <= set(np.nonzero(want > 1e-12)[0])
    assert 0.5 * np.abs(counts - want).sum() <= 0.02
    # each draw scores its unfiltered masked log-prob
    np.testing.assert_allclose(
        scores.numpy(), np.asarray(lp)[0][ids[:, 0].numpy()], rtol=1e-6)
    # the same seed draws the same tokens
    again, _ = sampling.sequence_sampling(
        symbols_to_logits_fn, init, torch.Generator().manual_seed(11),
        top_k=top_k, top_p=top_p, temperature=temperature,
        maximum_decode_length=1)
    assert torch.equal(ids, again)


def test_sampling_without_a_generator_raises_unless_greedy():
    init = {"decoder_input": torch.full((2,), 2), "eos_id": 1,
            "decoder_internal_cache": {}}

    def s2l(ids, cache, time):
        return torch.zeros(ids.shape[0], V), cache
    with pytest.raises(ValueError, match="Generator"):
        sampling.sequence_sampling(s2l, init, None, top_k=0)
    ids, _ = sampling.sequence_sampling(s2l, init, None, top_k=1,
                                        maximum_decode_length=2)
    assert ids.tolist() == [[0, 0], [0, 0]]


@pytest.mark.parametrize("top_k, top_p", [(0, 1.0), (5, 0.9)])
def test_exponential_draws_pick_the_multinomial_token(top_k, top_p):
    """A step's ``argmax(p / q)`` over ``exponential_draws`` picks the
    token that ``torch.multinomial(p, 1)`` picks from the same seeded
    generator, so the seeded samples are those of a multinomial draw."""
    logits = torch.from_numpy(np.random.RandomState(3).randn(64, V)
                              .astype(np.float32) * 3.0)
    lp = sampling.masked_step_log_probs(logits, 0, 1, 3, 1.0, 0)
    probs = torch.softmax(sampling.filter_log_probs(lp, top_k, top_p), -1)
    want = torch.multinomial(probs, 1,
                             generator=torch.Generator().manual_seed(5))
    draws = sampling.exponential_draws(
        probs.shape, torch.Generator().manual_seed(5), "cpu")
    assert torch.equal((probs / draws).argmax(dim=-1), want[:, 0])
