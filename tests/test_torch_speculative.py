"""Speculative decoding and the per-row decode steps of the port against
the JAX package's (``neurst_tpu/layers/search/speculative.py``).

Both packages load the same seeded weights (float32, TF32 off) and see
the same numpy inputs.  Held exactly: the n-gram draft's proposals and
buffer, ``speculative_greedy_decode``'s ids and statistics (scores within
1e-5 relative), ``speculative_beam_search``'s hypotheses (scores within
1e-5), each against the JAX function and against the port's own plain
greedy (``top_sampling`` top_k 1) or beam search.  The multi-token steps
at per-row times give the JAX model's logits within 1e-5 and equal k
single steps, for the text Transformer, the speech Transformer with its
encoder's flash path (the plain version on the CPU), the joint ASR + ST
model's translation head and GPT-2 after a prompt.  Sampling draws come
from a ``torch.Generator`` and are held by total variation (<= 0.02 over
20,000 draws) against the target's masked distribution from the JAX
model.  Both CLIs predict through the committed example ymls.
"""

import json
import os

import numpy as np
import pytest
import torch

import port_test_support  # noqa: F401  (one torch thread per worker)

jax = pytest.importorskip("jax")
import flax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import neurst_tpu_torch  # noqa: E402
from neurst_tpu.layers import common_layers as jcommon  # noqa: E402
from neurst_tpu.layers.search import speculative as jspec  # noqa: E402
from neurst_tpu.layers.search.sequence_search import \
    build_search_layer as jax_build_search  # noqa: E402
from neurst_tpu.models.model import build_model as jax_build  # noqa: E402
from neurst_tpu.utils import checkpoints as jax_ckpt  # noqa: E402
from neurst_tpu.utils.checkpoints import flatten_params  # noqa: E402
from neurst_tpu.utils.configurable import \
    ModelConfigs as JaxModelConfigs  # noqa: E402
from neurst_tpu_torch.cli import run_exp as port_run_exp  # noqa: E402
from neurst_tpu_torch.layers import common_layers  # noqa: E402
from neurst_tpu_torch.layers.decoders.transformer_decoder import \
    TransformerDecoder  # noqa: E402
from neurst_tpu_torch.layers.search import speculative  # noqa: E402
from neurst_tpu_torch.layers.search.beam_search import \
    sequence_beam_search  # noqa: E402
from neurst_tpu_torch.layers.search.sampling import \
    sequence_sampling  # noqa: E402
from neurst_tpu_torch.layers.search.sequence_search import \
    build_search_layer  # noqa: E402
from neurst_tpu_torch.utils.param_bridge import \
    load_flat_params  # noqa: E402

from port_test_support import JAX_CLI_SIDE, REPO, start_jax_side  # noqa

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

META = {"vocab_size": 64, "eos_id": 1, "bos_id": 2, "unk_id": 3}
SPEECH_META = {"vocab_size": 24, "eos_id": 1, "bos_id": 2, "unk_id": 3}
SRC_AUDIO = {"audio_feature_dim": 16, "audio_feature_channels": 1}
TOL = 1e-5
SPEC_YML = os.path.join(REPO, "examples", "speculative_decoding",
                        "example_configs")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _max_diff(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _until_eos(ids, limit=None, eos=META["eos_id"]):
    """Each row up to its first EOS (inclusive), within ``limit`` ids."""
    out = []
    for row in _np(ids).tolist():
        row = row[:limit]
        out.append(tuple(row[:row.index(eos) + 1] if eos in row else row))
    return out


def _pair(cfg, src_meta, trg_meta, seed, scale=0.5, **kwargs):
    """(JAX model, params, port model): seeded weights of ``scale`` x a
    normal draw, so that a decode does not just repeat its input."""
    jm = jax_build(cfg, src_meta=src_meta, trg_meta=trg_meta, **kwargs)
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda x: (scale * rng.randn(*x.shape)).astype(np.float32),
        jm.init_params(jax.random.PRNGKey(seed)))
    tm = neurst_tpu_torch.build_model(cfg, src_meta=src_meta,
                                      trg_meta=trg_meta, device="cpu",
                                      **kwargs)
    load_flat_params(tm, {k: np.asarray(v)
                          for k, v in flatten_params(params).items()})
    return jm, params, tm


def _text_cfg(layers, dim=16, tied=True):
    params = {"modality.dim": dim, "modality.timing": "sinusoids",
              "modality.share_embedding_and_softmax_weights": tied,
              "dtype": "float32"}
    for side in ("encoder", "decoder"):
        params.update({f"{side}.num_layers": layers,
                       f"{side}.hidden_size": dim,
                       f"{side}.num_attention_heads": 2,
                       f"{side}.filter_size": 2 * dim})
    return {"model.class": "transformer", "model.params": params}


def _speech_cfg(model_class="speech_transformer"):
    from neurst_tpu.models.speech_transformer import SpeechTransformer
    cfg = SpeechTransformer.build_model_args_by_name(
        "speech_transformer_toy")
    params = dict(cfg["model.params"], dtype="float32")
    params["encoder.enable_flash_attention"] = True
    for side in ("encoder", "decoder"):
        for rate in ("attention_dropout_rate", "ffn_dropout_rate",
                     "layer_postprocess_dropout_rate"):
            params[f"{side}.{rate}"] = 0.0
    return dict(cfg, **{"model.class": model_class, "model.params": params})


@pytest.fixture(scope="module")
def text():
    """A 2-layer target and an independently drawn 1-layer draft, with
    untied softmaxes (random tied ones mostly repeat one token)."""
    target = _pair(_text_cfg(2, tied=False), META, META, seed=1)
    draft = _pair(_text_cfg(1, tied=False), META, META, seed=9)
    rng = np.random.RandomState(0)
    lengths = np.asarray([6, 4, 5])
    src = rng.randint(4, 64, (3, 6)).astype(np.int32)
    src[np.arange(3), lengths - 1] = META["eos_id"]
    inputs = {"src": src, "src_padding": (np.arange(6)[None] >= lengths[
        :, None]).astype(np.float32)}
    return target, draft, inputs


# ----------------------------- positions ----------------------------- #

def test_sinusoid_signal_at_per_row_positions_matches_jax():
    positions = np.asarray([[3, 4, 5], [0, 1, 2], [9, 10, 11]], np.int32)
    ours = common_layers.sinusoidal_position_signal_at(
        torch.from_numpy(positions), 17)
    want = jcommon.sinusoidal_position_signal_at(jnp.asarray(positions), 17)
    assert _max_diff(ours, want) <= 1e-6
    whole = common_layers.sinusoidal_position_signal(12, 17)
    assert torch.equal(ours[0], whole[3:6])


@pytest.mark.parametrize("timing", ["sinusoids", "emb"])
def test_per_row_embedding_positions_match_jax(timing):
    module = jcommon.WordEmbedding(vocab_size=30, embedding_dim=8,
                                   timing=timing, max_positions=20)
    ids = np.random.RandomState(2).randint(0, 30, (3, 4)).astype(np.int32)
    times = np.asarray([0, 5, 11], np.int32)
    params = flax.linen.meta.unbox(module.init(jax.random.PRNGKey(3),
                                               jnp.asarray(ids)))
    want = module.apply(params, jnp.asarray(ids), time=jnp.asarray(times))
    ours = common_layers.WordEmbedding(30, 8, timing=timing,
                                       max_positions=20)
    with torch.no_grad():
        ours.weights.copy_(torch.from_numpy(np.array(
            params["params"]["weights"])))
        if timing == "emb":
            ours.position_weights.copy_(torch.from_numpy(np.array(
                params["params"]["position_weights"])))
        got = ours(torch.from_numpy(ids).long(),
                   time=torch.from_numpy(times).long())
        # row b equals the scalar-time embedding at times[b]
        for b in range(3):
            single = ours(torch.from_numpy(ids[b:b + 1]).long(),
                          time=int(times[b]))
            assert _max_diff(got[b], single[0]) <= 1e-6
    assert _max_diff(got, want) <= 1e-6


# ------------------------- multi-token steps ------------------------- #

def _models_for(kind):
    if kind == "transformer":
        return _pair(_text_cfg(2), META, META, seed=1), META
    if kind == "speech_flash":
        return _pair(_speech_cfg(), SRC_AUDIO, SPEECH_META, seed=4), \
            SPEECH_META
    if kind == "multitask_st":
        cfg = _speech_cfg("multi_task_speech_transformer")
        cfg["model.params"]["generation_output"] = "st"
        return _pair(cfg, SRC_AUDIO, SPEECH_META, seed=5,
                     asr_meta=dict(SPEECH_META, vocab_size=20)), SPEECH_META
    from neurst_tpu.models.gpt2 import GPT2
    cfg = GPT2.build_model_args_by_name("gpt2_toy")
    cfg["model.params"] = dict(cfg["model.params"], dropout_rate=0.0,
                               dtype="float32", max_positions=64)
    return _pair(cfg, None, META, seed=6), META


def _step_inputs(kind):
    rng = np.random.RandomState(7)
    if kind == "transformer":
        return {"src": rng.randint(4, 64, (3, 6)).astype(np.int32),
                "src_padding": np.zeros([3, 6], np.float32)}
    if kind == "gpt2":
        return {"trg_input": rng.randint(4, 64, (3, 5)).astype(np.int32)}
    return {"src": rng.randn(3, 32, 16, 1).astype(np.float32),
            "src_length": np.asarray([32, 20, 27], np.int32)}


@pytest.mark.parametrize("kind", ["transformer", "speech_flash",
                                  "multitask_st", "gpt2"])
def test_decode_steps_match_jax_and_single_steps(kind):
    """k tokens at staggered per-row times give the JAX model's logits;
    at times 0 they equal k single steps of the port's own decode."""
    (jm, params, tm), meta = _models_for(kind)
    inputs = _step_inputs(kind)
    rng = np.random.RandomState(8)
    ids = rng.randint(4, meta["vocab_size"], (3, 4)).astype(np.int32)
    times = np.asarray([0, 3, 6], np.int32)
    j_fn, j_init = jm.prepare_speculative(params, inputs, 12)
    want, _ = j_fn(jnp.asarray(ids), j_init["decoder_internal_cache"],
                   jnp.asarray(times))
    with torch.no_grad():
        t_fn, t_init = tm.prepare_speculative(inputs, 12)
        got, _ = t_fn(torch.from_numpy(ids).long(),
                      t_init["decoder_internal_cache"],
                      torch.from_numpy(times).long())
        assert _max_diff(got, want) <= TOL * max(1.0, float(
            np.abs(_np(want)).max()))
        _, t_init = tm.prepare_speculative(inputs, 12)
        multi, _ = t_fn(torch.from_numpy(ids).long(),
                        t_init["decoder_internal_cache"],
                        torch.zeros(3, dtype=torch.long))
        s2l, init = tm.prepare_generation(inputs, 12)
        cache = init["decoder_internal_cache"]
        for t in range(4):
            single, cache = s2l(torch.from_numpy(ids[:, t]).long(), cache, t)
            assert _max_diff(multi[:, t], single) <= 1e-5, t


def test_lightconv_decode_steps_raise():
    from neurst_tpu_torch.models.light_convolution_model import \
        LightConvolutionModel
    cfg = LightConvolutionModel.build_model_args_by_name("lightconv_toy")
    model = neurst_tpu_torch.build_model(cfg, src_meta=META, trg_meta=META,
                                         device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    with torch.no_grad():
        steps_fn, init = model.prepare_speculative(
            {"src": np.full([2, 4], 5, np.int32),
             "src_padding": np.zeros([2, 4], np.float32)}, 8)
        with pytest.raises(NotImplementedError, match="LightConv"):
            steps_fn(torch.ones((2, 3), dtype=torch.long),
                     init["decoder_internal_cache"],
                     torch.zeros(2, dtype=torch.long))


def test_waitk_lagging_with_per_row_times_raises():
    decoder = TransformerDecoder(1, 8, 2, 16)
    memory = torch.zeros((2, 5, 8))
    cache = decoder.create_decoding_internal_cache(memory, 6)
    with pytest.raises(NotImplementedError, match="wait-k"):
        decoder(torch.zeros((2, 2, 8)), memory_padding=torch.zeros((2, 5)),
                cache=cache, decode_step=torch.zeros(2, dtype=torch.long),
                decode_lagging=3)


# ----------------------------- n-gram draft --------------------------- #

@pytest.mark.parametrize("prefix", [None, [[11, 12, 13, -1],
                                           [7, 8, 7, 9]]])
def test_make_ngram_draft_matches_jax(prefix):
    seq = np.asarray([[2, 5, 6, 7, 8, 5, 6, 7, 12, 13],
                      [2, 7, 8, 7, 8, 7, 9, 9, 9, 9]], np.int32)
    p = None if prefix is None else np.asarray(prefix, np.int32)
    ours_fn, ours = speculative.make_ngram_draft(
        2, 12, 20, ngram=3, prefix=None if p is None
        else torch.from_numpy(p))
    want_fn, want = jspec.make_ngram_draft(2, 12, 20, ngram=3, prefix=p)
    ours, want = ours["decoder_internal_cache"], \
        want["decoder_internal_cache"]
    for t in range(seq.shape[1]):
        times = np.asarray([t, max(t - 1, 0)], np.int32)
        got, ours = ours_fn(torch.from_numpy(seq[:, t:t + 1]).long(), ours,
                            torch.from_numpy(times).long())
        ref, want = want_fn(jnp.asarray(seq[:, t:t + 1]), want,
                            jnp.asarray(times))
        assert _np(got).argmax(-1).tolist() == \
            np.asarray(ref).argmax(-1).tolist(), t
        assert _np(ours["buffer"]).tolist() == \
            np.asarray(want["buffer"]).tolist(), t


# --------------------------- greedy and sampling ---------------------- #

def _drafts(draft_kind, draft, batch, buffer_len, inputs):
    jd, jparams, td = draft
    if draft_kind == "ngram":
        return (speculative.make_ngram_draft(batch, buffer_len, 64),
                jspec.make_ngram_draft(batch, buffer_len, 64))
    return (td.prepare_speculative(inputs, buffer_len),
            jd.prepare_speculative(jparams, inputs, buffer_len))


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("draft_kind", ["model", "ngram"])
def test_speculative_greedy_matches_jax_and_plain_greedy(text, k,
                                                         draft_kind):
    (jt, jparams, tt), draft, inputs = text
    max_len, min_len = 14, 3
    args = dict(speculative_k=k, maximum_decode_length=max_len,
                extra_decode_length=2, minimum_decode_length=min_len,
                return_stats=True)
    with torch.no_grad():
        s2l, init = tt.prepare_generation(inputs, max_len)
        plain, plain_lp = sequence_sampling(
            s2l, init, top_k=1, maximum_decode_length=max_len,
            extra_decode_length=2, minimum_decode_length=min_len)
        t_fn, t_init = tt.prepare_speculative(inputs, max_len + k)
        (d_fn, d_init), (jd_fn, jd_init) = _drafts(
            draft_kind, draft, 3, max_len + k, inputs)
        ids, scores, stats = speculative.speculative_greedy_decode(
            t_fn, t_init, d_fn, d_init, **args)
    jt_fn, jt_init = jt.prepare_speculative(jparams, inputs, max_len + k)
    jids, jscores, jstats = jspec.speculative_greedy_decode(
        jt_fn, jt_init, jd_fn, jd_init, **args)
    assert _np(ids).tolist() == np.asarray(jids).tolist()
    assert stats["target_passes"] == int(jstats["target_passes"])
    assert _np(stats["tokens_emitted"]).tolist() == \
        np.asarray(jstats["tokens_emitted"]).tolist()
    np.testing.assert_allclose(_np(scores), np.asarray(jscores), rtol=TOL)
    # the plain loop stops at max(min(source + 2, max_len), min_len) = 8
    assert _until_eos(ids, 8) == _until_eos(plain, 8)
    np.testing.assert_allclose(_np(scores), _np(plain_lp), rtol=TOL)
    assert META["unk_id"] not in _np(ids)
    assert all(len(row) > min_len for row in _until_eos(ids))


class _Oracle(object):
    """A draft that proposes the plain greedy decode's token at each
    emission index, except where ``wrong(row, index)``; records the
    per-row times of every target pass."""

    def __init__(self, greedy, wrong):
        self.greedy, self.wrong, self.passes = greedy, wrong, []

    def draft(self, ids, cache, times):
        tokens = []
        for b, t in enumerate(times.tolist()):
            tok = self.greedy[b][min(t, len(self.greedy[b]) - 1)]
            tokens.append((tok + 1) % 64 if self.wrong(b, t) else tok)
        logits = torch.nn.functional.one_hot(
            torch.tensor(tokens), 64).float() * 1e4
        return logits[:, None, :], cache

    def target(self, steps_fn):
        def fn(ids, cache, times):
            self.passes.append(times.tolist())
            return steps_fn(ids, cache, times)
        return fn


def test_rejection_at_slot_zero_then_full_acceptance(text):
    """Row 0's first window rejects its first draft (stale keys and values
    at positions 1..k-1), the next accepts all k; the output is still the
    plain greedy decode."""
    (_, _, tt), _, inputs = text
    k, max_len = 4, 12
    with torch.no_grad():
        s2l, init = tt.prepare_generation(inputs, max_len)
        plain, _ = sequence_sampling(s2l, init, top_k=1,
                                     maximum_decode_length=max_len,
                                     extra_decode_length=max_len)
        oracle = _Oracle(_np(plain).tolist(),
                         lambda b, t: b == 0 and t == 0)
        t_fn, t_init = tt.prepare_speculative(inputs, max_len + k)
        ids, _ = speculative.speculative_greedy_decode(
            oracle.target(t_fn), t_init, oracle.draft, {
                "decoder_internal_cache": {}}, speculative_k=k,
            maximum_decode_length=max_len, extra_decode_length=max_len)
    assert _until_eos(ids) == _until_eos(plain)
    assert [times[0] for times in oracle.passes][:3] == [0, 1, 1 + k]


def test_last_window_ends_at_the_cache_end(text):
    """Caches hold maximum_decode_length + k positions: a row that reached
    the length limit keeps writing its k-window at [max_len, max_len + k)
    while another row still decodes, exactly up to the cache's end."""
    (_, _, tt), _, inputs = text
    k, max_len = 4, 8
    with torch.no_grad():
        s2l, init = tt.prepare_generation(inputs, max_len)
        plain, _ = sequence_sampling(s2l, init, top_k=1,
                                     maximum_decode_length=max_len,
                                     extra_decode_length=max_len,
                                     minimum_decode_length=max_len)
        oracle = _Oracle(_np(plain).tolist(), lambda b, t: b == 1)
        t_fn, t_init = tt.prepare_speculative(inputs, max_len + k)
        cache_len = t_init["decoder_internal_cache"]["layers"]["layer_0"][
            "self"]["keys"].shape[1]
        ids, _, stats = speculative.speculative_greedy_decode(
            oracle.target(t_fn), t_init, oracle.draft, {
                "decoder_internal_cache": {}}, speculative_k=k,
            maximum_decode_length=max_len, extra_decode_length=max_len,
            minimum_decode_length=max_len, return_stats=True)
    assert cache_len == max_len + k
    assert _np(ids).tolist() == _np(plain).tolist()
    assert _np(stats["tokens_emitted"]).tolist() == [max_len] * 3
    assert max(times[0] for times in oracle.passes) + k == cache_len


def test_speculative_sampling_total_variation(text):
    """20,000 rows of one sentence, an independent draft (rejections and
    residual draws happen), k 2: the first token's frequencies are within
    a total variation of 0.02 of the JAX target's masked softmax."""
    (jt, jparams, tt), (_, _, td), inputs = text
    rows = 20000
    one = {key: value[:1] for key, value in inputs.items()}
    many = {key: np.repeat(value, rows, axis=0)
            for key, value in one.items()}
    generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        t_fn, t_init = tt.prepare_speculative(many, 3)
        d_fn, d_init = td.prepare_speculative(many, 3)
        ids, _, stats = speculative.speculative_greedy_decode(
            t_fn, t_init, d_fn, d_init, speculative_k=2,
            maximum_decode_length=1, extra_decode_length=1, sampling=True,
            generator=generator, return_stats=True)
    s2l, init = jt.prepare_generation(jparams, one, 4)
    logits, _ = s2l(jnp.asarray([META["bos_id"]], jnp.int32),
                    init["decoder_internal_cache"], jnp.asarray(0))
    p = np.exp(np.asarray(jax.nn.log_softmax(np.asarray(logits[0]))))
    p[META["unk_id"]] = 0.0
    p /= p.sum()
    freq = np.bincount(_np(ids)[:, 0], minlength=64) / rows
    assert 0.5 * np.abs(freq - p).sum() <= 0.02
    assert stats["target_passes"] == 1
    # top-k sampling: only the target's 5 best tokens are emitted
    with torch.no_grad():
        t_fn, t_init = tt.prepare_speculative(one, 12)
        d_fn, d_init = td.prepare_speculative(one, 12)
        sampled, _ = speculative.speculative_greedy_decode(
            t_fn, t_init, d_fn, d_init, speculative_k=3,
            maximum_decode_length=9, extra_decode_length=9, sampling=True,
            top_k=5, generator=generator)
    assert sampled.shape == (1, 9) and META["unk_id"] not in _np(sampled)


# -------------------------------- beam --------------------------------- #

@pytest.mark.parametrize("k, top_k, min_len", [(1, 1, 0), (2, 1, 0),
                                               (4, 1, 0), (3, 3, 4)])
def test_speculative_beam_matches_plain_beam_and_jax(text, k, top_k,
                                                     min_len):
    (jt, jparams, tt), _, inputs = text
    beam, max_len = 3, 10
    args = dict(beam_size=beam, top_k=top_k, length_penalty=0.6,
                maximum_decode_length=max_len, extra_decode_length=max_len,
                minimum_decode_length=min_len)
    with torch.no_grad():
        s2l, init = tt.prepare_generation(inputs, max_len)
        plain, plain_scores = sequence_beam_search(s2l, init, **args)
        t_fn, t_init = tt.prepare_speculative(inputs, max_len + k)
        d_fn, d_init = speculative.make_ngram_draft(3 * beam, max_len + k,
                                                    64)
        hyp, scores, stats = speculative.speculative_beam_search(
            t_fn, t_init, d_fn, d_init, speculative_k=k, return_stats=True,
            **args)
    jt_fn, jt_init = jt.prepare_speculative(jparams, inputs, max_len + k)
    jd_fn, jd_init = jspec.make_ngram_draft(3 * beam, max_len + k, 64)
    jhyp, jscores, jstats = jspec.speculative_beam_search(
        jt_fn, jt_init, jd_fn, jd_init, speculative_k=k, return_stats=True,
        **args)
    assert _until_eos(hyp) == _until_eos(plain) == _until_eos(jhyp)
    np.testing.assert_allclose(_np(scores), _np(plain_scores), atol=TOL)
    np.testing.assert_allclose(_np(scores), np.asarray(jscores), atol=TOL)
    assert stats["target_passes"] == int(jstats["target_passes"])
    assert _np(stats["tokens_emitted"]).tolist() == \
        np.asarray(jstats["tokens_emitted"]).tolist()


# --------------------------- the search layer ------------------------- #

def test_flags_and_registered_names_match_jax():
    def flags(cls):
        return {f.name: f.default for f in cls.class_or_method_args()}
    jlayer = jax_build_search({"search_method.class": "speculative_decode"})
    assert flags(speculative.SpeculativeDecode) == flags(type(jlayer))
    for name in ("speculative_decode", "speculative", "SpeculativeDecode"):
        layer = build_search_layer({"search_method.class": name})
        assert isinstance(layer, speculative.SpeculativeDecode)
    with pytest.raises(ValueError, match="draft_model_dir"):
        layer.prepare()


@pytest.mark.parametrize("lookup_source", [False, True])
def test_ngram_layer_matches_jax_layer(text, lookup_source):
    (jt, jparams, tt), _, inputs = text
    params = {"draft_method": "ngram", "speculative_k": 3,
              "draft_lookup_source": lookup_source,
              "maximum_decode_length": 12, "extra_decode_length": 12}
    layer = build_search_layer({"search_method.class": "speculative",
                                "search_method.params": params})
    layer.set_model(tt)
    ids, scores = layer(inputs)
    jlayer = jax_build_search({"search_method.class": "speculative",
                               "search_method.params": params})
    jlayer.set_model(jt)
    jids, jscores = jlayer(jparams, {k: jnp.asarray(v)
                                     for k, v in inputs.items()})
    assert _np(ids).tolist() == np.asarray(jids).tolist()
    np.testing.assert_allclose(_np(scores), np.asarray(jscores), rtol=TOL)
    assert layer.last_stats["target_passes"] >= 1


def test_gpt2_ngram_layer_uses_the_prompt_and_equals_greedy():
    (jm, params, tm), _ = _models_for("gpt2")
    prompt = {"trg_input": np.asarray([[5, 6, 7, 5, 6], [8, 9, 10, 8, 9]],
                                      np.int32)}
    args = {"maximum_decode_length": 10, "extra_decode_length": 10}
    layer = build_search_layer({
        "search_method.class": "speculative_decode",
        "search_method.params": dict(args, draft_method="ngram",
                                     speculative_k=3)})
    layer.set_model(tm)
    ids, _ = layer(prompt)
    greedy = build_search_layer({"search_method.class": "top_sampling",
                                 "search_method.params": dict(args,
                                                              top_k=1)})
    greedy.set_model(tm)
    plain, _ = greedy(prompt)
    assert _until_eos(ids) == _until_eos(plain)
    jlayer = jax_build_search({
        "search_method.class": "speculative_decode",
        "search_method.params": dict(args, draft_method="ngram",
                                     speculative_k=3)})
    jlayer.set_model(jm)
    jids, _ = jlayer(params, {"trg_input": jnp.asarray(prompt["trg_input"])})
    assert _np(ids).tolist() == np.asarray(jids).tolist()


def test_r14_speculative_layer_ignores_beam_size(text):
    """R14: the layer declares beam_size, length_penalty and
    top_hypotheses, but decodes greedily whatever they say, in both
    packages: one hypothesis a sentence, the plain greedy decode's."""
    (jt, jparams, tt), _, inputs = text
    params = {"draft_method": "ngram", "speculative_k": 2, "beam_size": 3,
              "top_hypotheses": 2, "length_penalty": 1.0,
              "maximum_decode_length": 10, "extra_decode_length": 10}
    layer = build_search_layer({"search_method.class": "speculative",
                                "search_method.params": params})
    layer.set_model(tt)
    ids, _ = layer(inputs)
    with torch.no_grad():
        s2l, init = tt.prepare_generation(inputs, 10)
        plain, _ = sequence_sampling(s2l, init, top_k=1,
                                     maximum_decode_length=10,
                                     extra_decode_length=10)
    assert ids.shape[0] == 3 and _until_eos(ids) == _until_eos(plain)
    jlayer = jax_build_search({"search_method.class": "speculative",
                               "search_method.params": params})
    jlayer.set_model(jt)
    jids, _ = jlayer(jparams, {k: jnp.asarray(v) for k, v in inputs.items()})
    assert np.asarray(jids).shape[0] == 3
    assert _np(ids).tolist() == np.asarray(jids).tolist()


# ------------------------------ both CLIs ----------------------------- #

def _model_dir(root, name, layers, seed):
    """A model dir both packages read: model_configs.yml and ckpt-1 of
    seeded weights over the tests/examples vocabulary."""
    from neurst_tpu.tasks.task import build_task as jax_build_task
    pipeline = {"vocab_path": os.path.join(REPO, "tests", "examples",
                                           "vocab.txt")}
    cfg = _text_cfg(layers, dim=32, tied=False)
    task = jax_build_task({
        "task.class": "translation",
        "task.params": {"src_data_pipeline.class": "TextDataPipeline",
                        "src_data_pipeline.params": pipeline,
                        "trg_data_pipeline.class": "TextDataPipeline",
                        "trg_data_pipeline.params": pipeline}})
    jm = task.build_model(cfg)
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda x: (0.5 * rng.randn(*x.shape)).astype(np.float32),
        jm.init_params(jax.random.PRNGKey(seed)))
    path = os.path.join(root, name)
    jax_ckpt.save_checkpoint(path, 1, params)
    JaxModelConfigs.dump(task.model_configs(jm), path)
    return path


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spec_cli"))
    target = _model_dir(root, "target", 2, 11)
    draft = _model_dir(root, "draft", 1, 12)
    predict = os.path.join(root, "predict.json")
    with open(predict, "w") as f:
        json.dump({"entry": "predict", "batch_size": 8, "metric": "bleu",
                   "dataset.class": "parallel_text", "dataset.params": {
                       "src_file": os.path.join(REPO, "tests", "examples",
                                                "dev.src"),
                       "trg_file": os.path.join(REPO, "tests", "examples",
                                                "dev.trg")}}, f)
    searches = {
        "greedy": ["--search_method", "top_sampling",
                   "--search_method.params",
                   json.dumps({"top_k": 1, "maximum_decode_length": 24})],
        "ngram": ["--config_paths", predict + "," + os.path.join(
            SPEC_YML, "prediction_spec_ngram_args.yml"),
            "--search_method.params", json.dumps({
                "draft_method": "ngram", "draft_ngram": 3,
                "draft_lookup_source": True, "speculative_k": 4,
                "maximum_decode_length": 24})],
        "draft": ["--config_paths", predict + "," + os.path.join(
            SPEC_YML, "prediction_spec_draft_args.yml"),
            "--search_method.params", json.dumps({
                "draft_model_dir": draft, "speculative_k": 4,
                "maximum_decode_length": 24})]}
    argv = {}
    for name, extra in searches.items():
        base = [] if "--config_paths" in extra \
            else ["--config_paths", predict]
        argv[name] = base + extra + ["--model_dir", target]
    proc, log = start_jax_side(JAX_CLI_SIDE, root, "jax_predict", [
        ["predict", a + ["--output_file", os.path.join(root, f"{n}.jax")],
         os.path.join(root, f"jax_{n}.json")] for n, a in argv.items()])
    out = {"root": root}
    try:
        for name, a in argv.items():
            out[name] = port_run_exp.cli_main(
                a + ["--output_file", os.path.join(root, f"{name}.port"),
                     "--device", "cpu"])
        proc.wait(timeout=600)
    finally:
        proc.kill()
    with open(log) as f:
        assert proc.returncode == 0, f.read()[-4000:]
    for name in argv:
        with open(os.path.join(root, f"jax_{name}.json")) as f:
            out[f"jax_{name}"] = json.load(f)
    return out


@pytest.mark.parametrize("name", ["ngram", "draft"])
def test_cli_predict_through_the_committed_ymls(cli_runs, name):
    """Both CLIs decode the dev set through the committed yml layered over
    a predict config: the same hypothesis files, BLEU within 1e-6, and the
    plain greedy decode's hypotheses."""
    ours, ref = cli_runs[name], cli_runs[f"jax_{name}"]
    assert ours["samples"] == ref["samples"] == 24
    with open(os.path.join(cli_runs["root"], f"{name}.port")) as f, \
            open(os.path.join(cli_runs["root"], f"{name}.jax")) as g:
        assert f.read() == g.read()
    assert ours["hypotheses"] == cli_runs["greedy"]["hypotheses"] \
        == cli_runs["jax_greedy"]["hypotheses"]
    assert abs(ours["BLEU"] - ref["BLEU"]) <= 1e-6
    assert len(set(ours["hypotheses"])) > 1
