"""The port's SpeechTransformer against ``neurst_tpu``'s, end to end.

``speech_transformer_toy`` with encoder flash attention on (the slice's
configuration; the JAX side runs the Pallas kernel in interpret mode),
float32, one set of numpy-drawn weights carried into the port through
``utils/param_bridge``: encoder output, teacher-forcing logits and
decode-step logits within 1e-4; the full ``BeamSearch`` hypotheses
identical up to the first EOS and scores within 1e-4, against the JAX
decode with ``decode_unroll=1`` and ``prefix_decode_chunk=0``; and the
reference golden logits of ``speech_transformer_toy.npz`` through the
port's own converter and the bridge.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import neurst_tpu_torch  # noqa: E402
from neurst_tpu.layers.search.sequence_search import \
    build_search_layer as jax_build_search  # noqa: E402
from neurst_tpu.models.model import build_model as jax_build  # noqa: E402
from neurst_tpu.models.speech_transformer import \
    SpeechTransformer as JaxSpeechTransformer  # noqa: E402
from neurst_tpu.utils.checkpoints import flatten_params  # noqa: E402
from neurst_tpu_torch.utils.param_bridge import \
    load_flat_params  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "reference_goldens", "speech_transformer_toy.npz")
TOL = 1e-4
VOCAB = 24
TRG_META = {"vocab_size": VOCAB, "eos_id": 1, "bos_id": 2, "unk_id": 3}
SRC_META = {"audio_feature_dim": 16, "audio_feature_channels": 1}
SEARCH = {"beam_size": 4, "maximum_decode_length": 10,
          "extra_decode_length": 4, "length_penalty": 0.6}


def _config():
    cfg = JaxSpeechTransformer.build_model_args_by_name(
        "speech_transformer_toy")
    params = dict(cfg["model.params"], dtype="float32")
    params["encoder.enable_flash_attention"] = True
    return dict(cfg, **{"model.params": params})


@pytest.fixture(scope="module")
def pair():
    cfg = _config()
    jm = jax_build(cfg, src_meta=SRC_META, trg_meta=TRG_META)
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda x: (0.5 * rng.randn(*x.shape)).astype(np.float32),
        jm.init_params(jax.random.PRNGKey(0)))
    # a large EOS bias so some beams finish inside the decode window
    params["target_symbol_modality"]["bias"][TRG_META["eos_id"]] += 2.0
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    tm = neurst_tpu_torch.build_model(cfg, src_meta=SRC_META,
                                      trg_meta=TRG_META, device="cpu")
    load_flat_params(tm, flat)
    inputs = {
        "src": rng.randn(3, 29, 16, 1).astype(np.float32),
        "src_length": np.asarray([29, 17, 6], np.int32),
        "trg_input": rng.randint(0, VOCAB, (3, 5)).astype(np.int32)}
    return jm, params, tm, inputs


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _max_diff(a, b):
    return float(np.abs(_np(a).astype(np.float32)
                        - _np(b).astype(np.float32)).max())


def test_encoder_output(pair):
    jm, params, tm, inputs = pair
    enc, pad = jm._module.apply({"params": params}, inputs=inputs,
                                method=jm._module.encode)
    with torch.no_grad():
        tenc, tpad = tm.encode(inputs)
    assert _max_diff(tpad, pad) == 0.0
    assert _max_diff(tenc, enc) <= TOL


def test_teacher_forcing_logits(pair):
    jm, params, tm, inputs = pair
    with torch.no_grad():
        ours = tm(inputs)
    assert _max_diff(ours, jm.call(params, inputs)) <= TOL


def test_decode_step_logits(pair):
    """Three stepwise decode steps through prepare_generation."""
    jm, params, tm, inputs = pair
    s2l, init = jm.prepare_generation(params, inputs,
                                      decode_padded_length=6)
    with torch.no_grad():
        ts2l, tinit = tm.prepare_generation(inputs, decode_padded_length=6)
    assert tinit["encoder_inputs_maxlen"] == int(
        init["encoder_inputs_maxlen"])
    ids = np.array(init["decoder_input"])
    cache, tcache = init["decoder_internal_cache"], \
        tinit["decoder_internal_cache"]
    for t in range(3):
        logits, cache = s2l(jnp.asarray(ids), cache, t)
        with torch.no_grad():
            tlogits, tcache = ts2l(torch.from_numpy(ids).long(), tcache, t)
        assert _max_diff(tlogits, logits) <= TOL
        ids = np.asarray(logits).argmax(-1).astype(np.int32)


def _until_eos(row, eos):
    row = list(row)
    return row[:row.index(eos) + 1] if eos in row else row


@pytest.mark.parametrize("minimum_decode_length", [0, 4])
def test_beam_search_hypotheses(pair, minimum_decode_length):
    jm, params, tm, inputs = pair
    args = dict(SEARCH, minimum_decode_length=minimum_decode_length,
                decode_unroll=1, prefix_decode_chunk=0)
    src = {k: v for k, v in inputs.items() if k != "trg_input"}
    jsearch = jax_build_search({"search_method.class": "beam_search",
                                "search_method.params": args})
    jsearch.set_model(jm)
    jh, js = jsearch(params, src)
    tsearch = neurst_tpu_torch.build_search_layer(
        {"search_method.class": "beam_search",
         "search_method.params": args})
    tsearch.set_model(tm)
    th, ts = tsearch(src)
    assert th.shape == tuple(jh.shape)
    eos = TRG_META["eos_id"]
    for ours, ref in zip(_np(th), _np(jh)):
        assert _until_eos(ours, eos) == _until_eos(ref, eos)
    assert _max_diff(ts, js) <= TOL
    if minimum_decode_length == 0:
        # the decode window is long enough for the EOS bias to end beams
        assert any(eos in row for row in _np(th))


def test_beam_search_without_cache_indirection(pair):
    """The physical per-step reorder gives the same hypotheses."""
    _, _, tm, inputs = pair
    src = {k: v for k, v in inputs.items() if k != "trg_input"}
    outs = []
    for indirection in (True, False):
        search = neurst_tpu_torch.build_search_layer(
            {"search_method.class": "beam_search",
             "search_method.params": dict(SEARCH,
                                          cache_indirection=indirection)})
        search.set_model(tm)
        outs.append(search(src))
    assert torch.equal(outs[0][0], outs[1][0])
    assert _max_diff(outs[0][1], outs[1][1]) <= 1e-6


def test_reference_golden_logits():
    """Reference (TF) weights -> the port's own converter -> param_bridge
    -> port logits equal the golden reference logits."""
    from neurst_tpu_torch.utils.converters.neurst_transformer import \
        map_reference_variables
    with np.load(GOLDEN) as d:
        blob = {k: d[k] for k in d.files}
    meta = json.loads(bytes(blob.pop("__meta__")).decode())
    inputs = {k.split("/", 1)[1]: v for k, v in blob.items()
              if k.startswith("__input__/")}
    ref_logits = blob.pop("__output__/logits")
    weights = {k: v for k, v in blob.items() if not k.startswith("__")}
    cfg = dict(meta["model_params"], dtype="float32")
    flat = map_reference_variables(
        weights, num_heads=cfg["encoder.num_attention_heads"])
    tm = neurst_tpu_torch.build_model(
        {"model.class": "speech_transformer", "model.params": cfg},
        src_meta=meta["src_meta"], trg_meta=meta["trg_meta"], device="cpu")
    load_flat_params(tm, {k: np.asarray(v) for k, v in flat.items()})
    with torch.no_grad():
        ours = tm({"src": inputs["src"].astype(np.float32),
                   "src_length": inputs["src_length"].astype(np.int64),
                   "trg_input": inputs["trg_input"].astype(np.int64)})
    assert _max_diff(ours, ref_logits) < 5e-5
