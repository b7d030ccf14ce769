"""Quantization of the port (``neurst_tpu_torch/layers/quantization/``)
against the JAX package's (``neurst_tpu/layers/quantization/``), on the
CPU in float32.

Held against JAX:

- ``fake_quant_minmax``: values bitwise and gradients (x and both clip
  bounds) within 1e-6 relative, exact ties at the bounds included (the
  JAX tie rule: half the gradient to each side);
- a QAT text Transformer (``transformer_32_2e_2d_4h``, untied softmax,
  so all five JAX dense sites are quantized) and a QAT
  ``speech_transformer_toy``, with small clips so that many values clip:
  logits within 1e-5 of their largest value, the loss with
  ``clip_l2_penalty`` within 1e-5 relative, every gradient (the clips'
  included) within 1e-5 of its largest value;
- ``int8ify_flat_params`` bitwise on the absmax, QAT-clip and static-act
  paths;
- the three int8 serving modes: the calibrated ``act_scale``s within
  1e-6 relative, logits within 1e-5 of their largest value (the static
  mode with the JAX scales in both), beam hypotheses identical;
- ``model_configs.yml`` under QAT written by each package and read by
  the other;
- both CLIs: ``--enable_quant`` training (10 SGD steps from one JAX
  ckpt-0: the first two losses and the step-1 checkpoint within 1e-5,
  each of the port's updates replayed from JAX's checkpoint of the step
  before against JAX's next one, the two trainers' later losses within
  1e-2, as the rounding flips of a discontinuous quantizer allow; see
  the test) and predict from
  the trained QAT dir four ways (fake quant, ``--int8_serving``, with
  ``--int8_activations``, with ``--int8_static_activations``):
  hypotheses identical (the JAX side in one subprocess).

And on the port alone: ``int8_matmul`` exact against an int64 product,
``Int8Dense``'s three modes against their formulas, the refusals.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch
import yaml

import port_test_support  # noqa: F401  (one torch thread per worker)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from neurst_tpu.criterions.criterion import \
    build_criterion as jax_build_criterion  # noqa: E402
from neurst_tpu.layers.quantization import \
    quant_layers as jql  # noqa: E402
from neurst_tpu.layers.search.sequence_search import \
    build_search_layer as jax_build_search  # noqa: E402
from neurst_tpu.models.model import build_model as jax_build  # noqa: E402
from neurst_tpu.models.speech_transformer import \
    SpeechTransformer as JaxSpeech  # noqa: E402
from neurst_tpu.models.transformer import \
    Transformer as JaxTransformer  # noqa: E402
from neurst_tpu.tasks.task import build_task as jax_build_task  # noqa: E402
from neurst_tpu.utils import checkpoints as jax_ckpt  # noqa: E402
from neurst_tpu.utils.checkpoints import flatten_params  # noqa: E402
from neurst_tpu.utils.configurable import \
    ModelConfigs as JaxModelConfigs  # noqa: E402
from neurst_tpu.utils.param_policy import \
    restore_inference_params as jax_restore  # noqa: E402

import neurst_tpu_torch  # noqa: E402
from neurst_tpu_torch.cli import run_exp as port_run_exp  # noqa: E402
from neurst_tpu_torch.criterions import build_criterion  # noqa: E402
from neurst_tpu_torch.exps import trainer as port_trainer  # noqa: E402
from neurst_tpu_torch.layers.quantization import \
    quant_layers as ql  # noqa: E402
from neurst_tpu_torch.parallel import make_train_step  # noqa: E402
from neurst_tpu_torch.tasks.task import build_task  # noqa: E402
from neurst_tpu_torch.utils import checkpoints as port_ckpt  # noqa: E402
from neurst_tpu_torch.utils.configurable import ModelConfigs  # noqa: E402
from neurst_tpu_torch.utils.param_bridge import (  # noqa: E402
    flat_to_state_dict, load_flat_params, state_dict_to_flat)
from neurst_tpu_torch.utils.param_policy import \
    restore_inference_params  # noqa: E402

from port_test_support import (JAX_CLI_SIDE, REPO,  # noqa: E402
                               TrainerLossLog, start_jax_side)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# small clips, so that many weights and activations sit on the bounds
QUANT = {"quant_strategy": "min/max", "quant_bits": 8,
         "quant_weight_clip_max": 0.2, "quant_act_clip_max": 2.0}
TEXT_META = ({"vocab_size": 40, "eos_id": 1, "bos_id": 2, "unk_id": 3},
             {"vocab_size": 48, "eos_id": 1, "bos_id": 2, "unk_id": 3})
SPEECH_META = ({"audio_feature_dim": 16, "audio_feature_channels": 1},
               {"vocab_size": 24, "eos_id": 1, "bos_id": 2, "unk_id": 3})
CRITERION = {"criterion.class": "label_smoothed_cross_entropy",
             "criterion.params": {"label_smoothing": 0.1}}
SEARCH = {"beam_size": 3, "maximum_decode_length": 8,
          "extra_decode_length": 4, "length_penalty": 0.6,
          "decode_unroll": 1, "prefix_decode_chunk": 0}
RATES = ("attention_dropout_rate", "ffn_dropout_rate",
         "layer_postprocess_dropout_rate")
TOL = 1e-5
GRAD_TOL = 1e-5
FQ_GRAD_TOL = 1e-6
SCALE_TOL = 1e-6
CKPT_TOL = 1e-5
FLIP_TOL = 1e-2
# a replayed update (the port's step from JAX's checkpoint of the step
# before): its largest error and the share of elements off by more than
# CKPT_TOL where a fake-quant level flipped in that step's forward
# (measured on 10 steps: 8 steps with no element off, max 2.4e-7; step
# 3 with 0.72% of elements off, max 1.2e-4; step 9 0.002%, 2.5e-5)
REPLAY_TOL = 1e-3
REPLAY_OFF_SHARE = 0.02
# int8 modes: three int8 settings (weight-only, dynamic, static)
MODES = {"weight_only": {}, "dynamic": {"activations": True},
         "static": {"activations": True, "static_activation_scales": True}}
MODE_FLAGS = {"weight_only": [], "dynamic": ["--int8_activations"],
              "static": ["--int8_activations", "--int8_static_activations"]}


@pytest.fixture(autouse=True)
def _quantization_off():
    """Every test leaves both packages' global configs off."""
    yield
    for lib in (jql, ql):
        lib.global_init(False)
        lib.set_int8_serving(False)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(ours, ref, tol):
    ref = np.asarray(ref)
    return float(np.abs(_np(ours) - ref).max()) <= tol * max(
        1.0, float(np.abs(ref).max()))


# ------------------------------------------------------- fake quant

def test_clip_ties_split_the_gradient_as_jnp_clip():
    """At x = [0, 1, 2], lo 0, hi 1: jnp.clip gives dx [0.5, 0.5, 0],
    dlo 0.5, dhi 1.5 (torch.clamp would give [1, 1, 0], 0 and 1), and so
    does the port's fake quant, straight through its rounding (the three
    values lie on its grid)."""
    x = torch.tensor([0.0, 1.0, 2.0], requires_grad=True)
    lo = torch.tensor(0.0, requires_grad=True)
    hi = torch.tensor(1.0, requires_grad=True)
    ql.fake_quant_minmax(x, lo, hi, 8).sum().backward()
    ref = jax.grad(lambda a, b, c: jnp.sum(jnp.clip(a, b, c)),
                   argnums=(0, 1, 2))(jnp.asarray([0.0, 1.0, 2.0]),
                                      jnp.float32(0.0), jnp.float32(1.0))
    assert x.grad.tolist() == [0.5, 0.5, 0.0] == np.asarray(ref[0]).tolist()
    assert float(lo.grad) == 0.5 == float(ref[1])
    assert float(hi.grad) == 1.5 == float(ref[2])


def _fq_case(name):
    rng = np.random.RandomState(3)
    if name == "ties":
        return np.asarray([0.0, 1.0, 2.0], np.float32), 0.0, 1.0, 8
    x = (rng.randn(257) * 1.5).astype(np.float32)
    hi = np.float32(1.0)
    lo = np.float32(-hi * 128.0 / 127.0)
    x[:7] = lo
    x[7:15] = hi
    if name == "bits4":
        return x, float(np.float32(-hi * 8.0 / 7.0)), float(hi), 4
    return x, float(lo), float(hi), 8


@pytest.mark.parametrize("case", ["ties", "symmetric", "bits4"])
def test_fake_quant_minmax_values_and_gradients(case):
    x, lo, hi, bits = _fq_case(case)
    w = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    want = np.asarray(jql.fake_quant_minmax(jnp.asarray(x), lo, hi, bits))
    grads = jax.grad(lambda a, b, c: jnp.sum(jnp.asarray(w) * (
        jql.fake_quant_minmax(a, b, c, bits))), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.float32(lo), jnp.float32(hi))
    tx = torch.tensor(x, requires_grad=True)
    tlo = torch.tensor(lo, dtype=torch.float32, requires_grad=True)
    thi = torch.tensor(hi, dtype=torch.float32, requires_grad=True)
    got = ql.fake_quant_minmax(tx, tlo, thi, bits)
    assert np.array_equal(_np(got), want)
    (torch.from_numpy(w) * got).sum().backward()
    for ours, ref in zip((tx.grad, tlo.grad, thi.grad), grads):
        np.testing.assert_allclose(_np(ours), np.asarray(ref),
                                   rtol=FQ_GRAD_TOL, atol=1e-7)


# ------------------------------------------------------- QAT models

def _text_cfg(untied=True):
    cfg = JaxTransformer.build_model_args_by_name("transformer_32_2e_2d_4h")
    params = dict(cfg["model.params"], dtype="float32")
    params["modality.share_embedding_and_softmax_weights"] = not untied
    for side in ("encoder", "decoder"):
        params.update({f"{side}.{rate}": 0.0 for rate in RATES})
    return dict(cfg, **{"model.params": params})


def _speech_cfg():
    cfg = JaxSpeech.build_model_args_by_name("speech_transformer_toy")
    params = dict(cfg["model.params"], dtype="float32")
    for side in ("encoder", "decoder"):
        params.update({f"{side}.{rate}": 0.0 for rate in RATES})
    return dict(cfg, **{"model.params": params})


def _batch(kind, rng, n=3, length=7):
    if kind == "text":
        src = rng.randint(4, 40, (n, length)).astype(np.int32)
        lengths = np.asarray([length, length - 2, 3][:n])
        out = {"src": src, "src_padding": (
            np.arange(length)[None] >= lengths[:, None]).astype(np.float32)}
        vocab = 48
    else:
        out = {"src": rng.randn(n, 24, 16, 1).astype(np.float32),
               "src_length": np.asarray([24, 17, 9][:n], np.int32)}
        vocab = 24
    trg_lengths = np.asarray([6, 4, 2][:n])
    out["trg_input"] = rng.randint(0, vocab, (n, 6)).astype(np.int32)
    out["trg"] = rng.randint(0, vocab, (n, 6)).astype(np.int32)
    out["trg_padding"] = (np.arange(6)[None] >= trg_lengths[:, None]
                          ).astype(np.float32)
    return out


def _build(kind, cfg=None):
    """(JAX model, port model) of ``kind`` under the current global
    configs (which both packages must hold alike)."""
    cfg = cfg or (_text_cfg() if kind == "text" else _speech_cfg())
    src_meta, trg_meta = TEXT_META if kind == "text" else SPEECH_META
    jm = jax_build(cfg, src_meta=src_meta, trg_meta=trg_meta)
    tm = neurst_tpu_torch.build_model(cfg, src_meta=src_meta,
                                      trg_meta=trg_meta, device="cpu")
    return jm, tm


def _both_quant(on):
    jql.global_init(on, **QUANT)
    ql.global_init(on, **QUANT)


@pytest.fixture(scope="module")
def qat_flat():
    """The JAX initializers' QAT weights of both models (clips at their
    init values, then moved apart so that no two are alike)."""
    _both_quant(True)
    out = {}
    try:
        for kind in ("text", "speech"):
            jm, _ = _build(kind)
            flat = {k: np.asarray(v) for k, v in flatten_params(
                jax.jit(jm.init_params)(jax.random.PRNGKey(0))).items()}
            rng = np.random.RandomState(7)
            for name in sorted(flat):
                if name.endswith("_clip_max"):
                    flat[name] = np.float32(flat[name]
                                            * rng.uniform(0.5, 1.5))
            out[kind] = flat
    finally:
        _both_quant(False)
    return out


@pytest.mark.parametrize("kind", ["text", "speech"])
def test_qat_model_logits_loss_and_gradients(qat_flat, kind):
    _both_quant(True)
    jm, tm = _build(kind)
    flat = qat_flat[kind]
    params = jax_ckpt.unflatten_params(flat)
    load_flat_params(tm, flat)
    assert not tm.supports_fused_softmax_ce()
    assert jm.supports_fused_softmax_ce() is False
    batch = _batch(kind, np.random.RandomState(1))
    with torch.no_grad():
        logits = tm(batch)
    assert _close(logits, jax.jit(jm.call)(params, batch), TOL)

    crit = jax_build_criterion(CRITERION)

    def loss_fn(p):
        out, aux = jm.call_train(p, batch, rngs={})
        return crit.reduce_loss(batch, out) + aux + jql.clip_l2_penalty(p)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    step = make_train_step(tm, build_criterion(CRITERION), None,
                           extra_loss_fn=ql.clip_l2_penalty)
    ours, _, tgrads = step.compute_grads(dict(tm.named_parameters()), batch)
    assert abs(float(ours) - float(loss)) <= TOL * abs(float(loss))
    want = flat_to_state_dict({k: np.asarray(v) for k, v in
                               flatten_params(grads).items()}, tm)
    clips = [n for n in want if n.endswith("_clip_max")]
    assert len(clips) == len([n for n in flat if n.endswith("_clip_max")])
    assert any(float(want[n]) != 0.0 for n in clips)
    for name, ref in want.items():
        assert _close(tgrads[name], ref.numpy(), GRAD_TOL), name


def test_clip_l2_penalty_matches_jax(qat_flat):
    flat = qat_flat["text"]
    ref = float(jql.clip_l2_penalty(jax_ckpt.unflatten_params(flat)))
    _both_quant(True)
    _, tm = _build("text")
    load_flat_params(tm, flat)
    ours = float(ql.clip_l2_penalty(dict(tm.named_parameters())).detach())
    assert abs(ours - ref) <= 1e-6 * ref


# ----------------------------------------------------- int8 serving

def _set_int8(mode, qat_bits=8):
    for lib in (jql, ql):
        lib.set_int8_serving(True, qat_bits=qat_bits, **MODES[mode])


def _float_flat():
    """Plain float32 weights of the untied text model."""
    jm, _ = _build("text")
    return {k: np.asarray(v) for k, v in flatten_params(
        jax.jit(jm.init_params)(jax.random.PRNGKey(2))).items()}


def _int8_pair(mode, flat, kind="text"):
    _set_int8(mode)
    jm, tm = _build(kind)
    template = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    params, _ = jax_restore(jm, template, dict(flat))
    restore_inference_params(tm, dict(flat))
    return jm, params, tm


@pytest.mark.parametrize("source", ["absmax", "qat_clip", "static_act"])
def test_int8ify_flat_params_bitwise(qat_flat, source):
    flat = qat_flat["text"] if source != "absmax" else _float_flat()
    _set_int8("static" if source == "static_act" else "weight_only")
    jm, tm = _build("text")
    jtemplate = {k: np.asarray(v) for k, v in flatten_params(
        jax.jit(jm.init_params)(jax.random.PRNGKey(0))).items()}
    ref = jql.int8ify_flat_params(dict(flat), jtemplate)
    ref_paths = set(jql._INT8_SERVING["qat_act_paths"])
    template = state_dict_to_flat(tm)
    ours = ql.int8ify_flat_params(dict(flat), template)
    assert sorted(ours) == sorted(ref)
    for name in ref:
        assert ours[name].dtype == np.asarray(ref[name]).dtype, name
        assert np.array_equal(ours[name], ref[name]), name
    assert {n[:-len("/act_scale")] for n in ql.qat_act_scale_names(
        flat, template)} == ref_paths
    if source == "static_act":
        assert ref_paths and all(p.endswith("ffn/dense2") for p in
                                 ref_paths)
    assert any(n.endswith("/weights_q") for n in ref)


@pytest.mark.parametrize("mode", list(MODES))
def test_int8_serving_logits_scales_and_beams(mode):
    flat = _float_flat()
    jm, params, tm = _int8_pair(mode, flat)
    rng = np.random.RandomState(4)
    batches = [_batch("text", rng) for _ in range(2)]
    if mode == "static":
        params = jql.calibrate_int8_act_scales(jm, params, batches)
        ql.calibrate_int8_act_scales(tm, batches)
        jscales = {k: np.asarray(v) for k, v in flatten_params(
            params).items() if k.endswith("/act_scale")}
        ours = {k: v for k, v in state_dict_to_flat(tm).items()
                if k.endswith("/act_scale")}
        assert sorted(ours) == sorted(jscales) and len(ours) == 23
        for name, ref in jscales.items():
            np.testing.assert_allclose(ours[name], ref, rtol=SCALE_TOL)
        # the logits and decodes below read the same scales in both
        load_flat_params(tm, dict(state_dict_to_flat(tm), **jscales))
    assert tm.trg_modality.int8 and not tm.supports_fused_softmax_ce()
    for batch in batches:
        with torch.no_grad():
            logits = tm(batch)
        assert _close(logits, jax.jit(jm.call)(params, batch), TOL)
    jsearch = jax_build_search({"search_method.class": "beam_search",
                                "search_method.params": SEARCH})
    jsearch.set_model(jm)
    src = {k: batches[0][k] for k in ("src", "src_padding")}
    jh, _ = jsearch(params, src)
    tsearch = neurst_tpu_torch.build_search_layer(
        {"search_method.class": "beam_search",
         "search_method.params": SEARCH})
    tsearch.set_model(tm)
    th, _ = tsearch(src)
    assert _np(th).tolist() == np.asarray(jh).tolist()


def test_int8_speech_serving_of_a_qat_checkpoint(qat_flat):
    """A QAT speech checkpoint served in int8 (dynamic activations): the
    learned clips drive the grid; logits as JAX's."""
    jm, params, tm = _int8_pair("dynamic", qat_flat["speech"], "speech")
    batch = _batch("speech", np.random.RandomState(6))
    with torch.no_grad():
        logits = tm(batch)
    assert _close(logits, jax.jit(jm.call)(params, batch), TOL)
    assert tm.encoder.layer_0.ffn.dense1.kernel_q.dtype == torch.int8


def test_int8_matmul_is_exact():
    rng = np.random.RandomState(8)
    a = rng.randint(-127, 128, (37, 264)).astype(np.int8)
    w = rng.randint(-128, 128, (24, 264)).astype(np.int8)
    got = ql.int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32
    assert np.array_equal(_np(got), a.astype(np.int64) @ w.astype(
        np.int64).T)


@pytest.mark.parametrize("mode", list(MODES))
def test_int8_dense_modes_follow_their_formulas(mode):
    ql.set_int8_serving(True, **MODES[mode])
    rng = np.random.RandomState(9)
    dense = ql.Int8Dense(16, 8)
    with torch.no_grad():
        dense.kernel_q.copy_(torch.from_numpy(
            rng.randint(-127, 128, (8, 16)).astype(np.int8)))
        dense.kernel_scale.copy_(torch.from_numpy(
            rng.uniform(0.01, 0.02, 8).astype(np.float32)))
        dense.bias.copy_(torch.from_numpy(rng.randn(8).astype(np.float32)))
        if dense.act_scale is not None:
            dense.act_scale.fill_(0.05)
    x = torch.from_numpy(rng.randn(2, 3, 16).astype(np.float32))
    q = dense.kernel_q.double()
    scale = dense.kernel_scale.double()
    if mode == "weight_only":
        want = (x.double() @ q.t()) * scale
    else:
        s = torch.full((2, 3, 1), 0.05, dtype=torch.float64) \
            if mode == "static" else \
            x.abs().amax(-1, keepdim=True).double() / 127.0
        xq = torch.clamp(torch.round(x.double() / s), -127, 127)
        want = (xq @ q.t()) * s * scale
    got = dense(x, torch.float32)
    np.testing.assert_allclose(_np(got), _np(want + dense.bias.double()),
                               rtol=1e-5, atol=1e-5)


def test_int8_serving_refuses_an_active_qat_config():
    ql.global_init(True, **QUANT)
    with pytest.raises(ValueError, match="global_init"):
        ql.set_int8_serving(True)
    ql.global_init(False)
    with pytest.raises(ValueError, match="static_activation_scales"):
        ql.calibrate_int8_act_scales(torch.nn.Linear(2, 2), [])


def test_speculative_draft_refuses_static_int8(tmp_path):
    """The draft restores outside the generator's calibration, so static
    int8 scales are refused for it, as in the JAX layer."""
    ql.set_int8_serving(True, **MODES["static"])
    search = neurst_tpu_torch.build_search_layer({
        "search_method.class": "speculative_decode",
        "search_method.params": {"draft_model_dir": str(tmp_path)}})
    with pytest.raises(NotImplementedError, match="int8_static"):
        search.prepare()
    ql.set_int8_serving(True, **MODES["dynamic"])
    with pytest.raises(FileNotFoundError):
        search.prepare()


# ---------------------------------------------------- model configs

def _text_task_cfg():
    vocab = os.path.join(REPO, "tests", "examples", "vocab.txt")
    pipeline = {"vocab_path": vocab}
    return {"task.class": "translation", "task.params": {
        "src_data_pipeline.class": "TextDataPipeline",
        "src_data_pipeline.params": pipeline,
        "trg_data_pipeline.class": "TextDataPipeline",
        "trg_data_pipeline.params": pipeline}}


def test_model_configs_carry_qat_both_ways(tmp_path):
    cfg = dict(_text_task_cfg(), **_text_cfg())
    _both_quant(True)
    jtask, ttask = jax_build_task(cfg), build_task(cfg)
    jmodel = jtask.build_model(cfg)
    tmodel = ttask.build_model(cfg, device="cpu")
    jcfg, tcfg = jtask.model_configs(jmodel), ttask.model_configs(tmodel)
    assert tcfg["enable_quant"] is True is jcfg["enable_quant"]
    assert tcfg["quant_params"] == jcfg["quant_params"]
    JaxModelConfigs.dump(jcfg, str(tmp_path / "jax"))
    ModelConfigs.dump(tcfg, str(tmp_path / "port"))
    _both_quant(False)
    # the port reads the JAX dir's configs and rebuilds QAT layers
    args = port_run_exp.parse_and_merge(
        ["--entry", "predict", "--model_dir", str(tmp_path / "jax")])
    port_run_exp._set_quantization(args)
    assert ql.quant_enabled()
    assert ql.get_global_config() == dict(QUANT, enable_quant=True)
    # and the JAX package reads the port's
    loaded = JaxModelConfigs.load(str(tmp_path / "port"))
    assert loaded["enable_quant"] is True
    assert loaded["quant_params"] == jcfg["quant_params"]


# ------------------------------------------------------- both CLIs

CLI_STEPS = 10
CLI_LR = 0.5


def _cli_config(root):
    with open(os.path.join(REPO, "tests", "examples",
                           "example_train_seq2seq.yml")) as f:
        cfg = yaml.safe_load(f)
    text = json.dumps(cfg).replace('"tests/examples/',
                                   f'"{REPO}/tests/examples/')
    cfg = json.loads(text)
    cfg["task.params"]["shuffle_buffer"] = 0
    cfg["entry.class"] = "trainer"
    cfg["enable_quant"] = True
    cfg["quant_params"] = json.dumps(QUANT)
    # plain SGD, so that the step-1 checkpoints compare tightly (Adam
    # scales the attention key biases' gradients, rounding noise in both
    # packages, up to full steps); a checkpoint every step
    cfg["entry.params"].update(
        train_steps=CLI_STEPS, save_checkpoint_steps=1,
        checkpoints_max_to_keep=CLI_STEPS + 1,
        summary_steps=1, enable_tensorboard=False,
        **{"optimizer.class": "sgd", "optimizer.params": {},
           "lr_schedule.class": "constant",
           "lr_schedule.params": {"learning_rate": CLI_LR}})
    path = os.path.join(root, "qat.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path, cfg


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("qat_cli"))
    cfg_path, cfg = _cli_config(root)
    dirs = {side: os.path.join(root, side) for side in ("jax", "port")}
    train = ["--entry", "train", "--config_paths", cfg_path]
    predict_base = [
        "--entry", "predict", "--model_dir", dirs["port"],
        "--config_paths", os.path.join(REPO, "tests", "examples",
                                       "example_predict_seq2seq.yml"),
        "--dataset.params", json.dumps({
            "src_file": f"{REPO}/tests/examples/dev.src",
            "trg_file": f"{REPO}/tests/examples/dev.trg"}),
        "--batch_size", "32"]
    predicts = {"fake_quant": predict_base}
    for mode, flags in MODE_FLAGS.items():
        predicts[mode] = predict_base + ["--int8_serving"] + flags
    seeded = os.path.join(root, "seeded")
    ready = os.path.join(root, "port_trained")
    ops = [["wait", seeded, None],
           ["train", train + ["--model_dir", dirs["jax"]],
            os.path.join(root, "jax_train.json")],
           ["wait", ready, None]]
    for name, argv in predicts.items():
        ops.append(["predict", argv + ["--output_file",
                                       os.path.join(root, f"{name}.jax")],
                    os.path.join(root, f"jax_{name}.json")])
    proc, log_path = start_jax_side(JAX_CLI_SIDE, root, "jax_side", ops)
    out = {"root": root, "dirs": dirs, "port": {}}
    steps = []

    def recording_step(model, criterion, tx, **kwargs):
        # the port trainer's step, keeping what each call was given
        step = make_train_step(model, criterion, tx, **kwargs)

        def train_step(state, batch, key=None):
            steps.append({"batch": {k: v.clone() for k, v in batch.items()},
                          "key": key})
            return step(state, batch, key)
        steps.append({"model": model, "tx": tx, "step": step})
        return train_step
    try:
        jql.global_init(True, **QUANT)
        jtask = jax_build_task(cfg)
        jmodel = jtask.build_model({"model.class": cfg["model.class"],
                                    "model.params": cfg["model.params"]})
        seed_dir = os.path.join(root, "seed")
        jax_ckpt.save_checkpoint(seed_dir, 0, jax.tree_util.tree_map(
            np.asarray, jax.jit(jmodel.init_params)(jax.random.PRNGKey(1))))
        jql.global_init(False)
        for d in dirs.values():
            shutil.copytree(seed_dir, d)
        open(seeded, "w").close()
        log = TrainerLossLog()
        trainer_logging, port_trainer.logging = port_trainer.logging, log
        port_trainer.make_train_step = recording_step
        try:
            port_run_exp.cli_main(train + ["--model_dir", dirs["port"],
                                           "--device", "cpu"])
        finally:
            port_trainer.logging = trainer_logging
            port_trainer.make_train_step = make_train_step
        out["port"]["train"] = log.losses
        out["replay"] = _replay_updates(root, dirs["jax"], steps, proc)
        open(ready, "w").close()
        for name, argv in predicts.items():
            out["port"][name] = port_run_exp.cli_main(
                argv + ["--output_file", os.path.join(root, f"{name}.port"),
                        "--device", "cpu"])
        proc.wait(timeout=900)
    finally:
        proc.kill()
        ql.global_init(False)
        ql.set_int8_serving(False)
    with open(log_path) as f:
        assert proc.returncode == 0, f.read()[-4000:]
    out["jax"] = {}
    for name in ["train", *predicts]:
        with open(os.path.join(root, f"jax_{name}.json")) as f:
            out["jax"][name] = json.load(f)
    return out


def _replay_updates(root, jax_dir, steps, proc):
    """Each of the port trainer's updates again, from the JAX trainer's
    checkpoint of the step before, on the batch and key the port trainer
    gave that step: per step, the largest error of the updated
    parameters (clips included) against JAX's checkpoint of that step,
    relative to each tensor's largest |value| (at least 1), and the
    share of elements off by more than ``CKPT_TOL``."""
    from neurst_tpu_torch.parallel import TrainState
    done = os.path.join(root, "jax_train.json")
    while not os.path.exists(done) and proc.poll() is None:
        time.sleep(0.05)
    built, calls = steps[0], steps[1:]
    model, step = built["model"], built["step"]
    readings = []
    for k, call in enumerate(calls, start=1):
        load_flat_params(model, jax_ckpt.restore_checkpoint_params(
            os.path.join(jax_dir, f"ckpt-{k - 1}.npz")))
        state = TrainState.create(dict(model.named_parameters()),
                                  built["tx"])
        state, _ = step(state, call["batch"], call["key"])
        ours = state_dict_to_flat(model)
        want = jax_ckpt.restore_checkpoint_params(
            os.path.join(jax_dir, f"ckpt-{k}.npz"))
        assert sorted(ours) == sorted(want)
        worst, off, n = 0.0, 0, 0
        for name, ref in want.items():
            ref = np.asarray(ref, np.float64)
            err = np.abs(np.asarray(ours[name], np.float64) - ref) / max(
                1.0, float(np.abs(ref).max()))
            worst = max(worst, float(err.max()))
            off += int((err > CKPT_TOL).sum())
            n += err.size
        readings.append({"step": k, "max_err": worst, "off_share": off / n})
    return readings


def _ckpts(cli, step):
    return (port_ckpt.restore_checkpoint_params(os.path.join(
        cli["dirs"]["port"], f"ckpt-{step}.npz")),
        jax_ckpt.restore_checkpoint_params(os.path.join(
            cli["dirs"]["jax"], f"ckpt-{step}.npz")))


def test_qat_cli_training_matches_jax(cli):
    """The first two losses (the second read after one update) and the
    step-1 checkpoint, clips included, within 1e-5; every update held
    alone: the port's step from JAX's checkpoint of the step before, on
    the batch the port trainer took, against JAX's checkpoint of that
    step (``_replay_updates``): in at least half the steps every element
    within 1e-5 (a missing or wrong term of the update, the clips' L2
    term included, would be off at every step), in all within
    ``REPLAY_TOL`` with at most ``REPLAY_OFF_SHARE`` of the elements
    off.  The two trainers' own later losses drift apart (within 1e-2
    relative, measured 1.4e-3 at worst): from the first update on the
    packages' parameters differ by rounding (~1e-7 relative), and fake
    quant is discontinuous: a weight, or an activation, within that
    distance of a rounding boundary of its grid lands on the next level
    in one package, and each flip moves the later steps."""
    port, ref = cli["port"]["train"], cli["jax"]["train"]
    assert len(port) == len(ref) == CLI_STEPS
    np.testing.assert_allclose(port[:2], ref[:2], rtol=TOL)
    np.testing.assert_allclose(port, ref, rtol=FLIP_TOL)
    replay = cli["replay"]
    assert [r["step"] for r in replay] == list(range(1, CLI_STEPS + 1))
    assert all(r["max_err"] <= REPLAY_TOL
               and r["off_share"] <= REPLAY_OFF_SHARE for r in replay), \
        replay
    assert sum(r["off_share"] == 0.0 for r in replay) >= CLI_STEPS // 2, \
        replay
    ours, want = _ckpts(cli, 1)
    seed = jax_ckpt.restore_checkpoint_params(os.path.join(
        cli["dirs"]["jax"], "ckpt-0.npz"))
    assert sorted(ours) == sorted(want) == sorted(seed)
    clips = [n for n in want if n.endswith("_clip_max")]
    assert clips and all(want[n] != seed[n] for n in clips)
    for name in want:
        assert _close(ours[name], want[name], CKPT_TOL), name
    ours, want = _ckpts(cli, CLI_STEPS)
    assert sorted(ours) == sorted(want)
    assert all(np.any(ours[n] != seed[n]) for n in clips)
    with open(os.path.join(cli["dirs"]["port"], "model_configs.yml")) as f:
        written = yaml.safe_load(f)
    assert written["enable_quant"] is True
    assert written["quant_params"]["quant_weight_clip_max"] == 0.2


@pytest.mark.parametrize("name", ["fake_quant", *MODES])
def test_qat_cli_predict_matches_jax(cli, name):
    ours, ref = cli["port"][name], cli["jax"][name]
    assert ours["samples"] == ref["samples"] == 24
    assert ours["hypotheses"] == ref["hypotheses"]
    with open(os.path.join(cli["root"], f"{name}.port")) as f, \
            open(os.path.join(cli["root"], f"{name}.jax")) as g:
        assert f.read() == g.read()


def test_int8_serving_refused_for_the_trainer(cli):
    cfg_path = os.path.join(cli["root"], "qat.json")
    with pytest.raises(ValueError, match="inference-only"):
        port_run_exp.cli_main(["--entry", "train", "--config_paths",
                               cfg_path, "--model_dir",
                               os.path.join(cli["root"], "refused"),
                               "--int8_serving", "--device", "cpu"])
