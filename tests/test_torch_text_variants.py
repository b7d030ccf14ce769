"""The text Transformer's variants in the port against the JAX package's:
every FFN activation, the learned position table (``timing: emb``) and
the untied output projection.

One set of weights per case comes from the JAX initializers (or, for the
layers, numpy), carried into the port through ``utils/param_bridge``;
both packages run the same numpy-seeded inputs in float32
(``jax_default_matmul_precision=float32`` from conftest; TF32 off).

Tolerances: layer outputs 1e-5 absolute; logits and loss 1e-5 relative
(logits relative to their largest |value|); every gradient within 1e-4
of its largest |value|; decode-step logits as the logits.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402

import neurst_tpu_torch  # noqa: E402
from neurst_tpu.criterions.label_smoothed_cross_entropy import \
    LabelSmoothedCrossEntropy as JaxCriterion  # noqa: E402
from neurst_tpu.layers import common_layers as jcl  # noqa: E402
from neurst_tpu.models.model import build_model as jax_build  # noqa: E402
from neurst_tpu.utils.checkpoints import flatten_params  # noqa: E402
from neurst_tpu_torch.layers import common_layers as tcl  # noqa: E402
from neurst_tpu_torch.ops import fused_ffn as port_ffn  # noqa: E402
from neurst_tpu_torch.optimizers.optimizers import \
    create_optax_chain  # noqa: E402
from neurst_tpu_torch.parallel import make_train_step  # noqa: E402
from neurst_tpu_torch.utils.param_bridge import (  # noqa: E402
    flat_to_state_dict, load_flat_params)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5
GRAD_TOL = 1e-4
ACTIVATIONS = ["relu", "gelu", "gelu_approx", "swish", "silu", "tanh",
               "linear", None]
META = {"vocab_size": 256, "eos_id": 1, "bos_id": 2, "unk_id": 3}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _max_diff(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _init(module, rng, *args, **kwargs):
    variables = module.init(jax.random.PRNGKey(0), *args, **kwargs)
    params = fnn.meta.unbox(variables["params"])
    return jax.tree_util.tree_map(
        lambda x: (0.3 * rng.randn(*x.shape)).astype(np.float32), params)


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(params).items()}


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activation_by_name_matches_jax(name):
    x = np.linspace(-6.0, 6.0, 1201, dtype=np.float32)
    ours = tcl.activation_by_name(name)(torch.from_numpy(x))
    assert _max_diff(ours, jcl.activation_by_name(name)(x)) <= 1e-6


def test_unknown_activation_raises():
    with pytest.raises(KeyError):
        tcl.TransformerFFN(16, 24, 16, activation="softsign")


@pytest.mark.parametrize("name", ACTIVATIONS[:-1])
def test_ffn_with_each_activation_matches_jax(name):
    rng = np.random.RandomState(3)
    x = rng.randn(3, 5, 16).astype(np.float32)
    jm = jcl.TransformerFFN(filter_size=24, output_size=16, activation=name)
    params = _init(jm, rng, x)
    tm = load_flat_params(tcl.TransformerFFN(16, 24, 16, activation=name),
                          _flat(params)).eval()
    with torch.no_grad():
        ours = tm(torch.from_numpy(x), is_training=True)
    assert _max_diff(ours, jm.apply({"params": params}, x,
                                    is_training=True)) <= TOL


def test_fused_ffn_gate_keeps_other_activations_on_their_formula():
    """At rows where the fused (relu-only) kernels take a relu FFN, a
    gelu FFN stays on its composite: the layer hands the gate its own
    activation.  D 256, F 256, 16384 training rows (the D 256 ``train``
    gate), dropout 0."""
    rows, d, f = 16384, 256, 256
    assert port_ffn.fused_ffn_available(d, f, "relu", rows, True, 0.0)
    assert not port_ffn.fused_ffn_available(d, f, "gelu", rows, True, 0.0)
    rng = np.random.RandomState(4)
    x = rng.randn(rows // 128, 128, d).astype(np.float32)
    jm = jcl.TransformerFFN(filter_size=f, output_size=d, activation="gelu")
    params = jax.tree_util.tree_map(
        lambda a: a * np.float32(0.1), _init(jm, rng, x[:1]))
    tm = load_flat_params(tcl.TransformerFFN(d, f, d, activation="gelu"),
                          _flat(params)).eval()
    with torch.no_grad():
        ours = tm(torch.from_numpy(x), is_training=True)
    want = jm.apply({"params": params}, x, is_training=True)
    assert _max_diff(ours, want) <= TOL * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("time", [None, 0, 3, 9])
def test_learned_position_table_matches_jax(time):
    """``timing: emb``: the table's rows added unscaled, teacher forcing
    (time None) or a step at ``time``; a step past the table's end reads
    its last row, as lax.dynamic_slice clamps."""
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 40, (2, 6) if time is None else (2,)).astype(
        np.int32)
    jm = jcl.WordEmbedding(vocab_size=40, embedding_dim=16, timing="emb",
                           max_positions=8)
    params = _init(jm, rng, ids)
    assert params["position_weights"].shape == (8, 16)
    tm = load_flat_params(tcl.WordEmbedding(40, 16, timing="emb",
                                            max_positions=8),
                          _flat(params)).eval()
    with torch.no_grad():
        ours = tm(torch.from_numpy(ids), time=time)
    assert _max_diff(ours, jm.apply({"params": params}, ids,
                                    time=time)) <= 1e-6


def _model_cfg(**extra):
    params = {
        "modality.dim": 32, "modality.timing": "sinusoids",
        "modality.share_embedding_and_softmax_weights": True,
        "dtype": "float32"}
    for side in ("encoder", "decoder"):
        params.update({f"{side}.num_layers": 2, f"{side}.hidden_size": 32,
                       f"{side}.num_attention_heads": 4,
                       f"{side}.filter_size": 64})
    params.update(extra)
    return {"model.class": "transformer", "model.params": params}


def _batch(rng, batch=3, length=7):
    lengths = np.asarray([length, length - 3, 2][:batch])
    positions = np.arange(length)[None]
    return {
        "src": rng.randint(4, 256, (batch, length)).astype(np.int32),
        "src_padding": (positions >= lengths[:, None]).astype(np.float32),
        "trg_input": rng.randint(4, 256, (batch, length)).astype(np.int32),
        "trg": rng.randint(4, 256, (batch, length)).astype(np.int32),
        "trg_padding": (positions >= lengths[::-1, None]).astype(
            np.float32)}


def _both(cfg, seed=0):
    jm = jax_build(cfg, src_meta=META, trg_meta=META)
    params = jm.init_params(jax.random.PRNGKey(seed))
    tm = neurst_tpu_torch.build_model(cfg, src_meta=META, trg_meta=META,
                                      device="cpu")
    load_flat_params(tm, _flat(params))
    return jm, params, tm


def _rel_close(ours, want, tol=TOL):
    assert _max_diff(ours, want) <= tol * float(np.abs(_np(want)).max())


@pytest.mark.parametrize("extra", [
    {"modality.timing": "emb"},
    {"encoder.ffn_activation": "gelu", "decoder.ffn_activation": "swish"},
    {"modality.share_embedding_and_softmax_weights": False},
    {"modality.share_embedding_and_softmax_weights": False,
     "modality.share_source_target_embedding": True,
     "modality.timing": "emb"}],
    ids=["timing_emb", "activations", "untied", "untied_shared_emb"])
def test_variant_logits_and_decode_steps_match_jax(extra):
    """Teacher-forced logits and, where the variant changes the decode
    step (a learned position table, an untied softmax), three decode
    steps of the first source row (the step logits from the JAX model's
    own step function)."""
    cfg = _model_cfg(**extra)
    jm, params, tm = _both(cfg)
    batch = _batch(np.random.RandomState(6))
    with torch.no_grad():
        _rel_close(tm(batch), jm.call(params, batch))
    if "encoder.ffn_activation" in extra:
        return
    src = {k: batch[k][:1] for k in ("src", "src_padding")}
    step_fn, init = jm.prepare_generation(params, src, 8)
    ours_fn, ours_init = tm.prepare_generation(src, 8)
    cache, ours_cache = init["decoder_internal_cache"], \
        ours_init["decoder_internal_cache"]
    with torch.no_grad():
        for t, token in enumerate((2, 17, 99)):
            want, cache = step_fn(jnp.asarray([token]), cache, t)
            got, ours_cache = ours_fn(torch.tensor([token]), ours_cache, t)
            _rel_close(got, want)


def test_untied_parameters_bridge_both_ways():
    """The untied model has ``output_linear`` (no bias) and a target
    table without a softmax bias, as the JAX module; the bridge fills
    every port parameter and writes the JAX names back."""
    cfg = _model_cfg(**{"modality.share_embedding_and_softmax_weights":
                        False, "modality.timing": "emb"})
    jm, params, tm = _both(cfg)
    flat = _flat(params)
    assert "output_linear/kernel" in flat
    assert "output_linear/bias" not in flat
    assert "target_symbol_modality/bias" not in flat
    assert "target_symbol_modality/position_weights" in flat
    state = flat_to_state_dict(flat, tm)
    assert sorted(state) == sorted(tm.state_dict())
    back = neurst_tpu_torch.utils.param_bridge.state_dict_to_flat(tm)
    assert sorted(back) == sorted(flat)
    for name in flat:
        np.testing.assert_array_equal(back[name], flat[name])


def test_untied_softmax_loss_and_gradients_take_the_composite_route():
    """An untied model at V and D multiples of 128 trains through its
    logits and the composite label-smoothed cross-entropy in both
    packages (the fused projection + xent needs the tied table): the
    loss and every gradient agree, and asking it for prelogits raises."""
    cfg = _model_cfg(**{"modality.share_embedding_and_softmax_weights":
                        False, "modality.dim": 128,
                        "encoder.hidden_size": 128,
                        "decoder.hidden_size": 128})
    jm, params, tm = _both(cfg, seed=1)
    assert not jm.supports_fused_softmax_ce()
    assert not tm.supports_fused_softmax_ce()
    tied = neurst_tpu_torch.build_model(
        dict(cfg, **{"model.params": dict(
            cfg["model.params"],
            **{"modality.share_embedding_and_softmax_weights": True})}),
        src_meta=META, trg_meta=META, device="meta")
    assert tied.supports_fused_softmax_ce()
    batch = _batch(np.random.RandomState(8))
    crit_args = {"label_smoothing": 0.1}
    jcrit = JaxCriterion(crit_args)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        out, aux = jm.call_train(p, jbatch)
        return jcrit.reduce_loss(jbatch, out) + aux

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    crit = neurst_tpu_torch.build_criterion(
        {"criterion.class": "label_smoothed_cross_entropy",
         "criterion.params": crit_args})
    tx = create_optax_chain(neurst_tpu_torch.build_optimizer(
        {"optimizer.class": "adam", "optimizer.params": {}}), 1e-3)
    step = make_train_step(tm, crit, tx)
    ours, _, our_grads = step.compute_grads(dict(tm.named_parameters()),
                                            batch)
    assert abs(float(ours) - float(loss)) <= TOL * abs(float(loss))
    ref = flat_to_state_dict(_flat(grads), tm)
    assert sorted(our_grads) == sorted(ref)
    assert "output_linear.weight" in our_grads
    for name, g in our_grads.items():
        assert float((g - ref[name]).abs().max()) \
            <= GRAD_TOL * float(ref[name].abs().max()) + 1e-9, name
    with pytest.raises(ValueError, match="tied softmax"):
        tm(batch, return_prelogits=True)
