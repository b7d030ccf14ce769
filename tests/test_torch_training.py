"""The port's training components against the JAX package's, on the
same numpy-seeded inputs in float32: the label-smoothed criterion (both
the logits and the fused prelogits paths, each way of weighting tokens),
the noam schedule, the Adam chain with clipping (and its AdamW and
AMSGrad forms), the bf16-params wrapper with its float32 master, the
distributions of ``init_params`` and the bf16-residual attention
softmax; and the refusal of dropout in training without a dropout key.
"""

import numpy as np
import optax
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import neurst_tpu_torch  # noqa: E402
from neurst_tpu.criterions.label_smoothed_cross_entropy import \
    LabelSmoothedCrossEntropy as JaxCriterion  # noqa: E402
from neurst_tpu.models.model import build_model as jax_build  # noqa: E402
from neurst_tpu.models.speech_transformer import \
    SpeechTransformer as JaxSpeechTransformer  # noqa: E402
from neurst_tpu.optimizers import master_weights as jax_master  # noqa: E402
from neurst_tpu.optimizers.optimizers import Adam as JaxAdam  # noqa: E402
from neurst_tpu.optimizers.optimizers import \
    create_optax_chain as jax_chain  # noqa: E402
from neurst_tpu.optimizers.schedules.lr_schedules import \
    NoamSchedule as JaxNoam  # noqa: E402
from neurst_tpu.utils.checkpoints import flatten_params  # noqa: E402
from neurst_tpu_torch.layers.common_layers import LayerNorm  # noqa: E402
from neurst_tpu_torch.optimizers import master_weights  # noqa: E402
from neurst_tpu_torch.optimizers.optimizers import (  # noqa: E402
    apply_updates, create_optax_chain)
from neurst_tpu_torch.utils.param_bridge import \
    flat_to_state_dict  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("weights", ["trg_padding", "trg_length",
                                     "sample_mask"])
@pytest.mark.parametrize("path", ["logits", "prelogits"])
def test_criterion_matches_jax(path, weights):
    """(nll_sum, n_samples, n_tokens), reduce_loss, reduce_loss_terms and
    reduce_metrics, with label smoothing 0.1 (normalizing constant
    subtracted), within 1e-5 (float32 sums in other orders)."""
    rng = np.random.RandomState(0)
    b, t, d, vocab = 3, 5, 16, 40
    labels = rng.randint(0, vocab, (b, t)).astype(np.int32)
    lengths = np.asarray([5, 3, 1], np.int32)
    padding = (np.arange(t)[None] >= lengths[:, None]).astype(np.float32)
    inp = {"trg": labels}
    if weights == "trg_length":
        inp["trg_length"] = lengths
    else:
        inp["trg_padding"] = padding
    if weights == "sample_mask":
        inp["sample_mask"] = np.asarray([1.0, 0.0, 1.0], np.float32)
    if path == "logits":
        logits = (3 * rng.randn(b, t, vocab)).astype(np.float32)
        jout, tout = jnp.asarray(logits), torch.from_numpy(logits)
    else:
        x = rng.randn(b, t, d).astype(np.float32)
        w = rng.randn(vocab, d).astype(np.float32)
        bias = rng.randn(vocab).astype(np.float32)
        jout = {"prelogits": jnp.asarray(x), "softmax_w": jnp.asarray(w),
                "softmax_bias": jnp.asarray(bias)}
        tout = {"prelogits": torch.from_numpy(x),
                "softmax_w": torch.from_numpy(w),
                "softmax_bias": torch.from_numpy(bias)}
    jcrit = JaxCriterion({"label_smoothing": 0.1})
    tcrit = neurst_tpu_torch.build_criterion(
        {"criterion.class": "label_smoothed_cross_entropy",
         "criterion.params": {"label_smoothing": 0.1}})
    jinp = {k: jnp.asarray(v) for k, v in inp.items()}
    for ours, ref in zip(tcrit(inp, tout), jcrit(jinp, jout)):
        assert np.abs(_np(ours) - _np(ref)).max() <= 1e-5
    assert abs(float(tcrit.reduce_loss(inp, tout))
               - float(jcrit.reduce_loss(jinp, jout))) <= 1e-5
    for ours, ref in zip(tcrit.reduce_loss_terms(inp, tout),
                         jcrit.reduce_loss_terms(jinp, jout)):
        assert abs(float(ours) - float(ref)) <= 1e-5
    stats = [tcrit(inp, tout), tcrit(inp, tout)]
    jstats = [jcrit(jinp, jout), jcrit(jinp, jout)]
    for key, value in tcrit.reduce_metrics(stats).items():
        ref = jcrit.reduce_metrics(jstats)[key]
        assert abs(value - ref) <= 1e-5 * max(1.0, abs(ref))


def test_noam_matches_jax():
    """The speech_transformer_s schedule (factor 3.5 decaying to 1.5,
    warmup 25000) at the optimizer's step counts, within 1e-6 relative
    (the JAX schedule computes in float32), and a resumed run's offset."""
    params = {"dmodel": 256, "initial_factor": 3.5, "end_factor": 1.5,
              "warmup_steps": 25000, "start_decay_at": 50000,
              "decay_steps": 50000}
    ours = neurst_tpu_torch.build_lr_schedule(
        {"lr_schedule.class": "noam", "lr_schedule.params": params})
    ref = JaxNoam(params)
    for step in (0, 1, 99, 24999, 25000, 49999, 75000, 120000):
        want = float(ref(step))
        assert abs(ours(step) - want) <= 1e-6 * want
    resumed = type(ours)(params, initial_step=1000)
    assert resumed(0) == ours(1000)


def _grads(rng, shapes, steps):
    return [{name: (rng.randn(*shape) * 3).astype(np.float32)
             for name, shape in shapes.items()} for _ in range(steps)]


SHAPES = {"w": (6, 5), "b": (5,), "scale": (7,)}


@pytest.mark.parametrize("opt_args, clip", [
    ({"beta_1": 0.9, "beta_2": 0.98, "epsilon": 1e-9}, {"clip_norm": 1.0}),
    ({"beta_1": 0.9, "beta_2": 0.98, "epsilon": 1e-9}, {"clip_value": 0.5}),
    ({"epsilon": 1e-7, "weight_decay": 0.01}, {}),
    ({"epsilon": 1e-7, "amsgrad": True}, {"clip_norm": 5.0}),
], ids=["adam-clip_norm", "adam-clip_value", "adamw", "amsgrad"])
def test_adam_chain_matches_optax(opt_args, clip):
    """Three steps of the chain on identical gradients, with the noam
    schedule as the learning rate: parameters within 1e-6 (Adam's update
    is bounded by the lr; float32 rounds in other orders)."""
    rng = np.random.RandomState(1)
    params = {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    grads = _grads(rng, SHAPES, 3)
    lr_args = {"dmodel": 16, "warmup_steps": 2, "initial_factor": 0.5}
    jtx = jax_chain(JaxAdam(opt_args), JaxNoam(lr_args), **clip)
    ttx = create_optax_chain(
        neurst_tpu_torch.build_optimizer({"optimizer.class": "adam",
                                          "optimizer.params": opt_args}),
        neurst_tpu_torch.build_lr_schedule({"lr_schedule.class": "noam",
                                            "lr_schedule.params": lr_args}),
        **clip)
    jparams = {n: jnp.asarray(v) for n, v in params.items()}
    tparams = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    jstate, tstate = jtx.init(jparams), ttx.init(tparams)
    for g in grads:
        jupd, jstate = jtx.update({n: jnp.asarray(v) for n, v in g.items()},
                                  jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        tupd, tstate = ttx.update({n: torch.from_numpy(v)
                                   for n, v in g.items()}, tstate, tparams)
        apply_updates(tparams, tupd)
        for n in params:
            assert np.abs(_np(tparams[n]) - _np(jparams[n])).max() <= 1e-6


class _Tiny(torch.nn.Module):

    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(5, 6)
        self.ln = LayerNorm(7)


def test_bf16_params_with_float32_master_match_jax():
    """``cast_params_bf16`` stores every float parameter in bf16
    (LayerNorm included, unlike the inference policy); three steps of
    ``with_bf16_params`` on bf16 gradients keep the master within 1e-6 of
    the JAX master and land the live params on bf16(master), equal to
    the JAX bf16 params but where the two masters straddle a bf16
    rounding boundary (one bf16 ulp, 2^-8 relative)."""
    rng = np.random.RandomState(2)
    model = _Tiny()
    values = {"dense.weight": rng.randn(6, 5), "dense.bias": rng.randn(6),
              "ln.scale": rng.randn(7), "ln.bias": rng.randn(7)}
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(values[name]))
    master_weights.cast_params_bf16(model)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    tparams = dict(model.named_parameters())
    jparams = jax_master.cast_params_bf16(
        {n: jnp.asarray(v, jnp.float32) for n, v in values.items()})
    opt = {"beta_1": 0.9, "beta_2": 0.98, "epsilon": 1e-9}
    jtx = jax_master.with_bf16_params(jax_chain(JaxAdam(opt), 1e-2,
                                                clip_norm=1.0))
    ttx = master_weights.with_bf16_params(create_optax_chain(
        neurst_tpu_torch.build_optimizer({"optimizer.class": "adam",
                                          "optimizer.params": opt}),
        1e-2, clip_norm=1.0))
    jstate, tstate = jtx.init(jparams), ttx.init(tparams)
    for g in _grads(rng, {n: v.shape for n, v in values.items()}, 3):
        g16 = {n: torch.from_numpy(v).bfloat16() for n, v in g.items()}
        jupd, jstate = jtx.update(
            {n: jnp.asarray(v, jnp.bfloat16) for n, v in g.items()},
            jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        tupd, tstate = ttx.update(g16, tstate, tparams)
        apply_updates(tparams, tupd)
        for n in values:
            master = _np(jstate["master"][n])
            assert np.abs(_np(tstate["master"][n]) - master).max() <= 1e-6
            assert tparams[n].dtype == torch.bfloat16
            assert torch.equal(tparams[n], tstate["master"][n].bfloat16())
            assert np.abs(_np(tparams[n]) - _np(jparams[n])).max() \
                <= 2 ** -8 * np.abs(master).max()


def test_init_params_match_jax_distributions():
    """``init_params`` against the JAX ``init_params`` for every
    parameter of speech_transformer_s cut to one encoder and one decoder
    layer (every distinct tensor shape of the model): the same shapes (the
    JAX tree mapped through the parameter bridge), constants equal, and
    mean and std within 5% of the JAX std (10% under 4k elements).  A
    framework cannot match another's random bits, so the test compares
    distributions."""
    cfg = JaxSpeechTransformer.build_model_args_by_name(
        "speech_transformer_s")
    params = dict(cfg["model.params"], **{"encoder.num_layers": 1,
                                          "decoder.num_layers": 1})
    cfg = dict(cfg, **{"model.params": params})
    metas = dict(src_meta={"audio_feature_dim": 80,
                           "audio_feature_channels": 1},
                 trg_meta={"vocab_size": 8192, "eos_id": 1})
    flat = flatten_params(jax_build(cfg, **metas).init_params(
        jax.random.PRNGKey(0)))
    model = neurst_tpu_torch.build_model(cfg, device="cpu", **metas)
    ours = model.init_params(torch.Generator().manual_seed(0))
    ref = flat_to_state_dict({k: np.asarray(v) for k, v in flat.items()},
                             model)
    assert sorted(ours) == sorted(ref)
    for name, want in ref.items():
        got = ours[name].detach()
        assert got.shape == want.shape, name
        std = float(want.std())
        if std == 0.0:
            assert torch.equal(got, want), name
            continue
        tol = (0.05 if want.numel() >= 4096 else 0.10) * std
        assert abs(float(got.mean()) - float(want.mean())) <= tol, name
        assert abs(float(got.std()) - std) <= tol, name


def test_softmax_bf16_residual_matches_jax():
    """Training-time attention softmax in bf16: the bf16 probabilities
    and the gradient from them, against the JAX custom VJP (bitwise
    probabilities; gradient within 1e-6, float32 sums in other
    orders)."""
    from neurst_tpu.layers.attentions.multi_head_attention import \
        _softmax_bf16_residual
    from neurst_tpu_torch.layers.attentions.multi_head_attention import \
        _SoftmaxBf16Residual
    rng = np.random.RandomState(3)
    z = (3 * rng.randn(2, 3, 5, 7)).astype(np.float32)
    dp = torch.from_numpy(rng.randn(2, 3, 5, 7).astype(np.float32)
                          ).bfloat16()
    p, vjp = jax.vjp(_softmax_bf16_residual, jnp.asarray(z))
    (dz,) = vjp(jnp.asarray(dp.float().numpy(), jnp.bfloat16))
    tz = torch.from_numpy(z).requires_grad_()
    tp = _SoftmaxBf16Residual.apply(tz)
    (tdz,) = torch.autograd.grad(tp, tz, dp)
    assert tp.dtype == torch.bfloat16
    assert np.array_equal(_np(tp), _np(p))
    assert np.abs(_np(tdz) - _np(dz)).max() <= 1e-6


def test_training_with_dropout_is_refused():
    """Dropout in training without a dropout key is refused: the model
    and every dropout site raise, while inference and rate 0 pass
    through."""
    from neurst_tpu_torch.layers.common_layers import apply_dropout
    x = torch.ones(3)
    assert apply_dropout(x, 0.1, False) is x
    assert apply_dropout(x, 0.0, True) is x
    with pytest.raises(ValueError, match="dropout key"):
        apply_dropout(x, 0.1, True)
    cfg = JaxSpeechTransformer.build_model_args_by_name(
        "speech_transformer_toy")
    model = neurst_tpu_torch.build_model(
        cfg, src_meta={"audio_feature_dim": 16},
        trg_meta={"vocab_size": 10, "eos_id": 1}, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    inputs = {"src": np.zeros((1, 8, 16), np.float32),
              "src_length": np.asarray([8]),
              "trg_input": np.zeros((1, 3), np.int64)}
    with pytest.raises(ValueError, match="dropout key"):
        model.call_train(inputs)
    assert model(inputs).shape == (1, 3, 10)
