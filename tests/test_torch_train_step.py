"""The port's training step against the JAX package's ``make_train_step``.

A small SpeechTransformer (d=128 so the fused projection + cross-entropy
path is on, 2 encoder and 2 decoder layers, 2 heads of 64, filter 256,
vocabulary 256, encoder flash attention on, every dropout rate 0,
float32) gets one set of weights from the JAX ``init_params``, carried
into the port through ``utils/param_bridge``; both packages train on the
same numpy-seeded batches with the label-smoothed criterion, Adam
(beta 0.9 / 0.98, epsilon 1e-9) with clip_norm 1 and a noam schedule.
The JAX side runs the Pallas flash kernels in interpret mode.

Compared: the loss, every gradient (the JAX gradient tree mapped onto
the port's names through ``flat_to_state_dict``), and after two steps
the metrics and every parameter; one step with ``update_cycle=2`` over
ragged micro-batches; and the port's logits path against its prelogits
path; and ``make_eval_step``'s statistics.
"""

import os

import numpy as np
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
from neurst_tpu.optimizers.optimizers import Adam as JaxAdam  # noqa: E402
from neurst_tpu.optimizers.optimizers import \
    create_optax_chain as jax_chain  # noqa: E402
from neurst_tpu.optimizers.schedules.lr_schedules import \
    NoamSchedule as JaxNoam  # noqa: E402
from neurst_tpu.parallel.train_step import \
    TrainState as JaxTrainState  # noqa: E402
from neurst_tpu.parallel.train_step import \
    make_eval_step as jax_make_eval_step  # noqa: E402
from neurst_tpu.parallel.train_step import \
    make_train_step as jax_make_train_step  # noqa: E402
from neurst_tpu.utils.checkpoints import flatten_params  # noqa: E402
from neurst_tpu_torch.optimizers.optimizers import \
    create_optax_chain  # noqa: E402
from neurst_tpu_torch.parallel import (TrainState,  # noqa: E402
                                       make_eval_step, make_train_step)
from neurst_tpu_torch.utils.param_bridge import (  # noqa: E402
    flat_to_state_dict, load_flat_params)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

VOCAB = 256
TRG_META = {"vocab_size": VOCAB, "eos_id": 1, "bos_id": 2, "unk_id": 3}
SRC_META = {"audio_feature_dim": 16, "audio_feature_channels": 1}
OPT = {"beta_1": 0.9, "beta_2": 0.98, "epsilon": 1e-9}
# a test learning rate (the recipe's warmup of 25000 steps would move
# the weights by ~1e-7, below what the comparison can see)
LR = {"dmodel": 128, "warmup_steps": 10, "initial_factor": 1.0}
CRITERION = {"label_smoothing": 0.1}
# float32 through 4 layers, sums in other orders: loss and grad_norm
# relative, each gradient relative to its largest |value|
TOL = 1e-5
GRAD_TOL = 1e-4


def _config():
    cfg = JaxSpeechTransformer.build_model_args_by_name(
        "speech_transformer_toy")
    params = dict(cfg["model.params"], dtype="float32")
    params.update({"modality.dim": 128, "modality.source.channels": 16,
                   "encoder.enable_flash_attention": True})
    for side in ("encoder", "decoder"):
        params.update({f"{side}.hidden_size": 128,
                       f"{side}.num_attention_heads": 2,
                       f"{side}.filter_size": 256,
                       f"{side}.attention_dropout_rate": 0.0,
                       f"{side}.ffn_dropout_rate": 0.0,
                       f"{side}.layer_postprocess_dropout_rate": 0.0})
    return dict(cfg, **{"model.params": params})


def _batch(rng, src_lengths, trg_lengths, frames=64, trg_len=7):
    b = len(src_lengths)
    trg_lengths = np.asarray(trg_lengths)
    return {
        "src": rng.randn(b, frames, 16, 1).astype(np.float32),
        "src_length": np.asarray(src_lengths, np.int32),
        "trg_input": rng.randint(0, VOCAB, (b, trg_len)).astype(np.int32),
        "trg": rng.randint(0, VOCAB, (b, trg_len)).astype(np.int32),
        "trg_padding": (np.arange(trg_len)[None] >= trg_lengths[:, None]
                        ).astype(np.float32)}


def _jax_tx():
    return jax_chain(JaxAdam(OPT), JaxNoam(LR), clip_norm=1.0)


@pytest.fixture(scope="module")
def setup():
    """The JAX side, computed once: gradients of the first batch, two
    steps, and one update_cycle=2 step."""
    cfg = _config()
    jm = jax_build(cfg, src_meta=SRC_META, trg_meta=TRG_META)
    assert jm.supports_fused_softmax_ce()
    params = jm.init_params(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    rng = np.random.RandomState(0)
    batches = [_batch(rng, [64, 45, 20], [7, 5, 3]),
               _batch(rng, [60, 64, 33], [6, 7, 2])]
    crit = JaxCriterion(CRITERION)
    key = jax.random.PRNGKey(1)

    def loss_fn(p, batch):
        out, aux = jm.call_train(p, batch, rngs={"dropout": key},
                                 want_prelogits=True)
        return crit.reduce_loss(batch, out) + aux

    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, jbatches[0])
    tx = _jax_tx()
    step = jax.jit(jax_make_train_step(jm, crit, tx, lr_schedule=JaxNoam(LR)))
    state = JaxTrainState.create(params, tx)
    metrics = []
    for batch in jbatches:
        state, m = step(state, batch, key)
        metrics.append({k: float(v) for k, v in m.items()})
    stacked = {k: jnp.stack([jbatches[0][k], jbatches[1][k]])
               for k in jbatches[0]}
    step2 = jax.jit(jax_make_train_step(jm, crit, tx, update_cycle=2,
                                        lr_schedule=JaxNoam(LR)))
    state2, m2 = step2(JaxTrainState.create(params, tx), stacked, key)
    eval_stats = jax.jit(jax_make_eval_step(jm, crit))(params, jbatches[1])
    return {
        "cfg": cfg, "flat": flat, "batches": batches, "loss": float(loss),
        "grads": {k: np.asarray(v) for k, v in
                  flatten_params(grads).items()},
        "metrics": metrics,
        "params": {k: np.asarray(v) for k, v in
                   flatten_params(state.params).items()},
        "cycle_metrics": {k: float(v) for k, v in m2.items()},
        "cycle_params": {k: np.asarray(v) for k, v in
                         flatten_params(state2.params).items()},
        "eval": [np.asarray(x) for x in eval_stats]}


def _port(setup, update_cycle=1):
    model = neurst_tpu_torch.build_model(setup["cfg"], src_meta=SRC_META,
                                         trg_meta=TRG_META, device="cpu")
    load_flat_params(model, setup["flat"])
    assert model.supports_fused_softmax_ce()
    lr = neurst_tpu_torch.build_lr_schedule({"lr_schedule.class": "noam",
                                             "lr_schedule.params": LR})
    tx = create_optax_chain(neurst_tpu_torch.build_optimizer(
        {"optimizer.class": "adam", "optimizer.params": OPT}), lr,
        clip_norm=1.0)
    crit = neurst_tpu_torch.build_criterion(
        {"criterion.class": "label_smoothed_cross_entropy",
         "criterion.params": CRITERION})
    step = make_train_step(model, crit, tx, update_cycle=update_cycle,
                           lr_schedule=lr)
    return model, step, TrainState.create(dict(model.named_parameters()), tx)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _check_params(model, flat_ref, atol):
    ref = flat_to_state_dict(flat_ref, model)
    for name, p in model.named_parameters():
        assert float((p.detach() - ref[name]).abs().max()) <= atol, name


def test_loss_and_every_gradient(setup):
    model, step, state = _port(setup)
    loss, aux, grads = step.compute_grads(state.params, setup["batches"][0])
    assert _rel(loss, setup["loss"]) <= TOL and float(aux) == 0.0
    ref = flat_to_state_dict(setup["grads"], model)
    assert sorted(grads) == sorted(ref)
    for name, g in grads.items():
        want = ref[name]
        err = float((g - want).abs().max())
        assert err <= GRAD_TOL * float(want.abs().max()) + 1e-9, name


def _lrs():
    lr = JaxNoam(LR)
    return [float(lr(0)), float(lr(1))]


def test_two_steps(setup):
    """Metrics of both steps, then every parameter.  Adam's first update
    is ~lr * sign(g), so a gradient near zero whose sign differs between
    the packages moves a weight by up to 2 lr: parameters agree within
    2 lr per step taken, and all but half a percent of their values
    within 1e-5 (measured: 0.1%, the near-zero gradients of vocabulary
    rows no target uses)."""
    model, step, state = _port(setup)
    for batch, ref in zip(setup["batches"], setup["metrics"]):
        state, metrics = step(state, batch)
        assert set(metrics) == set(ref)
        assert _rel(metrics["loss"], ref["loss"]) <= TOL
        assert _rel(metrics["grad_norm"], ref["grad_norm"]) <= TOL
        assert _rel(metrics["lr"], ref["lr"]) <= 1e-6
        assert float(metrics["aux_loss"]) == ref["aux_loss"] == 0.0
    assert state.step == 2
    _check_params(model, setup["params"], 2 * sum(_lrs()))
    ref = flat_to_state_dict(setup["params"], model)
    diffs = torch.cat([(p.detach() - ref[n]).abs().flatten()
                       for n, p in model.named_parameters()])
    assert float((diffs > 1e-5).float().mean()) <= 5e-3


def test_update_cycle_two(setup):
    """One step over two ragged micro-batches, token-weighted as one big
    batch."""
    model, step, state = _port(setup, update_cycle=2)
    b0, b1 = setup["batches"]
    stacked = {k: np.stack([b0[k], b1[k]]) for k in b0}
    state, metrics = step(state, stacked)
    ref = setup["cycle_metrics"]
    assert _rel(metrics["loss"], ref["loss"]) <= TOL
    assert _rel(metrics["grad_norm"], ref["grad_norm"]) <= TOL
    _check_params(model, setup["cycle_params"], 2 * _lrs()[0])


def test_logits_path_matches_prelogits_path(setup):
    """NEURST_FUSED_CE=0 (the [B, T, V] logits and the plain criterion)
    gives the prelogits path's loss and gradients."""
    results = []
    for mode in ("1", "0"):
        os.environ["NEURST_FUSED_CE"] = mode
        try:
            _, step, state = _port(setup)
            results.append(step.compute_grads(state.params,
                                              setup["batches"][1]))
        finally:
            os.environ.pop("NEURST_FUSED_CE", None)
    (loss1, _, g1), (loss0, _, g0) = results
    assert _rel(loss0, loss1) <= 1e-6
    for name in g1:
        assert float((g1[name] - g0[name]).abs().max()) \
            <= 1e-5 * float(g1[name].abs().max()) + 1e-9, name


def test_eval_step(setup):
    """(nll_sum, n_samples, n_tokens) of the inference forward."""
    model, _, _ = _port(setup)
    crit = neurst_tpu_torch.build_criterion(
        {"criterion.class": "label_smoothed_cross_entropy",
         "criterion.params": CRITERION})
    stats = make_eval_step(model, crit)(setup["batches"][1])
    for ours, ref in zip(stats, setup["eval"]):
        assert np.abs(ours.numpy() - ref).max() <= TOL * np.abs(ref).max()
