"""The port's text Transformer against the JAX package's.

A small ``transformer_128_2e_2d_4h`` (d 128 so the fused projection +
cross-entropy path is on, 2 encoder and 2 decoder layers, 4 heads,
filter 512, every dropout rate 0, float32), source vocabulary 384 and
target 256 (one vocabulary of 256 where the source and target share
their embedding), gets one set of weights from the JAX ``init_params``,
carried into the port through ``utils/param_bridge``.  Both packages
run the same numpy-seeded [4, 12] batches with padded rows; the JAX side
with ``jax_default_matmul_precision=float32`` (conftest), the port on the
CPU with TF32 off.

Compared, with the source embedding separate and shared: the hparams
sets and flags; the bridge filling every port parameter; the logits; the
loss (within 1e-5) and every gradient (within 1e-4 of its largest value)
of the train step's fused path; the parameters after two steps of Adam
with clip norm 1 and a noam schedule (within 2 lr a step); and the
port's logits path against its prelogits path.
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
from neurst_tpu.models.transformer import \
    Transformer as JaxTransformer  # noqa: E402
from neurst_tpu.optimizers.optimizers import Adam as JaxAdam  # noqa: E402
from neurst_tpu.optimizers.optimizers import \
    create_optax_chain as jax_chain  # noqa: E402
from neurst_tpu.optimizers.schedules.lr_schedules import \
    NoamSchedule as JaxNoam  # noqa: E402
from neurst_tpu.parallel.train_step import \
    TrainState as JaxTrainState  # noqa: E402
from neurst_tpu.parallel.train_step import \
    make_train_step as jax_make_train_step  # noqa: E402
from neurst_tpu.utils.checkpoints import flatten_params  # noqa: E402
from neurst_tpu.utils.hparams_sets import \
    get_hyper_parameters as jax_hparams  # noqa: E402
from neurst_tpu_torch.models.transformer import Transformer  # noqa: E402
from neurst_tpu_torch.optimizers.optimizers import \
    create_optax_chain  # noqa: E402
from neurst_tpu_torch.parallel import (TrainState,  # noqa: E402
                                       make_train_step)
from neurst_tpu_torch.utils.hparams_sets import (  # noqa: E402
    get_hyper_parameters, registered_hparams_names)
from neurst_tpu_torch.utils.param_bridge import (  # noqa: E402
    flat_to_state_dict, load_flat_params)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NAME = "transformer_128_2e_2d_4h"
FIXED = ("transformer_toy", "transformer_base", "transformer_s",
         "transformer_big", "transformer_big_dp01")
OPT = {"beta_1": 0.9, "beta_2": 0.98, "epsilon": 1e-9}
# a test learning rate (the hparams set's warmup of 4000 steps would
# move the weights by ~1e-7, below what the comparison can see)
LR = {"dmodel": 128, "warmup_steps": 10, "initial_factor": 1.0}
CRITERION = {"label_smoothing": 0.1}
# float32 through 4 layers, sums in other orders: loss and grad_norm
# relative, each gradient relative to its largest |value|
TOL = 1e-5
GRAD_TOL = 1e-4
BATCH, LENGTH = 4, 12


def _metas(share):
    src = 256 if share else 384
    return ({"vocab_size": src, "eos_id": 1, "bos_id": 2, "unk_id": 3},
            {"vocab_size": 256, "eos_id": 1, "bos_id": 2, "unk_id": 3})


def _config(share):
    cfg = JaxTransformer.build_model_args_by_name(NAME)
    params = dict(cfg["model.params"], dtype="float32")
    params["modality.share_source_target_embedding"] = share
    for side in ("encoder", "decoder"):
        for rate in ("attention_dropout_rate", "ffn_dropout_rate",
                     "layer_postprocess_dropout_rate"):
            params[f"{side}.{rate}"] = 0.0
    return dict(cfg, **{"model.params": params})


def _batch(rng, src_vocab, src_lengths, trg_lengths):
    src_lengths, trg_lengths = np.asarray(src_lengths), np.asarray(
        trg_lengths)
    positions = np.arange(LENGTH)[None]
    return {
        "src": rng.randint(0, src_vocab, (BATCH, LENGTH)).astype(np.int32),
        "src_padding": (positions >= src_lengths[:, None]).astype(
            np.float32),
        "trg_input": rng.randint(0, 256, (BATCH, LENGTH)).astype(np.int32),
        "trg": rng.randint(0, 256, (BATCH, LENGTH)).astype(np.int32),
        "trg_padding": (positions >= trg_lengths[:, None]).astype(
            np.float32)}


@pytest.fixture(scope="module", params=[False, True],
                ids=["separate", "shared"])
def setup(request):
    """The JAX side, once per embedding layout: logits and the gradients
    of the first batch, and two train steps."""
    share = request.param
    cfg = _config(share)
    src_meta, trg_meta = _metas(share)
    jm = jax_build(cfg, src_meta=src_meta, trg_meta=trg_meta)
    assert jm.supports_fused_softmax_ce()
    params = jm.init_params(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    rng = np.random.RandomState(1 + share)
    batches = [_batch(rng, src_meta["vocab_size"], [12, 9, 5, 12],
                      [12, 7, 3, 10]),
               _batch(rng, src_meta["vocab_size"], [6, 12, 12, 2],
                      [11, 12, 4, 8])]
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    crit = JaxCriterion(CRITERION)

    def loss_fn(p, batch):
        out, aux = jm.call_train(p, batch, want_prelogits=True)
        return crit.reduce_loss(batch, out) + aux

    logits = jm.call(params, jbatches[0])
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, jbatches[0])
    tx = jax_chain(JaxAdam(OPT), JaxNoam(LR), clip_norm=1.0)
    step = jax.jit(jax_make_train_step(jm, crit, tx, lr_schedule=JaxNoam(LR)))
    state = JaxTrainState.create(params, tx)
    metrics = []
    for batch in jbatches:
        state, m = step(state, batch, jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    return {
        "share": share, "cfg": cfg, "flat": flat, "batches": batches,
        "logits": np.asarray(logits), "loss": float(loss),
        "grads": {k: np.asarray(v) for k, v in
                  flatten_params(grads).items()},
        "metrics": metrics,
        "params": {k: np.asarray(v) for k, v in
                   flatten_params(state.params).items()}}


def _port_model(setup):
    src_meta, trg_meta = _metas(setup["share"])
    model = neurst_tpu_torch.build_model(setup["cfg"], src_meta=src_meta,
                                         trg_meta=trg_meta, device="cpu")
    return load_flat_params(model, setup["flat"])


def _port(setup):
    model = _port_model(setup)
    assert model.supports_fused_softmax_ce()
    lr = neurst_tpu_torch.build_lr_schedule({"lr_schedule.class": "noam",
                                             "lr_schedule.params": LR})
    tx = create_optax_chain(neurst_tpu_torch.build_optimizer(
        {"optimizer.class": "adam", "optimizer.params": OPT}), lr,
        clip_norm=1.0)
    crit = neurst_tpu_torch.build_criterion(
        {"criterion.class": "label_smoothed_cross_entropy",
         "criterion.params": CRITERION})
    step = make_train_step(model, crit, tx, lr_schedule=lr)
    return model, step, TrainState.create(dict(model.named_parameters()), tx)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


@pytest.mark.parametrize("name", FIXED + (
    "transformer_256_3e_2d", "transformer_512_6e_6d_16h_dp0.3",
    "transformer_base_v2", "speech_transformer_s"))
def test_hparams_sets_match_jax(name):
    """Every fixed name and two parametric ones give the JAX package's
    config; names the JAX Transformer does not know give None."""
    want = JaxTransformer.build_model_args_by_name(name)
    assert Transformer.build_model_args_by_name(name) == want
    if want is not None:
        assert get_hyper_parameters(name) == jax_hparams(name)
    if name in FIXED:
        assert name in registered_hparams_names()


def test_flags_match_jax():
    def flags(cls):
        return {f.name: f.default for f in cls.class_or_method_args()}
    assert flags(Transformer) == flags(JaxTransformer)


@pytest.mark.parametrize("name", FIXED)
def test_build_model_from_every_hparams_set(name):
    """``build_model`` builds ``transformer`` from each fixed set, with
    the JAX package's parameter count (the JAX module's own shapes)."""
    cfg = Transformer.build_model_args_by_name(name)
    meta = {"vocab_size": 512, "eos_id": 1}
    model = neurst_tpu_torch.build_model(
        {"model.class": "transformer", "model.params": cfg["model.params"]},
        src_meta=meta, trg_meta=meta, device="meta")
    assert isinstance(model, Transformer)
    jm = jax_build({"model.class": "transformer",
                    "model.params": cfg["model.params"]},
                   src_meta=meta, trg_meta=meta)
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    want = sum(int(np.prod(leaf.shape))
               for leaf in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == want


def test_bridge_fills_every_parameter(setup):
    """Every JAX name maps onto a port parameter and every port
    parameter is filled; an extra name raises."""
    model = _port_model(setup)
    state = flat_to_state_dict(setup["flat"], model)
    assert sorted(state) == sorted(model.state_dict())
    source = ("shared_symbol_modality.weights" if setup["share"]
              else "input_symbol_modality.weights")
    assert source in state
    assert ("target_symbol_modality.weights" in state) != setup["share"]
    with pytest.raises(KeyError, match="does not have"):
        flat_to_state_dict(dict(setup["flat"], **{
            "output_linear/kernel": np.zeros((128, 256), np.float32)}),
            model)


def test_logits_match_jax(setup):
    """Teacher-forced logits, and the same from ``src_length`` in place
    of ``src_padding``."""
    model = _port_model(setup)
    batch = setup["batches"][0]
    with torch.no_grad():
        logits = model(batch)
        lengths = {k: v for k, v in batch.items() if k != "src_padding"}
        lengths["src_length"] = (1 - batch["src_padding"]).sum(1).astype(
            np.int32)
        from_lengths = model(lengths)
    ref = setup["logits"]
    assert logits.shape == ref.shape
    assert float((logits - torch.from_numpy(ref.copy())).abs().max()) \
        <= 1e-4 * np.abs(ref).max()
    assert torch.equal(logits, from_lengths)


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


def test_two_steps(setup):
    """Metrics of both steps, then every parameter within 2 lr a step
    (Adam's first update is ~lr * sign(g))."""
    model, step, state = _port(setup)
    for batch, ref in zip(setup["batches"], setup["metrics"]):
        state, metrics = step(state, batch)
        assert _rel(metrics["loss"], ref["loss"]) <= TOL
        assert _rel(metrics["grad_norm"], ref["grad_norm"]) <= TOL
        assert _rel(metrics["lr"], ref["lr"]) <= 1e-6
    lr = JaxNoam(LR)
    atol = 2 * (float(lr(0)) + float(lr(1)))
    ref = flat_to_state_dict(setup["params"], model)
    for name, p in model.named_parameters():
        assert float((p.detach() - ref[name]).abs().max()) <= atol, name


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


def test_shared_embedding_needs_one_vocabulary():
    cfg = _config(True)
    with pytest.raises(ValueError, match="one vocabulary"):
        neurst_tpu_torch.build_model(
            cfg, src_meta={"vocab_size": 384},
            trg_meta={"vocab_size": 256, "eos_id": 1}, device="meta")
