"""The port's parallel training step on gloo CPU process groups, against
the JAX package's single-device step.

A small ``transformer_64_2e_2d_4h`` (d 64, 2 + 2 layers, 4 heads,
vocabulary 32, float32, TF32 off) gets one set of weights from the JAX
``init_params``; two numpy-seeded global batches of 8 rows go through the
JAX step on one device (the conftest's CPU) and through the port on 2 and
4 ranks (``tests/torch_parallel_worker.py``: one spawned group runs every
scenario of its size, so a test pays one start).  Compared: the loss
(1e-5), every gradient (1e-4 of its largest value) and the parameters
after two Adam steps with clip norm 1 (within 2 lr a step), of

* data parallelism over 2 and 4 ranks, and with ``update_cycle`` 2
  (against the whole batch's step: accumulation normalizes once by the
  global token count);
* tensor parallelism over 2 ranks (also its logits) and dp 2 x tp 2;
* ring attention in the encoder over the 2 data ranks;
* the pipeline (2 stages, 4 micro-batches) against the JAX model with
  ``pipeline_stages`` 2, its ``[S, P, ...]`` weights carried into the port
  through ``utils/param_bridge``;

with dropout 0.1 the data-parallel and pipelined steps against the
port's single-rank step (the same masks: each rank draws its rows' masks
of the whole batch, which the mask test checks bitwise; the sums over
ranks round in another order, so the step agrees to 1e-6), and
``ring_self_attention`` over 2 and 4 ranks against JAX's on a 2- and a
4-device mesh, forward and gradients, with and without the causal mask.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import port_test_support  # noqa: E402,F401  (one torch thread per worker)
from neurst_tpu.criterions.label_smoothed_cross_entropy import \
    LabelSmoothedCrossEntropy as JaxCriterion  # noqa: E402
from neurst_tpu.models.model import build_model as jax_build  # noqa: E402
from neurst_tpu.models.transformer import \
    Transformer as JaxTransformer  # noqa: E402
from neurst_tpu.ops.ring_attention import \
    ring_self_attention as jax_ring  # noqa: E402
from neurst_tpu.optimizers.optimizers import Adam as JaxAdam  # noqa: E402
from neurst_tpu.optimizers.optimizers import \
    create_optax_chain as jax_chain  # noqa: E402
from neurst_tpu.parallel.train_step import \
    TrainState as JaxTrainState  # noqa: E402
from neurst_tpu.parallel.train_step import \
    make_train_step as jax_make_train_step  # noqa: E402
from neurst_tpu.utils.checkpoints import flatten_params  # noqa: E402
from neurst_tpu_torch.ops.fused_dropout import (  # noqa: E402
    dropout_keep_mask, threshold_and_scale)
from neurst_tpu_torch.utils.param_bridge import \
    unstack_scan_layers  # noqa: E402
from neurst_tpu_torch.utils.rng import (at_row, at_shard,  # noqa: E402
                                        make_key)
from torch_parallel_worker import (run_step, start_group,  # noqa: E402
                                   wait_group)

torch.backends.cuda.matmul.allow_tf32 = False

META = {"vocab_size": 32, "eos_id": 1, "bos_id": 2, "unk_id": 3}
OPT = {"beta_1": 0.9, "beta_2": 0.98, "epsilon": 1e-9}
LR = 1e-3
B, L = 8, 8
TOL, GRAD_TOL = 1e-5, 1e-4
PIPE = {"encoder.pipeline_stages": 2, "decoder.pipeline_stages": 2,
        "encoder.pipeline_microbatches": 4,
        "decoder.pipeline_microbatches": 4}


def _config(dropout=0.0, **extra):
    cfg = JaxTransformer.build_model_args_by_name("transformer_64_2e_2d_4h")
    params = dict(cfg["model.params"], dtype="float32", **extra)
    params["modality.share_embedding_and_softmax_weights"] = True
    for side in ("encoder", "decoder"):
        for rate in ("attention_dropout_rate", "ffn_dropout_rate",
                     "layer_postprocess_dropout_rate"):
            params[f"{side}.{rate}"] = dropout
    return dict(cfg, **{"model.params": params})


def _batch(rng):
    src_len = rng.randint(2, L + 1, B)
    trg_len = rng.randint(2, L + 1, B)
    pos = np.arange(L)[None]
    return {"src": rng.randint(4, 32, (B, L)).astype(np.int32),
            "src_padding": (pos >= src_len[:, None]).astype(np.float32),
            "trg_input": rng.randint(4, 32, (B, L)).astype(np.int32),
            "trg": rng.randint(4, 32, (B, L)).astype(np.int32),
            "trg_padding": (pos >= trg_len[:, None]).astype(np.float32)}


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_params(tree).items()}


def _jax_steps(jm, params, batches):
    crit = JaxCriterion({"label_smoothing": 0.1})
    tx = jax_chain(JaxAdam(OPT), LR, clip_norm=1.0)

    def device(b):
        return {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(p, batch):
        out, aux = jm.call_train(p, batch)
        return crit.reduce_loss(batch, out) + aux

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params,
                                                        device(batches[0]))
    step = jax.jit(jax_make_train_step(jm, crit, tx))
    state = JaxTrainState.create(params, tx)
    metrics = []
    for b in batches:
        state, m = step(state, device(b), jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"loss": float(loss), "grads": _flat(grads), "metrics": metrics,
            "params": _flat(state.params)}


def _ring_inputs(seed, t):
    rng = np.random.RandomState(seed)
    shape = (2, t, 2, 8)
    return {"q": rng.randn(*shape).astype(np.float32),
            "k": rng.randn(*shape).astype(np.float32),
            "v": rng.randn(*shape).astype(np.float32),
            "cot": rng.randn(*shape).astype(np.float32),
            "lengths": np.array([t, t - 5], np.int32)}


def _jax_ring(inp, devices, causal):
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:devices]), ("data",))

    def f(q, k, v):
        out = jax_ring(q, k, v, mesh=mesh, seq_axis="data",
                       lengths=jnp.asarray(inp["lengths"]), causal=causal)
        return jnp.sum(out * inp["cot"]), out

    (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2),
                                                 has_aux=True))(
        inp["q"], inp["k"], inp["v"])
    return {"out": np.asarray(out), "dq": np.asarray(grads[0]),
            "dk": np.asarray(grads[1]), "dv": np.asarray(grads[2])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario on 2 and 4 ranks, and the references."""
    rng = np.random.RandomState(0)
    batches = [_batch(rng), _batch(rng)]
    jm = jax_build(_config(), src_meta=META, trg_meta=META)
    params = jm.init_params(jax.random.PRNGKey(0))
    jm_pipe = jax_build(_config(**PIPE), src_meta=META, trg_meta=META)
    params_pipe = jm_pipe.init_params(jax.random.PRNGKey(0))
    flat = _flat(params)
    data = {"meta": META, "flat": flat, "flat_pipe": _flat(params_pipe),
            "b0": batches[0], "b1": batches[1], "opt": OPT, "lr": LR,
            "ring8": _ring_inputs(1, 8), "ring16": _ring_inputs(2, 16)}
    both = ["b0", "b1"]
    step = {"kind": "step", "params": "flat", "batches": both}
    two = [
        dict(step, id="dp", cfg=_config()),
        dict(step, id="dp_drop", cfg=_config(0.1), dropout=True),
        dict(step, id="uc2", cfg=_config(), update_cycle=2),
        dict(step, id="tp", cfg=_config(), tp=2, logits=True),
        dict(step, id="ring", cfg=_config(
            **{"encoder.enable_ring_attention": True}), logits=True),
        dict(step, id="pp", cfg=_config(**PIPE), pp=2, params="flat_pipe"),
        dict(step, id="pp_uc2", cfg=_config(**PIPE), pp=2,
             params="flat_pipe", update_cycle=2, steps=0),
        dict(step, id="pp_drop", cfg=_config(0.1, **PIPE), pp=2,
             dropout=True),
        {"id": "ring_op", "kind": "ring", "inputs": "ring8",
         "causal": False},
        {"id": "ring_op_causal", "kind": "ring", "inputs": "ring8",
         "causal": True}]
    four = [
        dict(step, id="dp", cfg=_config()),
        dict(step, id="dp_tp", cfg=_config(), tp=2),
        dict(step, id="dp_pp", cfg=_config(**PIPE), pp=2,
             params="flat_pipe", steps=0),
        dict(step, id="pp_tp", cfg=_config(**PIPE), pp=2, tp=2,
             params="flat_pipe", steps=0),
        {"id": "ring_op", "kind": "ring", "inputs": "ring16",
         "causal": False},
        {"id": "ring_op_causal", "kind": "ring", "inputs": "ring16",
         "causal": True}]
    root = tmp_path_factory.mktemp("parallel")
    # the groups run while the JAX side computes
    groups = {"two": start_group(2, str(root / "two"), two, data),
              "four": start_group(4, str(root / "four"), four, data)}
    out = {}
    out["jax"] = _jax_steps(jm, params, batches)
    crit = JaxCriterion({"label_smoothing": 0.1})

    def loss_fn(p, batch):
        o, aux = jm_pipe.call_train(p, batch)
        return crit.reduce_loss(batch, o) + aux

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        params_pipe, {k: jnp.asarray(v) for k, v in batches[0].items()})
    out["jax_pipe"] = {"loss": float(loss),
                       "grads": unstack_scan_layers(_flat(grads))}
    out["jax_logits"] = np.asarray(jm.call(
        params, {k: jnp.asarray(v) for k, v in batches[0].items()}))
    for devices, name in ((2, "ring8"), (4, "ring16")):
        for causal in (False, True):
            out[f"jax_{name}_{causal}"] = _jax_ring(data[name], devices,
                                                    causal)
    # the port's single rank with dropout (the same scenarios, no group)
    for sid, cfg, pflat in (("dp_drop", _config(0.1), "flat"),
                            ("pp_drop", _config(0.1, **PIPE), "flat")):
        out[f"single_{sid}"] = run_step(dict(step, cfg=cfg, params=pflat,
                                             dropout=True), data)
    out.update({name: wait_group(g) for name, g in groups.items()})
    return out


def _check_grads(grads, ref, tol=GRAD_TOL):
    assert sorted(grads) == sorted(ref)
    for name, want in ref.items():
        err = float(np.abs(grads[name] - want).max())
        assert err <= tol * float(np.abs(want).max()) + 1e-9, name


def _check_run(got, ref, loss_tol=TOL, grad_tol=GRAD_TOL, steps=True):
    assert abs(got["loss"] - ref["loss"]) <= loss_tol * abs(ref["loss"])
    _check_grads(got["grads"], ref["grads"], grad_tol)
    if not steps:
        return
    for m, r in zip(got["metrics"], ref["metrics"]):
        assert abs(m["loss"] - r["loss"]) <= loss_tol * abs(r["loss"])
        assert abs(m["grad_norm"] - r["grad_norm"]) \
            <= loss_tol * abs(r["grad_norm"])
    for name, want in ref["params"].items():
        assert float(np.abs(got["params"][name] - want).max()) \
            <= 2 * 2 * LR, name


def _same_on_every_rank(results, sid):
    for res in results[1:]:
        assert res[sid]["loss"] == results[0][sid]["loss"]
        for name, v in results[0][sid]["params"].items():
            np.testing.assert_array_equal(res[sid]["params"][name], v)


@pytest.mark.parametrize("group,sid", [("two", "dp"), ("four", "dp"),
                                       ("two", "tp"), ("four", "dp_tp"),
                                       ("two", "ring")])
def test_step_matches_jax(runs, group, sid):
    """Loss, gradients, both steps' metrics and the weights after them
    equal the JAX single-device step on the global batch, and every rank
    ends with the same weights."""
    _check_run(runs[group][0][sid], runs["jax"])
    _same_on_every_rank(runs[group], sid)


def test_update_cycle_matches_jax(runs):
    """Two micro-batches a rank give the JAX step on the whole batch (the
    accumulated sums are normalized once by the global token count)."""
    _check_run(runs["two"][0]["uc2"], runs["jax"])
    _same_on_every_rank(runs["two"], "uc2")


def test_tensor_parallel_logits_match_jax(runs):
    np.testing.assert_allclose(runs["two"][0]["tp"]["logits"],
                               runs["jax_logits"], rtol=0, atol=1e-4)


def test_ring_encoder_inference_logits_match_jax(runs):
    """A ring-attention model's inference forward over whole sequences on
    each rank (``parallel.sharding.whole_model``, as the trainer's
    validator runs it): the JAX model's logits on every rank."""
    for res in runs["two"]:
        np.testing.assert_allclose(res["ring"]["logits"], runs["jax_logits"],
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("group,sid", [("two", "pp"), ("two", "pp_uc2"),
                                       ("four", "dp_pp"), ("four", "pp_tp")])
def test_pipeline_matches_jax_pipelined_model(runs, group, sid):
    """pp 2 (M 4) from the JAX pipelined model's [S, P, ...] weights, alone,
    with ``update_cycle`` 2, and composed with dp 2 and with tp 2: the
    loss and every gradient (per-layer names) of its first step."""
    _check_run(runs[group][-1][sid], runs["jax_pipe"], steps=False)
    if sid == "pp":
        _same_on_every_rank(runs[group], sid)


@pytest.mark.parametrize("group,sid", [("two", "pp"), ("four", "dp_pp"),
                                       ("four", "pp_tp")])
def test_pipeline_stage_holds_its_layers_only(runs, group, sid):
    """Each stage's ranks hold the layers of their stage and every
    parameter outside the pipelined stacks' layers; no other."""
    tp = 2 if sid == "pp_tp" else 1
    for rank, res in enumerate(runs[group]):
        stage = rank // tp % 2  # ranks laid out as reshape(dp, pp, tp)
        names = res[sid]["held"]
        layers = [n for n in names if ".layer_" in n]
        assert len(names) > len(layers)
        # two layers a stack over two stages: layer i on stage i
        assert sorted({n.split(".")[0] + n.split(".")[1] for n in layers}) \
            == [f"decoderlayer_{stage}", f"encoderlayer_{stage}"]


@pytest.mark.parametrize("sid", ["dp_drop", "pp_drop"])
def test_dropout_matches_single_rank(runs, sid):
    """With dropout 0.1 every rank draws its rows' masks of the single-rank
    step: the loss and gradients agree to float32 rounding."""
    got = runs["two"][0 if sid == "dp_drop" else 1][sid]
    ref = runs[f"single_{sid}"]
    _check_run(got, ref, loss_tol=1e-6, grad_tol=1e-5)


@pytest.mark.parametrize("group,name", [("two", "ring8"),
                                        ("four", "ring16")])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(runs, group, name, causal):
    got = runs[group][0]["ring_op_causal" if causal else "ring_op"]
    ref = runs[f"jax_{name}_{causal}"]
    for key in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("rows,shape", [(2, (4, 3, 8)), (1, (6, 2, 5, 4)),
                                        (3, (8, 16))])
def test_shard_masks_are_the_single_rank_masks(rows, shape):
    """A key moved ``rows`` batch rows on draws, bitwise, those rows of the
    whole tensor's mask (the dropout kernel's plain version), also when
    the site's tensor has its batch and time rows flattened into one."""
    threshold, _ = threshold_and_scale(0.3, False)
    key = make_key(11)
    whole = dropout_keep_mask(shape, key, threshold)
    part_key = at_row(key, rows, shape[0] - rows)
    part = dropout_keep_mask((shape[0] - rows,) + shape[1:], part_key,
                             threshold)
    assert torch.equal(part, whole[rows:])
    flat = dropout_keep_mask((part.numel() // shape[-1], shape[-1]),
                             part_key, threshold)
    assert torch.equal(flat, whole[rows:].reshape(flat.shape))


def test_tensor_parallel_masks_are_independent():
    """Folding a model coordinate into a key gives each rank its own
    mask at the site's rate, uncorrelated with the other ranks'."""
    rate = 0.25
    threshold, _ = threshold_and_scale(rate, False)
    key = make_key(3)
    masks = [dropout_keep_mask((64, 4096), at_shard(key, r), threshold)
             .float() for r in range(4)]
    for m in masks:
        assert abs(float(m.mean()) - (1 - rate)) < 5e-3
    for i in range(4):
        for j in range(i + 1, 4):
            a, b = masks[i] - masks[i].mean(), masks[j] - masks[j].mean()
            corr = float((a * b).mean() / (a.std() * b.std()))
            assert abs(corr) < 0.01
            assert not torch.equal(masks[i], masks[j])
