"""Expert parallelism and the MoE balance loss over data ranks, on gloo
CPU process groups, against the JAX package's single-device step.

A small Transformer (d 32, 2 + 2 layers, 4 heads, vocabulary 32,
float32, TF32 off) with an MoE FFN in every second layer of both stacks
(``router_jitter`` 0) gets one set of 0.5 x normal weights; two
numpy-seeded global batches of 8 rows go through the JAX step on one
device and through the port on 2 and 4 ranks
(``tests/torch_parallel_worker.py``: one spawned group a size runs every
scenario, while the JAX side computes here).  Compared: the loss and the
aux loss (1e-5), every gradient (1e-4 of its largest value), the metrics
and the weights after two Adam steps (clip norm 1), of

* the balance loss with 3 experts over 2 data ranks (experts replicated:
  3 does not divide 2): the counts and router probabilities summed over
  the data group give the global batch's loss and router gradients;
* experts split over the data ranks: E 4 top-1 and E 8 top-2 on 2 and 4
  ranks, ``update_cycle`` 2, and dp 2 x tp 2;

and beam search over 2 and 4 ranks with the experts split (rows sharded
where they divide the ranks, else replicated; ranks whose search ends
first serve their experts to the others) against the port's one-rank
search; the orbax checkpoint of tp 2 and of dp 2 x tp 2, each rank
writing its hyperslabs, read by the JAX package bitwise;
``collectives.all_to_all`` forward and backward; the expert
dropout site of a split layer: masks at the site's rate, independent
across ranks (a kept difference: not the one-rank masks).
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
from neurst_tpu.optimizers.optimizers import Adam as JaxAdam  # noqa: E402
from neurst_tpu.optimizers.optimizers import \
    create_optax_chain as jax_chain  # noqa: E402
from neurst_tpu.parallel.train_step import \
    TrainState as JaxTrainState  # noqa: E402
from neurst_tpu.parallel.train_step import \
    make_train_step as jax_make_train_step  # noqa: E402
from neurst_tpu.utils.checkpoints import flatten_params  # noqa: E402

import neurst_tpu_torch  # noqa: E402
from neurst_tpu_torch.layers.moe import expert_rank_key  # noqa: E402
from neurst_tpu_torch.ops.fused_dropout import (  # noqa: E402
    dropout_keep_mask, threshold_and_scale)
from neurst_tpu_torch.utils.param_bridge import load_flat_params  # noqa: E402
from neurst_tpu_torch.utils.rng import at_row, make_key  # noqa: E402
from torch_parallel_worker import start_group, wait_group  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

META = {"vocab_size": 32, "eos_id": 1, "bos_id": 2, "unk_id": 3}
OPT = {"beta_1": 0.9, "beta_2": 0.98, "epsilon": 1e-9}
LR = 1e-3
B, L = 8, 8
TOL, GRAD_TOL = 1e-5, 1e-4
SEARCH = {"beam_size": 3, "maximum_decode_length": 8,
          "extra_decode_length": 4, "length_penalty": 0.6}
RATES = ("attention_dropout_rate", "ffn_dropout_rate",
         "layer_postprocess_dropout_rate")


def _config(experts, top_k, dropout=0.0, stages=1):
    cfg = JaxTransformer.build_model_args_by_name("transformer_32_2e_2d_4h")
    params = dict(cfg["model.params"], dtype="float32")
    params["modality.share_embedding_and_softmax_weights"] = True
    for side in ("encoder", "decoder"):
        params.update({f"{side}.{rate}": dropout for rate in RATES})
        params.update({f"{side}.moe_num_experts": experts,
                       f"{side}.moe_layer_frequency": 2,
                       f"{side}.moe_top_k": top_k,
                       f"{side}.moe_router_jitter": 0.0,
                       f"{side}.pipeline_stages": stages})
    return dict(cfg, **{"model.params": params})


def _batch(rng, rows=B):
    src_len = rng.randint(2, L + 1, rows)
    trg_len = rng.randint(2, L + 1, rows)
    pos = np.arange(L)[None]
    return {"src": rng.randint(4, 32, (rows, L)).astype(np.int32),
            "src_padding": (pos >= src_len[:, None]).astype(np.float32),
            "trg_input": rng.randint(4, 32, (rows, L)).astype(np.int32),
            "trg": rng.randint(4, 32, (rows, L)).astype(np.int32),
            "trg_padding": (pos >= trg_len[:, None]).astype(np.float32)}


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_params(tree).items()}


def _weights(jm, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda v: (0.5 * rng.randn(*v.shape)).astype(np.float32),
        jax.jit(jm.init_params)(jax.random.PRNGKey(0)))


def _jax_steps(jm, params, batches, update_cycle=1):
    """The JAX step's loss and gradients of the first batch and two Adam
    steps; with ``update_cycle`` > 1 each batch is that many
    micro-batches of its rows (the aux loss of each micro-batch weighted
    by its tokens)."""
    crit = JaxCriterion({"label_smoothing": 0.1})
    tx = jax_chain(JaxAdam(OPT), LR, clip_norm=1.0)
    uc = update_cycle

    def device(b):
        return {k: jnp.asarray(v.reshape((uc, -1) + v.shape[1:])
                               if uc > 1 else v) for k, v in b.items()}

    def loss_fn(p, batch):
        if uc == 1:
            out, aux = jm.call_train(p, batch)
            return crit.reduce_loss(batch, out) + aux
        total = denom = 0.0
        for i in range(uc):
            micro = {k: v[i] for k, v in batch.items()}
            out, aux = jm.call_train(p, micro)
            loss_sum, d = crit.reduce_loss_terms(micro, out)
            total, denom = total + loss_sum + aux * d, denom + d
        return total / denom

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params,
                                                        device(batches[0]))
    step = jax.jit(jax_make_train_step(jm, crit, tx, update_cycle=uc))
    state = JaxTrainState.create(params, tx)
    metrics = []
    for b in batches:
        state, m = step(state, device(b), jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"loss": float(loss), "grads": _flat(grads), "metrics": metrics,
            "params": _flat(state.params)}


# (experts, top_k) of each model
MODELS = {"e3": (3, 1), "e4": (4, 1), "e8": (8, 2)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.RandomState(0)
    batches = [_batch(rng), _batch(rng)]
    data = {"meta": META, "b0": batches[0], "b1": batches[1], "opt": OPT,
            "lr": LR, "d8": _batch(rng), "d3": _batch(rng, 3),
            "a2a": {"x": rng.randn(4, 8, 6, 3).astype(np.float32),
                    "cot": rng.randn(4, 8, 24, 3).astype(np.float32)}}
    jms, params = {}, {}
    for name, (e, k) in MODELS.items():
        jms[name] = jax_build(_config(e, k), src_meta=META, trg_meta=META)
        params[name] = _weights(jms[name], 1)
        data[name] = _flat(params[name])
    data["dense"] = _flat(_weights(jax_build(_config(0, 1), src_meta=META,
                                             trg_meta=META), 1))
    step = {"kind": "step", "batches": ["b0", "b1"]}
    decode = {"kind": "decode", "cfg": _config(4, 1), "params": "e4",
              "search": SEARCH, "batches": ["d8", "d3"]}
    a2a = {"id": "a2a", "kind": "a2a", "inputs": "a2a"}
    root = tmp_path_factory.mktemp("expert_parallel")
    orbax = {"kind": "orbax", "cfg": _config(4, 1), "params": "e4"}
    two = [dict(step, id="bal", cfg=_config(3, 1), params="e3"),
           dict(step, id="e4", cfg=_config(4, 1), params="e4"),
           dict(step, id="e8", cfg=_config(8, 2), params="e8"),
           dict(step, id="uc2", cfg=_config(4, 1), params="e4",
                update_cycle=2),
           dict(step, id="drop", cfg=_config(4, 1, 0.1), params="e4",
                dropout=True),
           dict(decode, id="decode"), a2a,
           dict(orbax, id="orbax_tp", tp=2, dir=str(root / "orbax_tp"))]
    four = [dict(step, id="e4", cfg=_config(4, 1), params="e4"),
            dict(step, id="e8", cfg=_config(8, 2), params="e8"),
            dict(step, id="dp_tp", cfg=_config(4, 1), params="e4", tp=2),
            dict(decode, id="decode"), a2a,
            dict(orbax, id="orbax_dp_tp", tp=2,
                 dir=str(root / "orbax_dp_tp")),
            dict(orbax, id="orbax_pp_tp", tp=2, pp=2, params="dense",
                 cfg=_config(0, 1, stages=2),
                 dir=str(root / "orbax_pp_tp"))]
    groups = {"two": start_group(2, str(root / "two"), two, data),
              "four": start_group(4, str(root / "four"), four, data)}
    out = {name: _jax_steps(jms[name], params[name], batches)
           for name in MODELS}
    out["e4_uc2"] = _jax_steps(jms["e4"], params["e4"], batches, 2)
    # the port's one-rank beam search
    model = neurst_tpu_torch.build_model(_config(4, 1), src_meta=META,
                                         trg_meta=META, device="cpu")
    load_flat_params(model, data["e4"])
    search = neurst_tpu_torch.build_search_layer(
        {"search_method.class": "beam_search",
         "search_method.params": SEARCH})
    search.set_model(model)
    out["decode"] = {
        name: search({k: v for k, v in data[name].items()
                      if k.startswith("src")})[0].tolist()
        for name in ("d8", "d3")}
    out["a2a"] = data["a2a"]
    out["e4_weights"], out["dense_weights"] = data["e4"], data["dense"]
    out.update({name: wait_group(g) for name, g in groups.items()})
    return out


def _check_grads(grads, ref, tol=GRAD_TOL):
    assert sorted(grads) == sorted(ref)
    for name, want in ref.items():
        err = float(np.abs(grads[name] - want).max())
        assert err <= tol * float(np.abs(want).max()) + 1e-9, name


def _check_run(got, ref):
    assert abs(got["loss"] - ref["loss"]) <= TOL * abs(ref["loss"])
    _check_grads(got["grads"], ref["grads"])
    for m, r in zip(got["metrics"], ref["metrics"]):
        for key in ("loss", "aux_loss", "grad_norm"):
            assert abs(m[key] - r[key]) <= TOL * abs(r[key]), key
    for name, want in ref["params"].items():
        assert float(np.abs(got["params"][name] - want).max()) \
            <= 2 * 2 * LR, name


def _same_on_every_rank(results, sid):
    for res in results[1:]:
        assert res[sid]["loss"] == results[0][sid]["loss"]
        for name, v in results[0][sid]["params"].items():
            np.testing.assert_array_equal(res[sid]["params"][name], v)


def test_balance_loss_is_the_global_batchs(runs):
    """3 experts on 2 data ranks (replicated): the aux loss, the loss and
    the router's gradients are those of the global batch, on every
    rank."""
    ref = runs["e3"]
    for res in runs["two"]:
        got = res["bal"]
        for m, r in zip(got["metrics"], ref["metrics"]):
            assert m["aux_loss"] > 0.0
            assert abs(m["aux_loss"] - r["aux_loss"]) \
                <= TOL * r["aux_loss"]
        routers = {k: v for k, v in ref["grads"].items()
                   if k.endswith("router_kernel")}
        assert len(routers) == 2
        _check_grads({k: got["grads"][k] for k in routers}, routers)
        assert all(shape[0] == 3 for shape in got["experts"].values())
    _check_run(runs["two"][0]["bal"], ref)


@pytest.mark.parametrize("group,sid,model", [
    ("two", "e4", "e4"), ("two", "e8", "e8"), ("four", "e4", "e4"),
    ("four", "e8", "e8"), ("four", "dp_tp", "e4")])
def test_expert_parallel_step_matches_jax(runs, group, sid, model):
    """Experts split over the data ranks: loss, aux loss, gradients, both
    steps' metrics and the weights after them equal the JAX single-device
    step on the global batch, and every rank ends with the same
    weights."""
    _check_run(runs[group][0][sid], runs[model])
    _same_on_every_rank(runs[group], sid)


def test_expert_parallel_update_cycle_matches_jax(runs):
    """Two micro-batches of the global batch's rows, each split over the
    2 data ranks: the JAX step with ``update_cycle`` 2 (each micro-batch's
    balance loss over its global rows)."""
    _check_run(runs["two"][0]["uc2"], runs["e4_uc2"])
    _same_on_every_rank(runs["two"], "uc2")


@pytest.mark.parametrize("group,sid,experts", [
    ("two", "e4", 4), ("two", "e8", 8), ("four", "e4", 4),
    ("four", "e8", 8), ("four", "dp_tp", 4)])
def test_each_data_rank_holds_its_experts(runs, group, sid, experts):
    dp = 2 if sid == "dp_tp" or group == "two" else 4
    for res in runs[group]:
        shapes = res[sid]["experts"]
        assert len(shapes) == 8  # 2 MoE layers x 4 expert tensors
        assert all(s[0] == experts // dp for s in shapes.values())


def test_expert_parallel_dropout_step_runs(runs):
    """With dropout 0.1 (every site, the experts' included) the EP step
    trains and keeps the replicated weights equal on every rank."""
    got = runs["two"][0]["drop"]
    assert np.isfinite(got["loss"])
    assert all(np.isfinite(m["loss"]) for m in got["metrics"])
    _same_on_every_rank(runs["two"], "drop")


@pytest.mark.parametrize("group", ["two", "four"])
@pytest.mark.parametrize("batch", ["d8", "d3"])
def test_expert_parallel_decode_equals_one_rank(runs, group, batch):
    """Rows sharded (8) or replicated (3 rows): every hypothesis equals
    the one-rank search's up to its first EOS, on every rank (a shard's
    search may stop before the whole batch's, which fills the rest with
    EOS)."""
    def upto_eos(hyps):
        return [h[:h.index(1) + 1] if 1 in h else h for h in hyps]

    want = upto_eos(runs["decode"][batch])
    for res in runs[group]:
        assert upto_eos(res["decode"][batch]) == want


@pytest.mark.parametrize("group", ["two", "four"])
def test_all_to_all_forward_and_backward(runs, group):
    """Rank r's [4, 8, 6, 3] input ``x + r`` split along dim 0 and joined
    along dim 2: rank r gets block r of every rank's input, and the
    gradient of sum(out x cot_r) (``cot_r = cot + 10 r``) is the reverse
    all-to-all of the cotangents."""
    x = runs["a2a"]["x"]
    n = 2 if group == "two" else 4
    xs = [x + r for r in range(n)]
    cots = [runs["a2a"]["cot"][:4 // n, :, :6 * n] + 10 * r
            for r in range(n)]
    for r, res in enumerate(runs[group]):
        want = np.concatenate([np.split(xr, n, axis=0)[r] for xr in xs],
                              axis=2)
        np.testing.assert_array_equal(res["a2a"]["out"], want)
        want_grad = np.concatenate([np.split(c, n, axis=2)[r]
                                    for c in cots], axis=0)
        np.testing.assert_array_equal(res["a2a"]["grad"], want_grad)


@pytest.mark.parametrize("group,sid", [("two", "orbax_tp"),
                                       ("four", "orbax_dp_tp"),
                                       ("four", "orbax_pp_tp")])
def test_sharded_orbax_checkpoint_is_read_by_jax_bitwise(runs, group, sid):
    """tp 2 (heads, filters, vocabulary over "model"), dp 2 x tp 2 (the
    experts over "data" too) and pp 2 x tp 2 (a dense model's layers on
    their stages): each rank writes the hyperslabs of the JAX layout its
    shards are, without gathering them, and the JAX package's
    ``restore_checkpoint_orbax`` reads the one-rank weights bitwise."""
    from neurst_tpu.utils.orbax_checkpoints import restore_checkpoint_orbax
    path = runs[group][0][sid]["path"]
    got = _flat(restore_checkpoint_orbax(path))
    want = runs["dense_weights" if sid == "orbax_pp_tp" else "e4_weights"]
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    keys = [set(res[sid]["keys"]) for res in runs[group]]
    # a kernel split over "model": one chunk from each model rank
    qkv = "encoder.layer_0.self_attention.qkv_transform.kernel"
    assert f"{qkv}/0.0.0.0" in keys[0] and f"{qkv}/0.0.1.0" in keys[1]
    if sid == "orbax_pp_tp":
        # layer 1 on stage 1 (ranks 2 and 3 of the stage-major mesh)
        qkv1 = qkv.replace("layer_0", "layer_1")
        assert f"{qkv1}/0.0.0.0" in keys[2] and f"{qkv1}/0.0.1.0" in keys[3]
        assert not any(k.startswith(qkv1) for k in keys[0] | keys[1])
    if sid == "orbax_dp_tp":
        # the experts over "data": ranks 0 and 2 (model coordinate 0);
        # rank 3 (data 1, model 1) owns no chunk and writes no store
        experts = "encoder.layer_1.ffn.expert_dense1_kernel"
        assert f"{experts}/0.0.0" in keys[0]
        assert f"{experts}/1.0.0" in keys[2]
        assert not any(k.startswith(experts) for k in keys[1] | keys[3])
        assert not keys[3]
    # a replicated tensor: once, by rank 0
    emb = "src_embedding.weights"
    assert not any(k.startswith(emb) for k in set().union(*keys[1:]))


@pytest.mark.parametrize("rows,shards", [(2, 3), (3, 2), (1, 6)])
def test_router_jitter_of_a_shard_is_its_rows_of_the_batch(rows, shards):
    """A data-parallel rank's key (``at_row``) draws its rows of the
    one-rank router noise, also where the row offset is no multiple of 4
    elements (E 3)."""
    from neurst_tpu_torch.layers.moe import router_jitter_noise
    key = make_key(3)
    whole = router_jitter_noise((rows * shards, 5, 3), 0.01, key)
    for r in range(shards):
        part = router_jitter_noise((rows, 5, 3), 0.01,
                                   at_row(key, r * rows, rows, shards))
        assert torch.equal(part, whole[r * rows:(r + 1) * rows])


def test_expert_dropout_masks_are_independent_across_ranks():
    """A split expert site drops its key's row offset and folds the data
    coordinate in: each rank's mask at the site's rate, uncorrelated with
    the others' and not the one-rank tensor's."""
    rate = 0.25
    threshold, _ = threshold_and_scale(rate, False)
    key = at_row(make_key(5), 4, 4, 2)
    masks = [dropout_keep_mask((64, 4096), expert_rank_key(key, r),
                               threshold).float() for r in range(4)]
    for m in masks:
        assert abs(float(m.mean()) - (1 - rate)) < 5e-3
    for i in range(4):
        for j in range(i + 1, 4):
            a, b = masks[i] - masks[i].mean(), masks[j] - masks[j].mean()
            corr = float((a * b).mean() / (a.std() * b.std()))
            assert abs(corr) < 0.01
    assert expert_rank_key(None, 1) is None
