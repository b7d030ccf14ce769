"""Mixture of experts of the port (``neurst_tpu_torch/layers/moe.py`` and
the ``moe_*`` fields of the transformer stacks) against the JAX package's
(``neurst_tpu/layers/moe.py``), on the CPU in float32.

Held against JAX, with ``router_jitter`` 0 (the port draws its jitter
from its own Philox stream, a kept difference):

- ``MoeFFN`` alone at top-1 and top-2, with the recipes' capacity
  factor, with one that drops tokens, and in evaluation below and above
  T = 16 (dropless routing for short windows): outputs and the aux loss
  within 1e-5, the gradients of every parameter and of the input within
  1e-5 of their largest value;
- the Switch (top-1) and GShard (top-2) Transformers of
  ``examples/moe`` at test width (2 + 2 layers, d 32, 4 experts): the
  flat names and shapes, logits, the loss with the aux loss and every
  gradient, also with ``update_cycle`` 2 (the aux loss weighted by
  tokens), and beam hypotheses identical;
- a JAX ``scan_layers`` MoE checkpoint (the block-scan layout) through
  ``param_bridge``: the port's logits equal the JAX model's, and the
  port's per-layer npz restores into the JAX scan model;
- both CLIs on ``tests/examples/example_train_moe.yml``: 10 train steps
  from one JAX ckpt-0 (losses within 1e-5 relative, every weight within
  2 lr; attention key biases, whose gradient is rounding noise, within 2
  x the summed lr) and predict from the port's dir with identical
  hypotheses (the JAX side in one subprocess).

And the router jitter's noise: inside [1 - eps, 1 + eps), mean 1 within
5 sigma, the same for the same key and none in evaluation.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

import port_test_support  # noqa: F401  (one torch thread per worker)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax.core import meta as flax_meta  # noqa: E402

from neurst_tpu.criterions.criterion import \
    build_criterion as jax_build_criterion  # noqa: E402
from neurst_tpu.layers.moe import MoeFFN as JaxMoeFFN  # noqa: E402
from neurst_tpu.layers.search.sequence_search import \
    build_search_layer as jax_build_search  # noqa: E402
from neurst_tpu.models.model import build_model as jax_build  # noqa: E402
from neurst_tpu.models.transformer import \
    Transformer as JaxTransformer  # noqa: E402
from neurst_tpu.parallel.train_step import \
    TrainState as JaxTrainState  # noqa: E402
from neurst_tpu.parallel.train_step import \
    make_train_step as jax_make_train_step  # noqa: E402
from neurst_tpu.tasks.task import build_task as jax_build_task  # noqa: E402
from neurst_tpu.utils import checkpoints as jax_ckpt  # noqa: E402
from neurst_tpu.utils.checkpoints import flatten_params  # noqa: E402

import neurst_tpu_torch  # noqa: E402
from neurst_tpu_torch.cli import run_exp as port_run_exp  # noqa: E402
from neurst_tpu_torch.criterions import build_criterion  # noqa: E402
from neurst_tpu_torch.exps import trainer as port_trainer  # noqa: E402
from neurst_tpu_torch.layers.moe import (MoeFFN,  # noqa: E402
                                         collect_aux_losses,
                                         router_jitter_noise)
from neurst_tpu_torch.parallel import make_train_step  # noqa: E402
from neurst_tpu_torch.utils import checkpoints as port_ckpt  # noqa: E402
from neurst_tpu_torch.utils.param_bridge import (  # noqa: E402
    flat_to_state_dict, load_flat_params, state_dict_to_flat)
from neurst_tpu_torch.utils.rng import make_key  # noqa: E402

from port_test_support import (JAX_CLI_SIDE, REPO,  # noqa: E402
                               TrainerLossLog, start_jax_side)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5
H, F, E = 16, 32, 4
META = ({"vocab_size": 40, "eos_id": 1, "bos_id": 2, "unk_id": 3},
        {"vocab_size": 48, "eos_id": 1, "bos_id": 2, "unk_id": 3})
CRITERION = {"criterion.class": "label_smoothed_cross_entropy",
             "criterion.params": {"label_smoothing": 0.1}}
SEARCH = {"beam_size": 3, "maximum_decode_length": 8,
          "extra_decode_length": 4, "length_penalty": 0.6,
          "decode_unroll": 1, "prefix_decode_chunk": 0}
RATES = ("attention_dropout_rate", "ffn_dropout_rate",
         "layer_postprocess_dropout_rate")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(ours, ref, tol=TOL):
    ref = np.asarray(ref)
    return float(np.abs(_np(ours) - ref).max()) <= tol * max(
        1.0, float(np.abs(ref).max()))


# --------------------------------------------------------- the layer

# (top_k, capacity_factor, training, tokens)
LAYER_CASES = {
    "top1": (1, 1.25, True, 12), "top2": (2, 1.25, True, 12),
    "top1_drops": (1, 0.5, True, 12), "top2_drops": (2, 0.5, True, 12),
    "eval_short": (2, 0.5, False, 16), "eval_long": (1, 1.25, False, 20)}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_ffn_output_aux_and_gradients(case):
    k, cf, training, t = LAYER_CASES[case]
    jl = JaxMoeFFN(num_experts=E, filter_size=F, output_size=H, top_k=k,
                   capacity_factor=cf, router_jitter=0.0)
    rng = np.random.RandomState(11)
    x = rng.randn(3, t, H).astype(np.float32)
    params = flax_meta.unbox(jl.init(jax.random.PRNGKey(0),
                                     jnp.asarray(x))["params"])
    w = rng.randn(3, t, H).astype(np.float32)

    def run(p, xx):
        y, variables = jl.apply({"params": p}, xx, is_training=training,
                                mutable=["losses"])
        aux = sum(jnp.sum(v) for v in
                  jax.tree_util.tree_leaves(variables.get("losses", {})))
        return y, aux

    y, aux = run(params, jnp.asarray(x))
    grads = jax.grad(lambda p, xx: jnp.sum(run(p, xx)[0] * w)
                     + run(p, xx)[1], argnums=(0, 1))(params, jnp.asarray(x))

    layer = MoeFFN(H, E, F, H, top_k=k, capacity_factor=cf,
                   router_jitter=0.0)
    flat = {n: np.asarray(v) for n, v in params.items()}
    with torch.no_grad():
        for name, p in layer.named_parameters():
            p.copy_(torch.from_numpy(np.array(flat[name])))
    tx = torch.tensor(x, requires_grad=True)
    with collect_aux_losses(layer) as sink:
        ty = layer(tx, is_training=training)
    taux = sink.total(tx.device)
    assert _close(ty, y)
    assert len(sink.losses) == int(training)
    assert abs(float(taux.detach()) - float(aux)) <= TOL * max(
        1.0, abs(float(aux)))
    ((ty * torch.from_numpy(w)).sum() + taux).backward()
    for name, p in layer.named_parameters():
        assert _close(p.grad, grads[0][name]), name
    assert _close(tx.grad, grads[1])
    if case.endswith("drops"):
        # some token got no expert: its output is exactly zero
        assert bool((ty.abs().sum(-1) == 0).any())
    if case == "eval_short":
        assert layer.capacity(t, False) == t


def test_router_jitter_noise_range_and_mean():
    eps = 0.01
    key = make_key(5)
    n = 200_000
    noise = router_jitter_noise((n,), eps, key)
    assert float(noise.min()) >= 1.0 - eps
    assert float(noise.max()) < 1.0 + eps
    sigma = 2 * eps / np.sqrt(12 * n)
    assert abs(float(noise.double().mean()) - 1.0) <= 5 * sigma
    assert torch.equal(noise, router_jitter_noise((n,), eps, key))
    assert not torch.equal(noise, router_jitter_noise((n,), eps,
                                                      make_key(6)))


def test_router_jitter_needs_a_key_in_training_only():
    layer = MoeFFN(H, E, F, H, router_jitter=0.01)
    layer.init_own_params(torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, H)
    with pytest.raises(ValueError, match="dropout key"):
        layer(x, is_training=True)
    a = layer(x, is_training=True, dropout_key=make_key(1))
    b = layer(x, is_training=True, dropout_key=make_key(1))
    assert torch.equal(a, b)
    # evaluation draws nothing
    assert torch.equal(layer(x), layer(x))


# --------------------------------------------------------- the model

def _cfg(top_k=1, scan=False):
    cfg = JaxTransformer.build_model_args_by_name("transformer_32_2e_2d_4h")
    params = dict(cfg["model.params"], dtype="float32")
    for side in ("encoder", "decoder"):
        params.update({f"{side}.{rate}": 0.0 for rate in RATES})
        params.update({f"{side}.moe_num_experts": E,
                       f"{side}.moe_layer_frequency": 2,
                       f"{side}.moe_top_k": top_k,
                       f"{side}.moe_router_jitter": 0.0})
        if scan:
            params[f"{side}.scan_layers"] = True
    return dict(cfg, **{"model.params": params})


def _batch(rng, n=4, length=12):
    lengths = np.asarray([length, 9, 5, length][:n])
    return {"src": rng.randint(4, 40, (n, length)).astype(np.int32),
            "src_padding": (np.arange(length)[None] >= lengths[:, None]
                            ).astype(np.float32),
            "trg_input": rng.randint(0, 48, (n, length)).astype(np.int32),
            "trg": rng.randint(0, 48, (n, length)).astype(np.int32),
            "trg_padding": (np.arange(length)[None] >= lengths[:, None]
                            ).astype(np.float32)}


@pytest.fixture(scope="module", params=[1, 2], ids=["switch", "gshard"])
def pair(request):
    cfg = _cfg(request.param)
    jm = jax_build(cfg, src_meta=META[0], trg_meta=META[1])
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda v: (0.5 * rng.randn(*v.shape)).astype(np.float32),
        jax.jit(jm.init_params)(jax.random.PRNGKey(0)))
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    tm = neurst_tpu_torch.build_model(cfg, src_meta=META[0],
                                      trg_meta=META[1], device="cpu")
    load_flat_params(tm, flat)
    return cfg, jm, params, tm, flat


def test_moe_model_names_and_logits(pair):
    _, jm, params, tm, flat = pair
    back = state_dict_to_flat(tm)
    assert sorted(back) == sorted(flat)
    assert all(back[k].shape == flat[k].shape for k in flat)
    assert "encoder/layer_1/ffn/router_kernel" in flat
    assert flat["decoder/layer_1/ffn/expert_dense1_kernel"].shape == (E, 32,
                                                                      128)
    assert "encoder/layer_0/ffn/dense1/kernel" in flat
    batch = _batch(np.random.RandomState(1))
    with torch.no_grad():
        assert _close(tm(batch), jax.jit(jm.call)(params, batch))


@pytest.mark.parametrize("update_cycle", [1, 2])
def test_moe_model_loss_aux_and_gradients(pair, update_cycle):
    _, jm, params, tm, _ = pair
    rng = np.random.RandomState(2)
    batch = _batch(rng)
    if update_cycle > 1:
        batch = {k: np.stack([v, _batch(rng)[k]]) for k, v in batch.items()}
        batch["trg_padding"][1, :, 7:] = 1.0
    crit = jax_build_criterion(CRITERION)
    import optax
    tx = optax.sgd(1.0)
    step = jax.jit(jax_make_train_step(jm, crit, tx,
                                       update_cycle=update_cycle))
    state, metrics = step(JaxTrainState.create(params, tx), batch,
                          jax.random.PRNGKey(0))
    jgrads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(
        b), params, state.params)
    tstep = make_train_step(tm, build_criterion(CRITERION), None,
                            update_cycle=update_cycle)
    loss, aux, grads = tstep.compute_grads(dict(tm.named_parameters()),
                                           batch)
    assert float(aux) > 0.0
    assert abs(float(loss) - float(metrics["loss"])) <= TOL * abs(
        float(metrics["loss"]))
    assert abs(float(aux) - float(metrics["aux_loss"])) <= TOL * abs(
        float(metrics["aux_loss"]))
    want = flat_to_state_dict({k: np.asarray(v) for k, v in
                               flatten_params(jgrads).items()}, tm)
    for name, ref in want.items():
        # SGD at lr 1 gives the gradient up to the update's rounding
        assert _close(grads[name], ref.numpy(), 1e-4), name


def test_moe_beam_hypotheses_match_jax(pair):
    _, jm, params, tm, _ = pair
    src = {k: v for k, v in _batch(np.random.RandomState(3)).items()
           if k in ("src", "src_padding")}
    jsearch = jax_build_search({"search_method.class": "beam_search",
                                "search_method.params": SEARCH})
    jsearch.set_model(jm)
    jh, _ = jsearch(params, src)
    tsearch = neurst_tpu_torch.build_search_layer(
        {"search_method.class": "beam_search",
         "search_method.params": SEARCH})
    tsearch.set_model(tm)
    th, _ = tsearch(src)
    assert _np(th).tolist() == np.asarray(jh).tolist()


def test_scan_layers_moe_checkpoint_through_the_bridge():
    cfg = _cfg(2, scan=True)
    jm = jax_build(cfg, src_meta=META[0], trg_meta=META[1])
    rng = np.random.RandomState(4)
    params = jax.tree_util.tree_map(
        lambda v: (0.5 * rng.randn(*v.shape)).astype(np.float32),
        jax.jit(jm.init_params)(jax.random.PRNGKey(1)))
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    assert any("/layers/block_layer_1/ffn/router_kernel" in k for k in flat)
    tm = neurst_tpu_torch.build_model(_cfg(2), src_meta=META[0],
                                      trg_meta=META[1], device="cpu")
    load_flat_params(tm, flat)
    batch = _batch(np.random.RandomState(5))
    with torch.no_grad():
        logits = tm(batch)
    assert _close(logits, jax.jit(jm.call)(params, batch))
    # the port's per-layer npz back into the JAX scan model
    restored, _, missing = jax_ckpt.restore_into(
        jax.jit(jm.init_params)(jax.random.PRNGKey(2)), state_dict_to_flat(tm))
    assert not missing
    assert _close(logits, jax.jit(jm.call)(restored, batch))


# ------------------------------------------------------- both CLIs

CLI_STEPS = 10


def _noam(step, dmodel=32, warmup=100):
    return dmodel ** -0.5 * min(step ** -0.5, step * warmup ** -1.5)


def _key_bias(name, value):
    if name.endswith("/qkv_transform/bias"):
        return value[1]
    if name.endswith("/kv_transform/bias"):
        return value[0]
    return None


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("moe_cli"))
    with open(os.path.join(REPO, "tests", "examples",
                           "example_train_moe.yml")) as f:
        cfg = json.loads(json.dumps(yaml.safe_load(f)).replace(
            '"tests/examples/', f'"{REPO}/tests/examples/'))
    cfg["task.params"]["shuffle_buffer"] = 0
    for side in ("encoder", "decoder"):
        cfg["model.params"][f"{side}.moe_router_jitter"] = 0.0
    cfg["entry.class"] = "trainer"
    cfg["entry.params"].update(
        train_steps=CLI_STEPS, save_checkpoint_steps=CLI_STEPS,
        summary_steps=1, enable_tensorboard=False)
    cfg_path = os.path.join(root, "moe.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    dirs = {side: os.path.join(root, side) for side in ("jax", "port")}
    train = ["--entry", "train", "--config_paths", cfg_path]
    predict = ["--entry", "predict", "--model_dir", dirs["port"],
               "--config_paths", os.path.join(
                   REPO, "tests", "examples", "example_predict_seq2seq.yml"),
               "--dataset.params", json.dumps({
                   "src_file": f"{REPO}/tests/examples/dev.src",
                   "trg_file": f"{REPO}/tests/examples/dev.trg"})]
    seeded = os.path.join(root, "seeded")
    ready = os.path.join(root, "port_trained")
    proc, log_path = start_jax_side(JAX_CLI_SIDE, root, "jax_side", [
        ["wait", seeded, None],
        ["train", train + ["--model_dir", dirs["jax"]],
         os.path.join(root, "jax_train.json")],
        ["wait", ready, None],
        ["predict", predict + ["--output_file",
                               os.path.join(root, "hyp.jax")],
         os.path.join(root, "jax_predict.json")]])
    out = {"root": root, "dirs": dirs}
    try:
        jtask = jax_build_task(cfg)
        jmodel = jtask.build_model({"model.class": cfg["model.class"],
                                    "model.params": cfg["model.params"]})
        seed_dir = os.path.join(root, "seed")
        jax_ckpt.save_checkpoint(seed_dir, 0, jax.tree_util.tree_map(
            np.asarray, jax.jit(jmodel.init_params)(jax.random.PRNGKey(1))))
        for d in dirs.values():
            shutil.copytree(seed_dir, d)
        open(seeded, "w").close()
        log = TrainerLossLog()
        trainer_logging, port_trainer.logging = port_trainer.logging, log
        try:
            port_run_exp.cli_main(train + ["--model_dir", dirs["port"],
                                           "--device", "cpu"])
        finally:
            port_trainer.logging = trainer_logging
        out["port_train"] = log.losses
        open(ready, "w").close()
        out["port_predict"] = port_run_exp.cli_main(
            predict + ["--output_file", os.path.join(root, "hyp.port"),
                       "--device", "cpu"])
        proc.wait(timeout=900)
    finally:
        proc.kill()
    with open(log_path) as f:
        assert proc.returncode == 0, f.read()[-4000:]
    for name in ("jax_train", "jax_predict"):
        with open(os.path.join(root, f"{name}.json")) as f:
            out[name] = json.load(f)
    return out


def test_moe_cli_training_matches_jax(cli):
    port, ref = cli["port_train"], cli["jax_train"]
    assert len(port) == len(ref) == CLI_STEPS
    np.testing.assert_allclose(port, ref, rtol=TOL)
    ours = port_ckpt.restore_checkpoint_params(os.path.join(
        cli["dirs"]["port"], f"ckpt-{CLI_STEPS}.npz"))
    want = jax_ckpt.restore_checkpoint_params(os.path.join(
        cli["dirs"]["jax"], f"ckpt-{CLI_STEPS}.npz"))
    assert sorted(ours) == sorted(want)
    assert any(n.endswith("/ffn/router_kernel") for n in want)
    tol = 2 * _noam(1) + 1e-6
    noise_tol = 2 * sum(_noam(s) for s in range(1, CLI_STEPS + 1)) + 1e-6
    for name in want:
        diff = np.abs(ours[name] - want[name])
        key = _key_bias(name, diff)
        if key is not None:
            assert float(key.max()) <= noise_tol, name
            diff = np.delete(diff, 1 if "qkv" in name else 0, axis=0)
        assert float(diff.max()) <= tol, (name, float(diff.max()))
    with open(os.path.join(cli["dirs"]["port"], "model_configs.yml")) as f:
        assert "moe_num_experts: 4" in f.read()


def test_moe_cli_predict_matches_jax(cli):
    ours, ref = cli["port_predict"], cli["jax_predict"]
    assert ours["samples"] == ref["samples"] == 24
    assert ours["hypotheses"] == ref["hypotheses"]
    with open(os.path.join(cli["root"], "hyp.port")) as f, \
            open(os.path.join(cli["root"], "hyp.jax")) as g:
        assert f.read() == g.read()
