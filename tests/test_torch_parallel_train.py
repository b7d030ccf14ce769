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

import json
import os
import pickle

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
from neurst_tpu.layers.quantization import \
    quant_layers as jql  # noqa: E402
from neurst_tpu.utils.param_policy import \
    restore_inference_params as jax_restore  # noqa: E402
import neurst_tpu_torch  # noqa: E402
from neurst_tpu_torch.layers.quantization import \
    quant_layers as ql  # noqa: E402
from neurst_tpu_torch.ops.fused_dropout import (  # noqa: E402
    dropout_keep_mask, threshold_and_scale)
from neurst_tpu_torch.utils.param_bridge import \
    unstack_scan_layers  # noqa: E402
from neurst_tpu_torch.utils.rng import (at_row, at_shard,  # noqa: E402
                                        make_key)
from port_test_support import (JAX_CLI_SIDE, REPO,  # noqa: E402
                               start_jax_side)
from torch_parallel_worker import (run_int8_calibration,  # noqa: E402
                                   run_step, start_group, wait_all,
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
# QAT with small clips, so that many weights and activations clip
QUANT = {"quant_strategy": "min/max", "quant_bits": 8,
         "quant_weight_clip_max": 0.2, "quant_act_clip_max": 2.0}
# the three int8 serving modes (keyword arguments of set_int8_serving)
INT8 = {"weight_only": {}, "dynamic": {"activations": True},
        "static": {"activations": True, "static_activation_scales": True}}
INT8_FLAGS = {"weight_only": [], "dynamic": ["--int8_activations"],
              "static": ["--int8_activations", "--int8_static_activations"]}
# the member each int8 mode serves: the tied softmax (A) or the untied
# one (B, an int8 ``output_linear`` split over the vocabulary)
INT8_DIR = {"weight_only": "B", "dynamic": "A", "static": "A"}
# the test corpus's predict recipe (tests/examples) in one batch of its
# 24 sentences (one compile of the JAX search), decoding up to 12 tokens
# (at 24 the random ensemble meets two beams of bit-equal scores, which
# the JAX search orders otherwise)
PREDICT_CFG = {"entry": "predict", "batch_size": 24,
               "search_method": "beam_search",
               "search_method.params": {"beam_size": 2,
                                        "maximum_decode_length": 12},
               "metric": "bleu", "dataset.class": "parallel_text",
               "dataset.params": {"src_file": "tests/examples/dev.src",
                                  "trg_file": "tests/examples/dev.trg"}}


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


def _jax_steps(jm, params, batches, extra_loss_fn=None):
    crit = JaxCriterion({"label_smoothing": 0.1})
    tx = jax_chain(JaxAdam(OPT), LR, clip_norm=1.0)

    def device(b):
        return {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(p, batch):
        out, aux = jm.call_train(p, batch)
        loss = crit.reduce_loss(batch, out) + aux
        return loss if extra_loss_fn is None else loss + extra_loss_fn(p)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params,
                                                        device(batches[0]))
    step = jax.jit(jax_make_train_step(jm, crit, tx,
                                       extra_loss_fn=extra_loss_fn))
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


def _qat_flat(flat):
    """``flat`` and every clip of the QAT model, each at its initial value
    times a seeded factor in [0.5, 1.5], so that no two are alike."""
    from neurst_tpu_torch.utils.param_bridge import state_dict_to_flat
    ql.global_init(True, **QUANT)
    try:
        names = state_dict_to_flat(neurst_tpu_torch.build_model(
            _config(), src_meta=META, trg_meta=META, device="cpu"))
    finally:
        ql.global_init(False)
    init = {"kernel_clip_max": QUANT["quant_weight_clip_max"],
            "output_clip_max": QUANT["quant_act_clip_max"]}
    rng = np.random.RandomState(7)
    out = dict(flat)
    for name in sorted(names):
        if name.endswith("_clip_max"):
            out[name] = np.float32(init[name.rsplit("/", 1)[1]]
                                   * rng.uniform(0.5, 1.5))
    assert sorted(out) == sorted(names)
    return out


def _jax_qat_step(flat, batches):
    """JAX's one-device QAT step: the loss with the clips' L2 term, the
    gradients and one Adam step, computed op by op (``jax.disable_jit``).

    Op by op, JAX rounds as the port's eager ops do: its loss equals the
    port's one-rank QAT loss bit for bit and every gradient agrees within
    5e-7 of its largest value.  The jitted step fuses and rounds
    otherwise, and on these weights that moves activations across
    fake-quant levels and clip bounds: it differs from JAX's own op-by-op
    step by up to 2.5e-2 of the largest value (decoder layer 0's FFN
    dense1 kernel), and so from the port's."""
    from neurst_tpu.utils.checkpoints import unflatten_params
    jql.global_init(True, **QUANT)
    try:
        jm = jax_build(_config(), src_meta=META, trg_meta=META)
        with jax.disable_jit():
            return _jax_steps(jm, unflatten_params(flat), batches,
                              extra_loss_fn=jql.clip_l2_penalty)
    finally:
        jql.global_init(False)


# a JAX reference of this module's in a subprocess beside the ranks (the
# op-by-op QAT step takes ~40 s): ``fn``'s arguments and result pickled
# at the two paths
JAX_CALL = """
import pickle, sys
sys.path.insert(0, "tests")
import test_torch_parallel_train as T
with open({inputs!r}, "rb") as f:
    args = pickle.load(f)
with open({output!r}, "wb") as f:
    pickle.dump(T.{fn}(*args), f)
"""


def _jax_call(root, fn, *args):
    """The ["exec", ...] op of ``JAX_CALL`` for ``fn(*args)``; its result
    lands in ``<root>/<fn>.pkl``."""
    inputs = str(root / f"{fn}.inputs.pkl")
    with open(inputs, "wb") as f:
        pickle.dump(args, f)
    return ["exec", JAX_CALL.format(fn=fn, inputs=inputs,
                                    output=str(root / f"{fn}.pkl")), None]


def _jax_result(root, fn):
    with open(root / f"{fn}.pkl", "rb") as f:
        return pickle.load(f)


def _int8_dense_inputs(rng):
    """A 16 -> 8 int8 dense and an input whose tokens of batch row 0 have
    their absmax in the first half of the features (rank 0's at tp 2),
    those of row 1 in the second."""
    x = 0.1 * rng.randn(2, 3, 16)
    x[0, :, 2] += 5.0
    x[1, :, 13] -= 5.0
    return {"x": x.astype(np.float32),
            "kernel_q": rng.randint(-127, 128, (8, 16)).astype(np.int8),
            "kernel_scale": rng.uniform(0.01, 0.02, 8).astype(np.float32),
            "bias": rng.randn(8).astype(np.float32), "act_scale": 0.05}


def _int8_dense_whole(inp, mode):
    """One rank's ``Int8Dense`` of ``inp`` in ``mode`` (and in the static
    mode the absmax its calibration records)."""
    ql.set_int8_serving(True, **INT8[mode])
    try:
        dense = ql.Int8Dense(16, 8)
        with torch.no_grad():
            for name in ("kernel_q", "kernel_scale", "bias"):
                getattr(dense, name).copy_(torch.tensor(inp[name]))
            if dense.act_scale is not None:
                dense.act_scale.fill_(inp["act_scale"])
        x = torch.tensor(inp["x"])
        out = {"y": dense(x).numpy()}
        if dense.act_scale is not None:
            ql.set_int8_calibration(True)
            with ql.recording_act_absmax(dense) as found:
                dense(x)
            ql.set_int8_calibration(False)
            out["absmax"] = found[""]
        return out
    finally:
        ql.set_int8_serving(False)


def _jax_int8_scales(flat, batches):
    """JAX's static int8 calibration of the model on ``batches``."""
    jql.set_int8_serving(True, **INT8["static"])
    try:
        jm = jax_build(_config(), src_meta=META, trg_meta=META)
        template = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
        params, _ = jax_restore(jm, template, dict(flat))
        params = jql.calibrate_int8_act_scales(jm, params, batches)
        return {k: np.asarray(v) for k, v in flatten_params(params).items()
                if k.endswith("/act_scale")}
    finally:
        jql.set_int8_serving(False)


def _model_dirs(root):
    """Two model dirs of ``transformer_64_2e_2d_4h`` on a 48-word
    vocabulary (the test corpus's 40 words and 5 more, so that it
    splits over two ranks): A with the tied
    softmax, B untied; each with ``model_configs.yml`` and ckpt-1 of 0.2
    x a seeded normal draw (so that a decode does not just repeat one
    token)."""
    from neurst_tpu_torch.tasks.task import build_task
    from neurst_tpu_torch.utils import checkpoints as ckpt_lib
    from neurst_tpu_torch.utils.configurable import ModelConfigs
    from neurst_tpu_torch.utils.param_bridge import state_dict_to_flat
    vocab = os.path.join(root, "vocab.txt")
    with open(os.path.join(REPO, "tests", "examples", "vocab.txt")) as f:
        words = f.read().split()
    with open(vocab, "w") as f:
        f.write("\n".join(words + [f"extra{i}" for i in range(5)]) + "\n")
    pipeline = {"class": "TextDataPipeline", "params": {"vocab_path": vocab}}
    dirs = {}
    for name, untied, seed in (("A", False, 1), ("B", True, 2)):
        params = dict(_config()["model.params"])
        params["modality.share_embedding_and_softmax_weights"] = not untied
        cfg = {"task.class": "translation", "task.params": {
            "src_data_pipeline.class": pipeline["class"],
            "src_data_pipeline.params": pipeline["params"],
            "trg_data_pipeline.class": pipeline["class"],
            "trg_data_pipeline.params": pipeline["params"],
            "batch_size": 64, "max_src_len": 16, "max_trg_len": 16},
            "model.class": "transformer", "model.params": params}
        task = build_task(cfg)
        model = task.build_model(cfg, device="cpu")
        rng = np.random.RandomState(seed)
        flat = {k: (0.2 * rng.randn(*np.shape(v))).astype(np.float32)
                for k, v in sorted(state_dict_to_flat(model).items())}
        dirs[name] = os.path.join(root, name)
        ckpt_lib.save_checkpoint(dirs[name], 1, flat)
        ModelConfigs.dump(task.model_configs(model), dirs[name])
    return dirs


def _cli_runs(root, dirs):
    """{id: predict argv} of the ensemble at tp 2 and each int8 mode's
    member at tp 2 (on 4 ranks: dp 2 x tp 2)."""
    path = os.path.join(root, "predict.json")
    with open(path, "w") as f:
        json.dump(PREDICT_CFG, f)
    predict = ["--config_paths", path]
    tp = ["--decode_tensor_parallel", "2"]
    out = {"ensemble": predict + ["--model_dir", f"{dirs['A']},{dirs['B']}"]
           + tp}
    for mode, flags in INT8_FLAGS.items():
        out[f"int8_{mode}"] = predict + ["--model_dir", dirs[INT8_DIR[mode]],
                                         "--int8_serving"] + flags + tp
    return out


def _one_rank(argv):
    """The argv of the same run on one rank (no tensor parallelism)."""
    i = argv.index("--decode_tensor_parallel")
    return argv[:i] + argv[i + 2:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario on 2 and 4 ranks, and the references."""
    root = tmp_path_factory.mktemp("parallel")
    rng = np.random.RandomState(0)
    batches = [_batch(rng), _batch(rng)]
    dirs = _model_dirs(str(root))
    clis = _cli_runs(str(root), dirs)
    jm = jax_build(_config(), src_meta=META, trg_meta=META)
    params = jm.init_params(jax.random.PRNGKey(0))
    flat = _flat(params)
    flat_qat = _qat_flat(flat)
    # the JAX QAT step, calibration and CLI predicts on one device run
    # beside everything else
    jax_sides = [
        start_jax_side(JAX_CLI_SIDE, str(root), "jax_qat", [
            _jax_call(root, "_jax_qat_step", flat_qat, batches[:1])]),
        start_jax_side(JAX_CLI_SIDE, str(root), "jax_cli", [
            _jax_call(root, "_jax_int8_scales", flat, batches)] + [
            ["predict", _one_rank(argv), str(root / f"jax_{sid}.json")]
            for sid, argv in clis.items()])]
    jm_pipe = jax_build(_config(**PIPE), src_meta=META, trg_meta=META)
    params_pipe = jm_pipe.init_params(jax.random.PRNGKey(0))
    data = {"meta": META, "flat": flat, "flat_pipe": _flat(params_pipe),
            "flat_qat": flat_qat,
            "b0": batches[0], "b1": batches[1], "opt": OPT, "lr": LR,
            "ring8": _ring_inputs(1, 8), "ring16": _ring_inputs(2, 16),
            "int8_dense": _int8_dense_inputs(np.random.RandomState(5))}
    both = ["b0", "b1"]
    step = {"kind": "step", "params": "flat", "batches": both}
    qat = dict(step, cfg=_config(), tp=2, quant=QUANT, params="flat_qat",
               batches=["b0"], steps=1)
    calibration = {"kind": "int8_calibration", "cfg": _config(),
                   "params": "flat", "batches": both, "tp": 2}
    cli = [{"id": sid, "kind": "cli", "argv": argv}
           for sid, argv in clis.items()]
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
         "causal": True},
        dict(qat, id="qat_tp"),
        {"id": "int8_dense", "kind": "int8_dense", "inputs": "int8_dense",
         "modes": INT8},
        dict(calibration, id="int8_calibration")] + cli
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
         "causal": True},
        dict(qat, id="qat_dp_tp")] + cli
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
    out["single_int8_calibration"] = run_int8_calibration(
        dict(calibration, tp=1), data)
    out["single_int8_dense"] = {mode: _int8_dense_whole(
        data["int8_dense"], mode) for mode in INT8}
    from neurst_tpu_torch.cli import run_exp
    try:
        for sid, argv in clis.items():
            out[f"single_{sid}"] = run_exp.cli_main(_one_rank(argv)
                                                    + ["--device", "cpu"])
    finally:
        # the CLI leaves its quantization config on in the process
        ql.set_int8_serving(False)
    out.update({name: wait_group(g) for name, g in groups.items()})
    wait_all([p for p, _ in jax_sides], [log for _, log in jax_sides], 300)
    for sid in clis:
        with open(root / f"jax_{sid}.json") as f:
            out[f"jax_{sid}"] = json.load(f)
    out["jax_qat"] = _jax_result(root, "_jax_qat_step")
    out["jax_int8_scales"] = _jax_result(root, "_jax_int8_scales")
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


@pytest.mark.parametrize("group,sid", [("two", "qat_tp"),
                                       ("four", "qat_dp_tp")])
def test_qat_step_matches_jax(runs, group, sid):
    """QAT over tp 2 and dp 2 x tp 2 from the JAX QAT weights: the loss
    with the clips' L2 term, every gradient (each clip's, which a missing
    sum over the model group would leave a rank's part of, named one by
    one), the first step's metrics and weights equal JAX's one-device
    QAT step, and every rank ends with the same weights."""
    got, ref = runs[group][0][sid], runs["jax_qat"]
    clips = sorted(n for n in ref["grads"] if n.endswith("_clip_max"))
    assert len(clips) > 20 and all(ref["grads"][n] != 0 for n in clips)
    for name in clips:
        want = float(ref["grads"][name])
        assert abs(float(got["grads"][name]) - want) \
            <= GRAD_TOL * abs(want), name
    _check_run(got, ref)
    _same_on_every_rank(runs[group], sid)


@pytest.mark.parametrize("mode", list(INT8))
def test_row_parallel_int8_dense_equals_one_rank(runs, mode):
    """A row-parallel ``Int8Dense`` over 2 ranks whose tokens have their
    absmax in one rank's half of the input: the per-token scale is the
    max over the model group and the int32 accumulator is summed before
    the scales, so the int8 x int8 modes give one rank's output bit for
    bit (weight-only sums float32 partial products)."""
    ref = runs["single_int8_dense"][mode]["y"]
    for res in runs["two"]:
        got = res["int8_dense"][mode]
        if mode == "weight_only":
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, ref)
        assert res["int8_dense"]["absmax"] \
            == runs["single_int8_dense"]["static"]["absmax"]


def test_tensor_parallel_static_calibration_writes_one_rank_scales(runs):
    """Static int8 calibration over tp 2 (every int8 kernel cut to half
    its rows or columns): the one-rank port's and JAX's act scales."""
    got = runs["two"][0]["int8_calibration"]
    ref = runs["single_int8_calibration"]
    assert sorted(got["shapes"]) == sorted(ref["shapes"])
    for name, shape in got["shapes"].items():
        assert 2 * np.prod(shape) == np.prod(ref["shapes"][name]), name
    assert sorted(got["scales"]) == sorted(ref["scales"]) \
        == sorted(runs["jax_int8_scales"])
    for name, want in ref["scales"].items():
        np.testing.assert_allclose(got["scales"][name], want, rtol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(got["scales"][name],
                                   runs["jax_int8_scales"][name], rtol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("group", ["two", "four"])
@pytest.mark.parametrize("sid", ["ensemble", "int8_weight_only",
                                 "int8_dynamic", "int8_static"])
def test_tensor_parallel_predict_matches_one_rank_and_jax(runs, group, sid):
    """``run_exp --entry predict --decode_tensor_parallel 2`` over tp 2 and
    dp 2 x tp 2: an ensemble of the two dirs (``--model_dir A,B``, the
    members whole on every rank) and int8 serving in each mode (the
    layers split over the model group) give, on every rank, the one-rank
    run's hypotheses and the JAX CLI's, with scores within 1e-5.

    The static mode calibrates its scales at the start of each run from
    the run's own activations; each package's scales agree within 1e-6
    (``test_tensor_parallel_static_calibration_writes_one_rank_scales``),
    which moves one of the 24 scores by 3.6e-4 (2e-5 relative) between
    the two packages: there the scores are held to the one-rank port's,
    which the parallel runs give bit for bit."""
    ref, jax_ref = runs[f"single_{sid}"], runs[f"jax_{sid}"]
    assert ref["hypotheses"] == jax_ref["hypotheses"]
    assert len(set(ref["hypotheses"])) > 1
    want = ref if sid == "int8_static" else jax_ref
    for res in runs[group]:
        assert res[sid]["hypotheses"] == ref["hypotheses"]
        np.testing.assert_allclose(res[sid]["scores"], want["scores"],
                                   rtol=1e-5, atol=1e-5)


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
