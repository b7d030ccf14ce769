"""The port's LightConv (lightweight and dynamic convolutions) against the
JAX package's.

Layers, encoder and decoder get numpy-drawn parameters carried into the
port through ``utils/param_bridge`` and run the same numpy-seeded inputs
in float32 (``jax_default_matmul_precision=float32``; TF32 off): both
conv types, causal and centred, with and without the GLU; the decoder
stepwise from its cache against teacher forcing.  End to end: both
packages' ``run_exp`` train ``lightconv_toy`` (the ``tests/examples``
corpus and ``example_train_seq2seq.yml``, as the JAX package's own
``test_lightconv_train_and_predict``) for 4 steps without shuffling from
one ``ckpt-0.npz`` of the JAX initializers, then both predict entries
decode the dev set from the port's dir with beam 2 and with
``top_sampling`` at top_k 1.  The JAX side runs in two subprocesses on
one CPU device each (one trains, one decodes), beside the port's side.

Tolerances: layer outputs and logits 1e-5 relative to their largest
|value|; losses 1e-5 relative; hypothesis files identical; BLEU 1e-6.
"""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402

import neurst_tpu_torch  # noqa: E402
from neurst_tpu.cli.run_exp import \
    parse_and_merge as jax_parse_and_merge  # noqa: E402
from neurst_tpu.layers.attentions import \
    light_convolution_layer as jlayer  # noqa: E402
from neurst_tpu.layers.decoders.light_convolution_decoder import \
    LightConvolutionDecoder as JDecoder  # noqa: E402
from neurst_tpu.layers.encoders.light_convolution_encoder import \
    LightConvolutionEncoder as JEncoder  # noqa: E402
from neurst_tpu.models.light_convolution_model import \
    LightConvolutionModel as JaxLightConv  # noqa: E402
from neurst_tpu.models.model import build_model as jax_build  # noqa: E402
from neurst_tpu.tasks.task import build_task as jax_build_task  # noqa: E402
from neurst_tpu.utils import checkpoints as jax_ckpt  # noqa: E402
from neurst_tpu.utils.checkpoints import flatten_params  # noqa: E402
from neurst_tpu.utils.hparams_sets import \
    get_hyper_parameters as jax_hparams  # noqa: E402
from neurst_tpu_torch.cli import run_exp as port_run_exp  # noqa: E402
from neurst_tpu_torch.exps import trainer as port_trainer  # noqa: E402
from neurst_tpu_torch.layers.attentions import \
    light_convolution_layer as tlayer  # noqa: E402
from neurst_tpu_torch.layers.decoders.light_convolution_decoder import \
    LightConvolutionDecoder as TDecoder  # noqa: E402
from neurst_tpu_torch.layers.encoders.light_convolution_encoder import \
    LightConvolutionEncoder as TEncoder  # noqa: E402
from neurst_tpu_torch.models.light_convolution_model import \
    LightConvolutionModel  # noqa: E402
from neurst_tpu_torch.utils.hparams_sets import \
    get_hyper_parameters  # noqa: E402
from neurst_tpu_torch.utils.param_bridge import (  # noqa: E402
    load_flat_params, state_dict_to_flat)

from port_test_support import start_jax_side  # noqa: E402
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "tests", "examples")
TOL = 1e-5
D, H = 16, 4
CONV_TYPES = ["lightweight", "dynamic"]
STEPS = 4


def _init(module, rng, *args, **kwargs):
    variables = module.init(jax.random.PRNGKey(0), *args, **kwargs)
    params = fnn.meta.unbox(variables["params"])
    return jax.tree_util.tree_map(
        lambda x: (0.3 * rng.randn(*x.shape)).astype(np.float32), params)


def _port(tmodule, params):
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    return load_flat_params(tmodule, flat).eval()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(ours, want, tol=TOL):
    ours, want = _np(ours), _np(want)
    assert ours.shape == want.shape
    assert float(np.abs(ours - want).max()) <= tol * max(
        1.0, float(np.abs(want).max()))


def _padding(lengths, length):
    return (np.arange(length)[None] >= np.asarray(lengths)[:, None]).astype(
        np.float32)


@pytest.mark.parametrize("conv_type, causal, use_glu, kernel", [
    (conv_type, causal, True, 3) for conv_type in CONV_TYPES
    for causal in (False, True)] + [
    ("lightweight", False, True, 4), ("dynamic", False, False, 4),
    ("dynamic", True, False, 3)])
def test_layer_matches_jax(conv_type, causal, use_glu, kernel):
    """Both conv types, centred and causal; an even kernel (its odd
    padding goes to the right when centred); without the GLU."""
    rng = np.random.RandomState(kernel)
    x = rng.randn(2, 7, D).astype(np.float32)
    jm = jlayer.LightConvolutionLayer(
        kernel_size=kernel, num_heads=H, conv_dim=D, output_dim=D,
        conv_type=conv_type, use_glu=use_glu)
    params = _init(jm, rng, x)
    tm = _port(tlayer.LightConvolutionLayer(D, kernel, H, D, D, conv_type,
                                            use_glu), params)
    with torch.no_grad():
        ours, _ = tm(torch.from_numpy(x), causal=causal)
    want, _ = jm.apply({"params": params}, x, causal=causal)
    _close(ours, want)


def test_unfold_matches_jax():
    x = np.arange(2 * 6 * 3, dtype=np.float32).reshape(2, 6, 3)
    for kernel in (1, 2, 5):
        for causal in (False, True):
            np.testing.assert_array_equal(
                tlayer._unfold(torch.from_numpy(x), kernel, causal).numpy(),
                np.asarray(jlayer._unfold(jnp.asarray(x), kernel, causal)))


@pytest.mark.parametrize("conv_type", CONV_TYPES)
def test_layer_steps_from_its_cache_equal_causal_teacher_forcing(conv_type):
    rng = np.random.RandomState(9)
    x = rng.randn(2, 6, D).astype(np.float32)
    jm = jlayer.LightConvolutionLayer(kernel_size=3, num_heads=H,
                                      conv_dim=D, output_dim=D,
                                      conv_type=conv_type)
    params = _init(jm, rng, x)
    tm = _port(tlayer.LightConvolutionLayer(D, 3, H, D, D, conv_type),
               params)
    with torch.no_grad():
        forced, _ = tm(torch.from_numpy(x), causal=True)
        cache = tm.make_cache(2)
        jcache = jm.make_cache(2)
        for t in range(6):
            step, cache = tm(torch.from_numpy(x[:, t:t + 1]), cache=cache,
                             decode_step=t)
            _close(step, forced[:, t:t + 1])
            want, jcache = jm.apply({"params": params}, x[:, t:t + 1],
                                    cache=jcache, decode_step=t)
            _close(step, want)
            _close(cache["conv"], jcache["conv"])


@pytest.mark.parametrize("conv_type", CONV_TYPES)
@pytest.mark.parametrize("post_normalize", [False, True])
def test_encoder_matches_jax(conv_type, post_normalize):
    rng = np.random.RandomState(11)
    x = rng.randn(3, 9, D).astype(np.float32)
    padding = _padding([9, 4, 1], 9)
    kwargs = dict(num_layers=3, hidden_size=D, num_heads=H, filter_size=24,
                  kernel_sizes=(3, 5), conv_type=conv_type,
                  post_normalize=post_normalize)
    jm = JEncoder(**kwargs)
    params = _init(jm, rng, x, padding)
    tm = _port(TEncoder(**kwargs), params)
    with torch.no_grad():
        ours = tm(torch.from_numpy(x), torch.from_numpy(padding))
    _close(ours, jm.apply({"params": params}, x, padding))


@pytest.mark.parametrize("conv_type", CONV_TYPES)
def test_decoder_matches_jax_and_steps_equal_teacher_forcing(conv_type):
    rng = np.random.RandomState(12)
    x = rng.randn(2, 6, D).astype(np.float32)
    memory = rng.randn(2, 5, D).astype(np.float32)
    memory_padding = _padding([5, 3], 5)
    kwargs = dict(num_layers=2, hidden_size=D, num_heads=H, filter_size=24,
                  kernel_sizes=(3, 4), conv_type=conv_type)
    jm = JDecoder(**kwargs)
    params = _init(jm, rng, x, memory, memory_padding)
    tm = _port(TDecoder(**kwargs), params)
    with torch.no_grad():
        forced, _ = tm(torch.from_numpy(x), memory=torch.from_numpy(memory),
                       memory_padding=torch.from_numpy(memory_padding))
        want, _ = jm.apply({"params": params}, x, memory, memory_padding)
        _close(forced, want)
        cache = tm.create_decoding_internal_cache(torch.from_numpy(memory), 8)
        jcache = jm.apply({"params": params}, jnp.asarray(memory), 8,
                          method=jm.create_decoding_internal_cache)
        for t in range(6):
            step, cache = tm(torch.from_numpy(x[:, t:t + 1]),
                             memory_padding=torch.from_numpy(memory_padding),
                             cache=cache, decode_step=t)
            _close(step, forced[:, t:t + 1])
            jstep, jcache = jm.apply(
                {"params": params}, x[:, t:t + 1],
                memory_padding=memory_padding, cache=jcache, decode_step=t)
            _close(step, jstep)


@pytest.mark.parametrize("name", ["lightconv_base", "lightconv_toy",
                                  "dynamicconv_base", "transformer_base"])
def test_hparams_and_flags_match_jax(name):
    assert LightConvolutionModel.build_model_args_by_name(name) == \
        JaxLightConv.build_model_args_by_name(name)
    if name.startswith("lightconv"):
        assert get_hyper_parameters(name) == jax_hparams(name)

    def flags(cls):
        return {f.name: f.default for f in cls.class_or_method_args()}
    assert flags(LightConvolutionModel) == flags(JaxLightConv)


@pytest.mark.parametrize("conv_type", CONV_TYPES)
def test_model_logits_and_parameter_names_match_jax(conv_type):
    """``lightconv_toy`` (both conv types) at the JAX initializers'
    weights: the same parameter names both ways and the same logits (the
    predict test below holds beam search, whose cache of convolution
    buffers is reordered with the beams)."""
    cfg = JaxLightConv.build_model_args_by_name("lightconv_toy")
    params = dict(cfg["model.params"], dtype="float32",
                  **{"encoder.conv_type": conv_type,
                     "decoder.conv_type": conv_type})
    cfg = {"model.class": "lightconv", "model.params": params}
    meta = {"vocab_size": 40, "eos_id": 1, "bos_id": 2, "unk_id": 3}
    jm = jax_build(cfg, src_meta=meta, trg_meta=meta)
    jparams = jm.init_params(jax.random.PRNGKey(2))
    flat = {k: np.asarray(v) for k, v in flatten_params(jparams).items()}
    tm = neurst_tpu_torch.build_model(cfg, src_meta=meta, trg_meta=meta,
                                      device="cpu")
    load_flat_params(tm, flat)
    assert sorted(state_dict_to_flat(tm)) == sorted(flat)
    assert not tm.beam_cache_indirection_ok()
    rng = np.random.RandomState(13)
    batch = {"src": rng.randint(4, 40, (2, 6)).astype(np.int32),
             "src_padding": _padding([6, 3], 6),
             "trg_input": rng.randint(4, 40, (2, 5)).astype(np.int32)}
    with torch.no_grad():
        _close(tm(batch), jm.call(jparams, batch))


# ------------------------------------------------------------- the CLIs

JAX_SIDE = r"""
import json, logging, os, sys, time
import jax
jax.config.update("jax_default_matmul_precision", "float32")
import neurst_tpu.exps.trainer as trainer_mod
from neurst_tpu.cli.run_exp import cli_main
logging.basicConfig(level=logging.INFO)
LOSSES = []


class Log(object):
    def __getattr__(self, name):
        return getattr(logging, name)

    def info(self, msg, *args, **kwargs):
        if msg.startswith("step %d | loss"):
            LOSSES.append(args[1])
        logging.info(msg, *args, **kwargs)


trainer_mod.logging = Log()
for kind, argv, out in json.load(open(sys.argv[1])):
    if kind == "wait":
        while not os.path.exists(argv):
            time.sleep(0.05)
        continue
    result = cli_main(argv)
    with open(out, "w") as f:
        json.dump(LOSSES if kind == "train" else result, f,
                  default=lambda o: o.tolist())
"""


class _Log(object):
    def __init__(self):
        self.losses = []

    def __getattr__(self, name):
        return getattr(logging, name)

    def info(self, msg, *args, **kwargs):
        if msg.startswith("step %d | loss"):
            self.losses.append(args[1])
        logging.info(msg, *args, **kwargs)


SEARCHES = {
    "beam": ["--search_method.params",
             '{"beam_size": 2, "maximum_decode_length": 16}'],
    "sampling": ["--search_method", "top_sampling", "--search_method.params",
                 '{"top_k": 1, "maximum_decode_length": 16}']}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lightconv"))
    train = ["--entry", "train", "--config_paths",
             f"{EXAMPLES}/example_train_seq2seq.yml",
             "--model.class", "light_convolution_model",
             "--hparams_set", "lightconv_toy",
             "--task.params", json.dumps({"shuffle_buffer": 0}),
             "--train_steps", str(STEPS), "--summary_steps", "1",
             "--save_checkpoint_steps", str(STEPS),
             "--enable_tensorboard", "false"]
    dirs = {side: os.path.join(root, side) for side in ("jax", "port")}
    predict = {name: ["--entry", "predict", "--model_dir", dirs["port"],
                      "--dataset.class", "parallel_text", "--dataset.params",
                      json.dumps({"src_file": f"{EXAMPLES}/dev.src",
                                  "trg_file": f"{EXAMPLES}/dev.trg"}),
                      "--metric", "bleu", *extra]
               for name, extra in SEARCHES.items()}
    out = {"root": root, "port": {}, "jax": {}}
    # two JAX processes start first and wait while they import: one
    # trains the JAX dir once ckpt-0 is written, the other decodes the
    # port's dir once the port's trainer has written it
    seeded = os.path.join(root, "seeded")
    ready = os.path.join(root, "port_trained")
    procs = [start_jax_side(JAX_SIDE, root, "jax_train", [
        ["wait", seeded, None],
        ["train", train + ["--model_dir", dirs["jax"]],
         os.path.join(root, "jax_train.json")]])]
    decodes = [["predict", argv + ["--output_file",
                                   os.path.join(root, f"{name}.jax")],
                os.path.join(root, f"jax_{name}.json")]
               for name, argv in predict.items()]
    procs.append(start_jax_side(JAX_SIDE, root, "jax_predict",
                                 [["wait", ready, None]] + decodes))
    try:
        # the JAX initializers' weights as ckpt-0 of both dirs
        parsed = jax_parse_and_merge(train)
        jmodel = jax_build_task(parsed).build_model(
            {"model.class": parsed["model.class"],
             "model.params": dict(parsed["model.params"], dtype="float32")})
        seed_dir = os.path.join(root, "seed")
        jax_ckpt.save_checkpoint(seed_dir, 0, jax.tree_util.tree_map(
            np.asarray, jmodel.init_params(jax.random.PRNGKey(1))))
        for d in dirs.values():
            shutil.copytree(seed_dir, d)
        open(seeded, "w").close()
        log = _Log()
        trainer_logging, port_trainer.logging = port_trainer.logging, log
        try:
            port_run_exp.cli_main(train + ["--model_dir", dirs["port"],
                                           "--device", "cpu"])
        finally:
            port_trainer.logging = trainer_logging
        out["port"]["train"] = log.losses
        open(ready, "w").close()
        for name, argv in predict.items():
            out["port"][name] = port_run_exp.cli_main(
                argv + ["--output_file", os.path.join(root, f"{name}.port"),
                        "--device", "cpu"])
        for proc, _ in procs:
            proc.wait(timeout=600)
    finally:
        for proc, _ in procs:
            proc.kill()
    for proc, path in procs:
        with open(path) as f:
            assert proc.returncode == 0, f.read()[-4000:]
    with open(os.path.join(root, "jax_train.json")) as f:
        out["jax"]["train"] = json.load(f)
    for name in predict:
        with open(os.path.join(root, f"jax_{name}.json")) as f:
            out["jax"][name] = json.load(f)
    return out


def test_cli_training_losses_match_jax(runs):
    port, ref = runs["port"]["train"], runs["jax"]["train"]
    assert len(port) == len(ref) == STEPS
    np.testing.assert_allclose(port, ref, rtol=TOL)


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_cli_predict_matches_jax(runs, name):
    ours, ref = runs["port"][name], runs["jax"][name]
    assert ours["samples"] == ref["samples"] == 24
    with open(os.path.join(runs["root"], f"{name}.port")) as f, \
            open(os.path.join(runs["root"], f"{name}.jax")) as g:
        assert f.read() == g.read()
    assert ours["hypotheses"] == ref["hypotheses"]
    assert abs(ours["BLEU"] - ref["BLEU"]) <= 1e-6
