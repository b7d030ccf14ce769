"""``gradient_remat`` of the port (``torch.utils.checkpoint`` over the
whole forward of ``parallel/train_step.make_train_step``) against the
port without it and against the JAX package's
``make_train_step(remat=True)`` (``jax.checkpoint`` over its forward).

Cases: the speech model with the flash encoder and the fused projection
+ cross-entropy (d 128), the text Transformer with ``update_cycle`` 2,
the text Transformer under QAT (the clips' L2 term through
``extra_loss_fn``) and the Switch MoE model (the auxiliary loss through
``call_train``); dropout 0 where JAX is compared (its masks are its
own).  Loss within 1e-5 relative and gradients within 1e-4 of their
largest against JAX; against the port without remat the loss is bitwise
equal and gradients within 1e-6 of their largest, also with the recipe's
dropout 0.1 (the recomputed forward draws the same masks).  The ``train``
entry with ``--gradient_remat`` writes the checkpoint a run without it
writes.
"""

import os

import numpy as np
import pytest
import torch
import yaml

import port_test_support  # noqa: F401  (one torch thread per worker)

jax = pytest.importorskip("jax")
jax.config.update("jax_default_matmul_precision", "float32")
import optax  # noqa: E402

import neurst_tpu_torch  # noqa: E402
from neurst_tpu.criterions.criterion import \
    build_criterion as jax_build_criterion  # noqa: E402
from neurst_tpu.layers.quantization import \
    quant_layers as jql  # noqa: E402
from neurst_tpu.models.model import build_model as jax_build  # noqa: E402
from neurst_tpu.models.speech_transformer import \
    SpeechTransformer as JaxSpeechTransformer  # noqa: E402
from neurst_tpu.models.transformer import \
    Transformer as JaxTransformer  # noqa: E402
from neurst_tpu.parallel.train_step import \
    TrainState as JaxTrainState  # noqa: E402
from neurst_tpu.parallel.train_step import \
    make_train_step as jax_make_train_step  # noqa: E402
from neurst_tpu.utils.checkpoints import flatten_params  # noqa: E402

from neurst_tpu_torch.cli import run_exp  # noqa: E402
from neurst_tpu_torch.criterions.criterion import \
    build_criterion  # noqa: E402
from neurst_tpu_torch.layers.quantization import \
    quant_layers as ql  # noqa: E402
from neurst_tpu_torch.parallel import make_train_step  # noqa: E402
from neurst_tpu_torch.utils import checkpoints as ckpt_lib  # noqa: E402
from neurst_tpu_torch.utils.param_bridge import (  # noqa: E402
    flat_to_state_dict, load_flat_params)
from neurst_tpu_torch.utils.rng import fold_in, make_key  # noqa: E402

from port_test_support import REPO  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CRITERION = {"criterion.class": "label_smoothed_cross_entropy",
             "criterion.params": {"label_smoothing": 0.1}}
TEXT_META = ({"vocab_size": 40, "eos_id": 1, "bos_id": 2, "unk_id": 3},
             {"vocab_size": 48, "eos_id": 1, "bos_id": 2, "unk_id": 3})
SPEECH_META = ({"audio_feature_dim": 16, "audio_feature_channels": 1},
               {"vocab_size": 256, "eos_id": 1, "bos_id": 2, "unk_id": 3})
QUANT = {"quant_strategy": "min/max", "quant_bits": 8,
         "quant_weight_clip_max": 0.2, "quant_act_clip_max": 2.0}
RATES = ("attention_dropout_rate", "ffn_dropout_rate",
         "layer_postprocess_dropout_rate")
TOL, GRAD_TOL, SELF_TOL = 1e-5, 1e-4, 1e-6


def _rates(params, rate):
    for side in ("encoder", "decoder"):
        params.update({f"{side}.{r}": rate for r in RATES})
    return params


def _speech_cfg(rate=0.0):
    cfg = JaxSpeechTransformer.build_model_args_by_name(
        "speech_transformer_toy")
    params = dict(cfg["model.params"], dtype="float32")
    params.update({"modality.dim": 128, "modality.source.channels": 16,
                   "encoder.enable_flash_attention": True})
    for side in ("encoder", "decoder"):
        params.update({f"{side}.hidden_size": 128,
                       f"{side}.num_attention_heads": 2,
                       f"{side}.filter_size": 256})
    return dict(cfg, **{"model.params": _rates(params, rate)})


def _text_cfg(moe=False):
    # an MoE layer is every second one: two layers a stack there
    cfg = JaxTransformer.build_model_args_by_name(
        "transformer_32_2e_2d_4h" if moe else "transformer_32_1e_1d_4h")
    params = _rates(dict(cfg["model.params"], dtype="float32"), 0.0)
    if moe:
        for side in ("encoder", "decoder"):
            params.update({f"{side}.moe_num_experts": 4,
                           f"{side}.moe_layer_frequency": 2,
                           f"{side}.moe_top_k": 1,
                           f"{side}.moe_router_jitter": 0.0})
    return dict(cfg, **{"model.params": params})


def _text_batch(rng, n=3, length=10):
    lengths = np.asarray([length, 7, 4][:n])
    pad = (np.arange(length)[None] >= lengths[:, None]).astype(np.float32)
    return {"src": rng.randint(4, 40, (n, length)).astype(np.int32),
            "src_padding": pad,
            "trg_input": rng.randint(0, 48, (n, length)).astype(np.int32),
            "trg": rng.randint(0, 48, (n, length)).astype(np.int32),
            "trg_padding": pad}


def _speech_batch(rng):
    trg_lengths = np.asarray([7, 5, 3])
    return {"src": rng.randn(3, 64, 16, 1).astype(np.float32),
            "src_length": np.asarray([64, 45, 20], np.int32),
            "trg_input": rng.randint(0, 256, (3, 7)).astype(np.int32),
            "trg": rng.randint(0, 256, (3, 7)).astype(np.int32),
            "trg_padding": (np.arange(7)[None] >= trg_lengths[:, None]
                            ).astype(np.float32)}


CASES = {
    "speech_flash": dict(cfg=_speech_cfg, meta=SPEECH_META, cycle=1),
    "text_cycle2": dict(cfg=_text_cfg, meta=TEXT_META, cycle=2),
    "text_qat": dict(cfg=_text_cfg, meta=TEXT_META, cycle=1, quant=True),
    "switch_moe": dict(cfg=lambda: _text_cfg(moe=True), meta=TEXT_META,
                       cycle=1)}


def _quant(on):
    jql.global_init(on, **QUANT)
    ql.global_init(on, **QUANT)


def _capture_grads():
    """An optax transform whose state becomes the step's gradients (the
    parameters stay put)."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jax.numpy.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(jax.numpy.zeros_like, grads), grads))


def _batch(name, rng):
    case = CASES[name]
    make = _speech_batch if name == "speech_flash" else _text_batch
    if case["cycle"] == 1:
        return make(rng)
    a, b = make(rng), make(rng)
    b["trg_padding"][:, 6:] = 1.0  # ragged micro-batches
    return {k: np.stack([a[k], b[k]]) for k, v in a.items()}


@pytest.fixture(params=sorted(CASES))
def case(request):
    name = request.param
    c = CASES[name]
    _quant(bool(c.get("quant")))
    try:
        cfg = c["cfg"]()
        jm = jax_build(cfg, src_meta=c["meta"][0], trg_meta=c["meta"][1])
        rng = np.random.RandomState(0)
        params = jax.tree_util.tree_map_with_path(
            lambda path, v: np.asarray(
                rng.uniform(0.5, 1.5, v.shape) if "clip_max" in str(path[-1])
                else 0.3 * rng.randn(*v.shape), np.float32),
            jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)))
        batch = _batch(name, rng)
        tx = _capture_grads()
        step = jax.jit(jax_make_train_step(
            jm, jax_build_criterion(CRITERION), tx, update_cycle=c["cycle"],
            extra_loss_fn=jql.clip_l2_penalty if c.get("quant") else None,
            remat=True))
        state, metrics = step(JaxTrainState.create(params, tx), batch,
                              jax.random.PRNGKey(0))
        flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
        tm = neurst_tpu_torch.build_model(cfg, src_meta=c["meta"][0],
                                          trg_meta=c["meta"][1],
                                          device="cpu")
        load_flat_params(tm, flat)
        grads = flat_to_state_dict({k: np.asarray(v) for k, v in
                                    flatten_params(state.opt_state).items()},
                                   tm)
        yield name, cfg, tm, batch, float(metrics["loss"]), grads
    finally:
        _quant(False)


def _port_grads(tm, batch, cycle, quant, remat, rng=None):
    step = make_train_step(tm, build_criterion(CRITERION), None,
                           update_cycle=cycle, remat=remat,
                           extra_loss_fn=ql.clip_l2_penalty if quant
                           else None)
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()}
    return step.compute_grads(dict(tm.named_parameters()), inputs, rng)


def _near(got, want, tol):
    scale = float(want.abs().max())
    return float((got - want).abs().max()) <= tol * scale + 1e-9


def test_remat_step_matches_jax_remat_and_the_plain_step(case):
    name, _, tm, batch, jloss, jgrads = case
    c = CASES[name]
    loss, aux, grads = _port_grads(tm, batch, c["cycle"], c.get("quant"),
                                   True)
    plain_loss, plain_aux, plain = _port_grads(tm, batch, c["cycle"],
                                               c.get("quant"), False)
    assert abs(float(loss) - jloss) <= TOL * abs(jloss)
    assert torch.equal(loss, plain_loss) and torch.equal(aux, plain_aux)
    if name == "switch_moe":
        assert float(aux) > 0.0
    if name == "text_qat":
        assert any(n.endswith("_clip_max") and float(g) != 0.0
                   for n, g in grads.items())
    assert sorted(grads) == sorted(jgrads) == sorted(plain)
    for n, g in grads.items():
        assert _near(g, jgrads[n], GRAD_TOL), n
        assert _near(g, plain[n], SELF_TOL), n


def test_remat_with_dropout_draws_the_masks_again():
    """Speech with the recipe's dropout 0.1 at every site (the flash
    kernels' in-kernel dropout included): the recomputed forward draws
    the masks of the first, so loss and gradients equal the plain
    step's."""
    cfg = _speech_cfg(0.1)
    tm = neurst_tpu_torch.build_model(cfg, src_meta=SPEECH_META[0],
                                      trg_meta=SPEECH_META[1], device="cpu")
    tm.init_params(torch.Generator().manual_seed(0))
    batch = _speech_batch(np.random.RandomState(3))
    key = fold_in(make_key(5), 3)
    loss, _, grads = _port_grads(tm, batch, 1, False, True, key)
    plain_loss, _, plain = _port_grads(tm, batch, 1, False, False, key)
    other_loss = _port_grads(tm, batch, 1, False, True,
                             fold_in(make_key(5), 4))[0]
    assert torch.equal(loss, plain_loss)
    assert not torch.equal(loss, other_loss)
    for n, g in grads.items():
        assert _near(g, plain[n], SELF_TOL), n


def test_train_entry_with_gradient_remat_writes_the_same_checkpoint(
        tmp_path):
    os.chdir(REPO)
    with open("tests/examples/example_train_seq2seq.yml") as f:
        cfg = yaml.safe_load(f)
    cfg["task.params"]["shuffle_buffer"] = 0  # the same batches twice
    path = str(tmp_path / "train.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = {}
    for remat in ("false", "true"):
        d = str(tmp_path / remat)
        run_exp.cli_main(["--entry", "train", "--config_paths", path,
                          "--model_dir", d, "--device", "cpu",
                          "--train_steps", "3", "--save_checkpoint_steps",
                          "3", "--enable_tensorboard", "false",
                          "--gradient_remat", remat])
        out[remat] = ckpt_lib.restore_checkpoint_params(
            os.path.join(d, "ckpt-3.npz"))
    for name, want in out["false"].items():
        np.testing.assert_allclose(out["true"][name], want, rtol=0,
                                   atol=1e-6, err_msg=name)
