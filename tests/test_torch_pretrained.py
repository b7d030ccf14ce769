"""The pretrained-trunk family in the port against the JAX package's:
BERT, CTNMT in its three ``bert_mode``s, the distillation criterion,
GPT-2 (forward, stepwise decode, prompted beam and greedy decodes) and
wav2vec 2.0.

One set of weights per case comes from the JAX initializers, carried
into the port through ``utils/param_bridge``; both packages run the same
numpy-seeded inputs in float32 (``jax_default_matmul_precision=float32``
from conftest; TF32 off).

Tolerances: states and logits 2e-5 absolute (their magnitudes are O(1)
to O(10) here: post-norm states are LayerNorm outputs), but wav2vec 2.0's
outputs within 2e-5 of max(1, their largest |value|) (its encoder states
reach ~3.2 here); losses 1e-5 relative; every gradient within 1e-4 of
its largest |value|; decoded ids exactly.
"""

import re

import numpy as np
import optax
import pytest
import torch

import port_test_support  # noqa: F401  (one torch thread per worker)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import neurst_tpu_torch  # noqa: E402
from neurst_tpu.criterions.label_smoothed_cross_entropy_with_kd import \
    LabelSmoothedCrossEntropyWithKd as JaxKd  # noqa: E402
from neurst_tpu.layers.search.sequence_search import \
    build_search_layer as jax_build_search  # noqa: E402
from neurst_tpu.models.ctnmt_transformer import \
    CtnmtTransformer as JaxCtnmt  # noqa: E402
from neurst_tpu.models.model import build_model as jax_build  # noqa: E402
from neurst_tpu.optimizers.optimizers import \
    build_optimizer as jax_build_optimizer  # noqa: E402
from neurst_tpu.optimizers.optimizers import \
    create_optax_chain as jax_chain  # noqa: E402
from neurst_tpu.utils.checkpoints import (flatten_params,  # noqa: E402
                                          unflatten_params)
from neurst_tpu_torch.models.ctnmt_transformer import \
    CtnmtTransformer  # noqa: E402
from neurst_tpu_torch.optimizers.optimizers import (  # noqa: E402
    apply_updates, create_optax_chain, freeze)
from neurst_tpu_torch.parallel import make_train_step  # noqa: E402
from neurst_tpu_torch.utils.param_bridge import (  # noqa: E402
    flat_to_state_dict, load_flat_params, state_dict_to_flat, to_jax_name)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 2e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
SRC_META = {"vocab_size": 40, "eos_id": 1, "bos_id": 2, "unk_id": 3,
            "pad_id": 1}
TRG_META = {"vocab_size": 48, "eos_id": 1, "bos_id": 2, "unk_id": 3,
            "pad_id": 1}
MODES = ["dynamic_switch", "bert_as_encoder", "bert_distillation"]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _max_diff(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(params).items()}


def _load(tm, params):
    load_flat_params(tm, _flat(params))
    return tm


def _grads_close(ours, ref_flat, tm):
    ref = flat_to_state_dict(ref_flat, tm)
    assert sorted(ours) == sorted(ref)
    for name, g in ours.items():
        assert float((g - ref[name]).abs().max()) \
            <= GRAD_TOL * float(ref[name].abs().max()) + 1e-9, name


# ------------------------------- BERT -------------------------------- #

def test_bert_encoder_and_pooled_outputs_match_jax():
    cfg = {"model.class": "bert", "model.params": {
        "num_layers": 2, "hidden_size": 32, "num_attention_heads": 4,
        "filter_size": 64, "max_positions": 32, "dtype": "float32"}}
    jm = jax_build(cfg, src_meta=SRC_META)
    params = jm.init_params(jax.random.PRNGKey(0))
    tm = _load(neurst_tpu_torch.build_model(cfg, src_meta=SRC_META,
                                            device="cpu"), params)
    assert sorted(state_dict_to_flat(tm)) == sorted(_flat(params))
    rng = np.random.RandomState(0)
    lengths = np.array([9, 5, 2])
    inputs = {"src": rng.randint(4, 40, (3, 9)).astype(np.int32),
              "src_padding": (np.arange(9)[None] >= lengths[:, None]
                              ).astype(np.float32),
              "segment_ids": rng.randint(0, 2, (3, 9)).astype(np.int32)}
    want = jm.call(params, inputs)
    with torch.no_grad():
        ours = tm(inputs)
    for key in ("encoder_outputs", "pooled_output"):
        assert _max_diff(ours[key], want[key]) <= TOL, key
    # epsilon 1e-12 reaches every LayerNorm of the trunk
    eps = {m.epsilon for m in tm.modules() if hasattr(m, "epsilon")}
    assert eps == {1e-12}


# ------------------------------- CTNMT ------------------------------- #

def _ctnmt_cfg(mode):
    cfg = JaxCtnmt.build_model_args_by_name("ctnmt_toy")
    params = dict(cfg["model.params"], bert_mode=mode, dtype="float32")
    params.update({"modality.dim": 16, "bert.hidden_size": 16,
                   "bert.num_layers": 2, "bert.num_attention_heads": 2,
                   "bert.filter_size": 32, "bert.max_positions": 32})
    for side in ("encoder", "decoder"):
        params.update({f"{side}.hidden_size": 16,
                       f"{side}.filter_size": 24,
                       f"{side}.attention_dropout_rate": 0.0,
                       f"{side}.ffn_dropout_rate": 0.0,
                       f"{side}.layer_postprocess_dropout_rate": 0.0})
    if mode == "bert_as_encoder":
        params = {k: v for k, v in params.items()
                  if not k.startswith("encoder.")}
    return dict(cfg, **{"model.params": params})


@pytest.fixture
def bert_dropout_zero(monkeypatch):
    """The BERT trunk's dropout is BertModule's default 0.1 in both
    packages whatever the model flags; these cases compare gradients at
    dropout 0 (the two packages draw different masks), so both builders
    pass 0 to the trunk."""
    jax_kwargs = JaxCtnmt.module_kwargs

    def jax_module_kwargs(self):
        kw = jax_kwargs(self)
        kw["bert_cfg"] = dict(kw["bert_cfg"], dropout_rate=0.0)
        return kw

    port_config = CtnmtTransformer.bert_config
    monkeypatch.setattr(JaxCtnmt, "module_kwargs", jax_module_kwargs)
    monkeypatch.setattr(CtnmtTransformer, "bert_config",
                        lambda self: dict(port_config(self),
                                          dropout_rate=0.0))


def _ctnmt_pair(mode):
    cfg = _ctnmt_cfg(mode)
    jm = jax_build(cfg, src_meta=SRC_META, trg_meta=TRG_META)
    params = jm.init_params(jax.random.PRNGKey(1))
    tm = _load(neurst_tpu_torch.build_model(
        cfg, src_meta=SRC_META, trg_meta=TRG_META, device="cpu"), params)
    return jm, params, tm


def _ctnmt_batch(rng):
    src_len, trg_len = np.array([7, 4, 2]), np.array([3, 6, 5])
    return {
        "src": rng.randint(4, 40, (3, 7)).astype(np.int32),
        "src_padding": (np.arange(7)[None] >= src_len[:, None]).astype(
            np.float32),
        "trg_input": rng.randint(4, 48, (3, 6)).astype(np.int32),
        "trg": rng.randint(4, 48, (3, 6)).astype(np.int32),
        "trg_padding": (np.arange(6)[None] >= trg_len[:, None]).astype(
            np.float32)}


@pytest.mark.parametrize("mode", MODES)
def test_ctnmt_logits_loss_and_gradients_match_jax(mode, bert_dropout_zero):
    """Each mode: inference logits; the training loss (the KD criterion
    for bert_distillation, whose training forward returns the states) and
    every gradient; then one SGD step (linear in the gradients, so the
    gradients' tolerance carries over) with ``bert`` frozen as the
    trainers freeze it: BERT stays bit for bit, the rest moves as in
    JAX."""
    jm, params, tm = _ctnmt_pair(mode)
    names = sorted(state_dict_to_flat(tm))
    assert names == sorted(_flat(params))
    n_bert = sum(n.startswith("bert/") for n in names)
    assert n_bert == 7 + 12 * 2
    assert ("encoder/output_ln/scale" in names) == (mode != "bert_as_encoder")
    assert ("ds_gate_w/kernel" in names) == (mode == "dynamic_switch")
    batch = _ctnmt_batch(np.random.RandomState(2))
    with torch.no_grad():
        logits = tm(batch)
    assert _max_diff(logits, jm.call(params, batch)) <= TOL

    crit_args = {"label_smoothing": 0.1, "kd_weight": 0.5}
    jcrit = JaxKd(crit_args)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        out, aux = jm.call_train(p, jbatch)
        return jcrit.reduce_loss(jbatch, out) + aux

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    crit = neurst_tpu_torch.build_criterion(
        {"criterion.class": "label_smoothed_cross_entropy_with_kd",
         "criterion.params": crit_args})
    tx = freeze(create_optax_chain(neurst_tpu_torch.build_optimizer(
        {"optimizer.class": "sgd", "optimizer.params": {}}), 1e-2),
        lambda n: bool(re.search("bert", to_jax_name(n))))
    step = make_train_step(tm, crit, tx)
    live = dict(tm.named_parameters())
    ours, _, our_grads = step.compute_grads(live, batch)
    assert abs(float(ours) - float(loss)) <= LOSS_TOL * abs(float(loss))
    _grads_close(our_grads, _flat(grads), tm)
    if mode == "bert_distillation":
        out = tm.call_train(batch)[0]
        assert set(out) == {"logits", "kd_student_states",
                            "kd_teacher_states", "kd_padding"}
        assert not out["kd_teacher_states"].requires_grad

    # one step with BERT frozen, in both packages
    jtx = optax.multi_transform(
        {"train": jax_chain(jax_build_optimizer(
            {"optimizer.class": "sgd", "optimizer.params": {}}), 1e-2),
         "frozen": optax.set_to_zero()},
        lambda p: unflatten_params({k: ("frozen" if "bert" in k else
                                        "train")
                                    for k in flatten_params(p)}))
    updates, _ = jtx.update(grads, jtx.init(params), params)
    want = _flat(optax.apply_updates(params, updates))
    before = {n: p.detach().clone() for n, p in live.items()}
    updates, _ = tx.update(our_grads, tx.init(live), live)
    apply_updates(live, updates)
    after = state_dict_to_flat(tm)
    for name, value in after.items():
        if name.startswith("bert/"):
            assert np.array_equal(value, _flat(params)[name]), name
            continue
        assert np.abs(value - want[name]).max() <= 1e-6, name
    assert any(not torch.equal(before[n], p) for n, p in live.items()
               if not to_jax_name(n).startswith("bert/"))


def test_ctnmt_takes_the_logits_path_as_jax():
    """CTNMT overrides the teacher forcing forward, so the JAX package
    never fuses its projection into the cross-entropy; the port's model
    says False too, at a D in the fused kernels' dims and a V that is a
    multiple of 128, where a Transformer says True."""
    from neurst_tpu_torch.ops.fused_ce import DIMS
    d = 256
    assert d in DIMS
    meta = dict(TRG_META, vocab_size=1024)
    cfg = _ctnmt_cfg("dynamic_switch")
    params = dict(cfg["model.params"], **{"modality.dim": d,
                                          "bert.hidden_size": d})
    for side in ("encoder", "decoder"):
        params[f"{side}.hidden_size"] = d
    cfg = dict(cfg, **{"model.params": params})
    tm = neurst_tpu_torch.build_model(cfg, src_meta=meta, trg_meta=meta,
                                      device="meta")
    jm = jax_build(cfg, src_meta=meta, trg_meta=meta)
    assert not tm.supports_fused_softmax_ce()
    assert not jm.supports_fused_softmax_ce()
    plain = neurst_tpu_torch.build_model(
        dict(cfg, **{"model.class": "transformer", "model.params": {
            k: v for k, v in params.items()
            if not k.startswith("bert")}}),
        src_meta=meta, trg_meta=meta, device="meta")
    assert plain.supports_fused_softmax_ce()


def test_ctnmt_distillation_skips_bert_at_inference(bert_dropout_zero):
    """bert_distillation: the decode encodes without BERT (the trunk's
    parameters may hold anything), and the decode matches JAX."""
    jm, params, tm = _ctnmt_pair("bert_distillation")
    with torch.no_grad():
        tm.bert.word_embedding.fill_(float("nan"))
    batch = _ctnmt_batch(np.random.RandomState(3))
    src = {k: batch[k] for k in ("src", "src_padding")}
    with torch.no_grad():
        enc, _ = tm.encode(src)
    assert torch.isfinite(enc).all()
    want, _ = jm._module.apply({"params": params}, src,
                               method=jm._module.encode)
    assert _max_diff(enc, want) <= TOL


# ---------------------------- KD criterion --------------------------- #

@pytest.mark.parametrize("kd_weight", [0.0, 0.5])
@pytest.mark.parametrize("where", ["model_out", "model_inp"])
@pytest.mark.parametrize("temperature", [1.0, 2.0])
def test_kd_criterion_logit_branch_matches_jax(kd_weight, where,
                                               temperature):
    rng = np.random.RandomState(4)
    logits = rng.randn(2, 5, 11).astype(np.float32)
    teacher = rng.randn(2, 5, 11).astype(np.float32)
    inp = {"trg": rng.randint(0, 11, (2, 5)).astype(np.int32),
           "trg_padding": np.array([[0, 0, 0, 1, 1], [0] * 5], np.float32)}
    args = {"label_smoothing": 0.1, "kd_weight": kd_weight,
            "kd_temperature": temperature}
    if where == "model_out":
        out, jin = {"logits": logits, "teacher_logits": teacher}, inp
    else:
        out, jin = logits, dict(inp, teacher_logits=teacher)
    jcrit = JaxKd(args)
    crit = neurst_tpu_torch.build_criterion(
        {"criterion.class": "label_smoothed_cross_entropy_with_kd",
         "criterion.params": args})
    tout = ({k: torch.from_numpy(v) for k, v in out.items()}
            if isinstance(out, dict) else torch.from_numpy(out))
    want = float(jcrit.reduce_loss(jin, out))
    assert abs(float(crit.reduce_loss(jin, tout)) - want) \
        <= LOSS_TOL * abs(want)
    for ours, theirs in zip(crit.reduce_loss_terms(jin, tout),
                            jcrit.reduce_loss_terms(jin, out)):
        assert abs(float(ours) - float(theirs)) \
            <= LOSS_TOL * abs(float(theirs))


@pytest.mark.parametrize("kd_weight", [0.0, 0.5])
def test_kd_criterion_state_branch_and_teacher_equal_student(kd_weight):
    """CTNMT's state term (squared L2 sum over the hidden dim, averaged
    over source positions; the token-weighted terms fold it in per target
    token, the JAX approximation kept), and with the teacher equal to the
    student the KD term vanishing in both branches."""
    rng = np.random.RandomState(5)
    logits = rng.randn(2, 3, 7).astype(np.float32)
    enc = rng.randn(2, 4, 8).astype(np.float32)
    bert = rng.randn(2, 4, 8).astype(np.float32)
    inp = {"trg": np.array([[1, 2, 3], [4, 5, 6]], np.int32),
           "trg_padding": np.array([[0, 0, 1], [0, 0, 0]], np.float32)}
    args = {"label_smoothing": 0.1, "kd_weight": kd_weight}
    jcrit = JaxKd(args)
    crit = neurst_tpu_torch.build_criterion(
        {"criterion.class": "label_smoothed_cross_entropy_with_kd",
         "criterion.params": args})
    plain = neurst_tpu_torch.build_criterion(
        {"criterion.class": "label_smoothed_cross_entropy",
         "criterion.params": {"label_smoothing": 0.1}})
    ce = float(plain.reduce_loss(inp, torch.from_numpy(logits)))
    pad = np.array([[0, 0, 0, 1], [0, 0, 0, 0]], np.float32)
    for teacher in (bert, enc):
        out = {"logits": logits, "kd_student_states": enc,
               "kd_teacher_states": teacher, "kd_padding": pad}
        tout = {k: torch.from_numpy(v) for k, v in out.items()}
        want = float(jcrit.reduce_loss(inp, out))
        assert abs(float(crit.reduce_loss(inp, tout)) - want) \
            <= LOSS_TOL * abs(want)
        for ours, theirs in zip(crit.reduce_loss_terms(inp, tout),
                                jcrit.reduce_loss_terms(inp, out)):
            assert abs(float(ours) - float(theirs)) \
                <= LOSS_TOL * abs(float(theirs))
    # teacher == student: the state term and the logit KL vanish
    assert abs(float(crit.reduce_loss(inp, tout))
               - (1.0 - kd_weight) * ce) <= 1e-5
    same = {"logits": torch.from_numpy(logits),
            "teacher_logits": torch.from_numpy(logits)}
    kl_ce = float(plain.reduce_loss(inp, same["logits"]))
    assert abs(float(crit.reduce_loss(inp, same))
               - (1.0 - kd_weight) * kl_ce) <= 1e-4
    assert neurst_tpu_torch.build_criterion(
        {"criterion.class": "label_smoothed_cross_entropy_with_kd",
         "criterion.params": {}})._kd_weight == 0.1


# ------------------------------- GPT-2 ------------------------------- #

GPT_META = {"vocab_size": 50, "eos_id": 1, "bos_id": 1, "unk_id": 3,
            "pad_id": 1}


@pytest.fixture(scope="module")
def gpt2_pair():
    cfg = {"model.class": "gpt2", "model.params": {
        "num_layers": 2, "hidden_size": 32, "num_attention_heads": 4,
        "filter_size": 64, "max_positions": 64, "dtype": "float32"}}
    jm = jax_build(cfg, trg_meta=GPT_META)
    params = jm.init_params(jax.random.PRNGKey(2))
    tm = _load(neurst_tpu_torch.build_model(cfg, trg_meta=GPT_META,
                                            device="cpu"), params)
    return jm, params, tm


def test_gpt2_logits_and_stepwise_decode_match(gpt2_pair):
    """The forward against JAX, and the port's own stepwise decode (the
    cache without cross-attention) against its forward, position by
    position."""
    jm, params, tm = gpt2_pair
    names = state_dict_to_flat(tm)
    assert not any("cross_attention" in n for n in names)
    assert "target_symbol_modality/bias" not in names
    ids = np.random.RandomState(6).randint(4, 50, (2, 9)).astype(np.int32)
    with torch.no_grad():
        full = tm({"trg_input": ids})
        assert _max_diff(full, jm.call(params, {"trg_input": ids})) <= TOL
        cache = tm.init_cache(2, 9)
        for t in range(9):
            step, cache = tm.decode_step(torch.from_numpy(ids[:, t]).long(),
                                         cache, t)
            assert _max_diff(step, full[:, t]) <= TOL, t


@pytest.mark.parametrize("beam", [1, 3], ids=["greedy", "beam3"])
def test_gpt2_prompted_decode_matches_jax_ids(gpt2_pair, beam):
    """Prompts of different lengths in one batch, right-padded with the
    pad id: both packages prefill every column but the last and start
    from the last column (the shorter prompt's pad), as the JAX
    ``_prefill`` does; the decoded ids are equal."""
    jm, params, tm = gpt2_pair
    prompt = np.array([[5, 9, 13, 17, 21, 25], [7, 11, 15, 1, 1, 1]],
                      np.int32)
    sp = {"beam_size": beam, "maximum_decode_length": 8,
          "length_penalty": 0.6, "extra_decode_length": 0}
    jsearch = jax_build_search({
        "search_method.class": "beam_search",
        "search_method.params": dict(sp, decode_unroll=1,
                                     prefix_decode_chunk=0)})
    jsearch.set_model(jm)
    want = jsearch(params, {"trg_input": prompt})
    want = np.asarray(want[0] if isinstance(want, (tuple, list)) else want)
    search = neurst_tpu_torch.build_search_layer({
        "search_method.class": "beam_search", "search_method.params": sp})
    search.set_model(tm)
    ours, _ = search({"trg_input": prompt})
    assert ours.numpy().tolist() == want.tolist()


def test_gpt2_speculative_steps_are_not_ported(gpt2_pair):
    """GPT-2's multi-token steps, once refused, now run: after a prompt's
    prefill, a k-wide step at per-row times gives the JAX model's logits
    (the cache position is time + prefill in both packages)."""
    jm, params, tm = gpt2_pair
    prompt = np.array([[5, 9, 13, 17], [7, 11, 15, 1]], np.int32)
    ids = np.array([[21, 22, 23], [24, 25, 26]], np.int32)
    times = np.array([0, 2], np.int32)
    j_fn, j_init = jm.prepare_speculative(params, {"trg_input": prompt}, 8)
    want, _ = j_fn(jax.numpy.asarray(ids), j_init["decoder_internal_cache"],
                   jax.numpy.asarray(times))
    with torch.no_grad():
        t_fn, t_init = tm.prepare_speculative({"trg_input": prompt}, 8)
        got, _ = t_fn(torch.from_numpy(ids).long(),
                      t_init["decoder_internal_cache"],
                      torch.from_numpy(times).long())
    assert _max_diff(got, want) <= TOL


# ----------------------------- wav2vec 2.0 ---------------------------- #

def test_wav2vec2_features_states_and_padding_match_jax():
    from neurst_tpu_torch.models.wav2vec2 import wav2vec2_output_length
    cfg = {"model.class": "wav2vec2", "model.params": {
        "num_layers": 2, "hidden_size": 32, "num_attention_heads": 2,
        "filter_size": 64, "dtype": "float32"}}
    jm = jax_build(cfg)
    params = jm.init_params(jax.random.PRNGKey(3))
    tm = _load(neurst_tpu_torch.build_model(cfg, device="cpu"), params)
    assert tuple(tm.state_dict()["pos_conv.weight"].shape) == (32, 2, 128)
    rng = np.random.RandomState(7)
    inputs = {"src": rng.randn(2, 4000).astype(np.float32),
              "src_length": np.array([4000, 2600], np.int32)}
    want = jm.call(params, inputs)
    with torch.no_grad():
        ours = tm(inputs)
    assert ours["features"].shape[1] == wav2vec2_output_length(4000)
    for key in ("features", "encoder_outputs", "padding"):
        scale = max(1.0, float(np.abs(np.asarray(want[key])).max()))
        assert _max_diff(ours[key], want[key]) <= TOL * scale, key
    assert float(ours["padding"][1].sum()) == \
        wav2vec2_output_length(4000) - wav2vec2_output_length(2600)
