"""The port's joint ASR + ST model against the JAX package's, on the CPU.

``multi_task_speech_transformer`` at ``speech_transformer_toy`` width
(float32) over a 24-word translation and a 20-word transcript
vocabulary, one set of numpy-drawn weights carried into the port
through ``utils/param_bridge``:

- both heads' teacher-forcing logits within 1e-5 of their largest value,
  with encoder flash attention on (the JAX side runs the Pallas kernel in
  interpret mode), and with an ``asr_decoder.*`` config whose depth
  differs from the decoder's;
- the joint criterion (ST 1.0, ASR 0.3, label smoothing 0.1) at dropout
  0: the loss within 1e-5 relative, every gradient within 1e-4 of its
  largest, every weight after two Adam steps within 2 lr a step, and
  ``reduce_metrics``' names and values;
- dropout 0.1: the transcript decoder's masks are not the translation
  decoder's, the translation head's masks are the single-task model's,
  and the same (key, step) repeats its loss bitwise;
- beam search on each head: hypotheses equal up to the first EOS, scores
  within 1e-4;
- ``mixed_speech_text``: the first 64 examples equal the JAX dataset's.

``tests/test_torch_multitask_cli.py`` runs both packages' CLIs on the
model.
"""


import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import neurst_tpu_torch  # noqa: E402
from neurst_tpu.criterions.criterion import \
    build_criterion as jax_build_criterion  # noqa: E402
from neurst_tpu.data.datasets.dataset import \
    build_dataset as jax_build_dataset  # noqa: E402
from neurst_tpu.data.recordio import RecordWriter, build_example  # noqa: E402
from neurst_tpu.layers.search.sequence_search import \
    build_search_layer as jax_build_search  # noqa: E402
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
from neurst_tpu_torch.data.datasets.dataset import build_dataset  # noqa: E402
from neurst_tpu_torch.optimizers.optimizers import \
    create_optax_chain  # noqa: E402
from neurst_tpu_torch.parallel import (TrainState,  # noqa: E402
                                       make_eval_step, make_train_step)
from neurst_tpu_torch.utils.param_bridge import (  # noqa: E402
    flat_to_state_dict, load_flat_params)
from neurst_tpu_torch.utils.rng import fold_in, make_key  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TRG_META = {"vocab_size": 24, "eos_id": 1, "bos_id": 2, "unk_id": 3}
ASR_META = {"vocab_size": 20, "eos_id": 4, "bos_id": 5, "unk_id": 6}
FEATURE_DIM = 16
SRC_META = {"audio_feature_dim": FEATURE_DIM, "audio_feature_channels": 1}
SEARCH = {"beam_size": 4, "maximum_decode_length": 10,
          "extra_decode_length": 4, "length_penalty": 0.6,
          "decode_unroll": 1, "prefix_decode_chunk": 0}
CRITERIONS = (
    "[{class: label_smoothed_cross_entropy, params: {label_smoothing: 0.1},"
    " output_key: st, weight: 1.0},"
    " {class: label_smoothed_cross_entropy, params: {label_smoothing: 0.1},"
    " output_key: asr, input_prefix: asr, weight: 0.3}]")
JOINT = {"criterion.class": "joint_criterion",
         "criterion.params": {"criterions": CRITERIONS}}
OPT = {"beta_1": 0.9, "beta_2": 0.98, "epsilon": 1e-9}
LR = {"dmodel": 16, "warmup_steps": 10, "initial_factor": 1.0}
RATES = ("attention_dropout_rate", "ffn_dropout_rate",
         "layer_postprocess_dropout_rate")
LOGIT_TOL = 1e-5
TOL = 1e-5
GRAD_TOL = 1e-4
SCORE_TOL = 1e-4


def _config(dropout=0.0, asr_layers=None, generation_output="st",
            flash=False):
    cfg = JaxSpeechTransformer.build_model_args_by_name(
        "speech_transformer_toy")
    params = dict(cfg["model.params"], dtype="float32",
                  generation_output=generation_output)
    params["encoder.enable_flash_attention"] = flash
    for side in ("encoder", "decoder"):
        params.update({f"{side}.{rate}": dropout for rate in RATES})
    if asr_layers is not None:
        for key in ("num_layers", "hidden_size", "num_attention_heads",
                    "filter_size", *RATES):
            params[f"asr_decoder.{key}"] = params[f"decoder.{key}"]
        params["asr_decoder.num_layers"] = asr_layers
    return dict(cfg, **{"model.class": "multi_task_speech_transformer",
                        "model.params": params})


def _models(cfg, params=None):
    """(JAX model, its params, port model with the same weights); the
    params drawn from a seed where none are given."""
    jm = jax_build(cfg, src_meta=SRC_META, trg_meta=TRG_META,
                   asr_meta=ASR_META)
    if params is None:
        rng = np.random.RandomState(0)
        params = jax.tree_util.tree_map(
            lambda x: (0.5 * rng.randn(*x.shape)).astype(np.float32),
            jm.init_params(jax.random.PRNGKey(0)))
        # EOS biases so that beams end inside the decode window
        params["target_symbol_modality"]["bias"][TRG_META["eos_id"]] += 4.0
        params["asr_symbol_modality"]["bias"][ASR_META["eos_id"]] += 4.0
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    tm = neurst_tpu_torch.build_model(cfg, src_meta=SRC_META,
                                      trg_meta=TRG_META, asr_meta=ASR_META,
                                      device="cpu")
    load_flat_params(tm, flat)
    return jm, params, tm, flat


def _batch(rng, src_lengths, trg_lengths, asr_lengths, frames=32,
           trg_len=6, asr_len=7):
    out = {"src": rng.randn(len(src_lengths), frames, 16, 1).astype(
               np.float32),
           "src_length": np.asarray(src_lengths, np.int32)}
    for prefix, meta, lengths, n in (("", TRG_META, trg_lengths, trg_len),
                                     ("asr_", ASR_META, asr_lengths,
                                      asr_len)):
        lengths = np.asarray(lengths)
        out[prefix + "trg_input"] = rng.randint(
            0, meta["vocab_size"], (len(lengths), n)).astype(np.int32)
        out[prefix + "trg"] = rng.randint(
            0, meta["vocab_size"], (len(lengths), n)).astype(np.int32)
        out[prefix + "trg_padding"] = (
            np.arange(n)[None] >= lengths[:, None]).astype(np.float32)
    return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


@pytest.fixture(scope="module")
def pair():
    jm, params, tm, flat = _models(_config())
    rng = np.random.RandomState(1)
    batches = [_batch(rng, [32, 21, 9], [6, 4, 2], [7, 5, 3]),
               _batch(rng, [30, 32, 17], [5, 6, 1], [6, 7, 2])]
    return jm, params, tm, flat, batches


@pytest.mark.parametrize("asr_layers, flash", [(None, True), (1, False)])
def test_both_heads_logits(pair, asr_layers, flash):
    params = pair[1] if asr_layers is None else None
    jm, params, tm, _ = _models(_config(asr_layers=asr_layers, flash=flash),
                                params)
    if asr_layers is not None:
        assert tm.asr_decoder.num_layers == 1 != tm.decoder.num_layers
    rng = np.random.RandomState(2)
    batch = _batch(rng, [32, 21, 9], [6, 4, 2], [7, 5, 3])
    ref = jm.call(params, batch)
    with torch.no_grad():
        ours = tm(batch)
        st_only = tm({k: v for k, v in batch.items()
                      if not k.startswith("asr_")})
    assert set(ours) == set(ref) == {"st", "asr"}
    for head in ("st", "asr"):
        want = np.asarray(ref[head])
        assert want.shape[-1] == (TRG_META if head == "st"
                                  else ASR_META)["vocab_size"]
        err = np.abs(_np(ours[head]) - want).max()
        assert err <= LOGIT_TOL * max(1.0, np.abs(want).max()), head
    assert torch.equal(st_only, ours["st"])
    assert not tm.supports_fused_softmax_ce()
    assert jm.supports_fused_softmax_ce() is False


def test_flat_names_round_trip(pair):
    """The port's parameters come back under the JAX names
    (``asr_decoder/...``, ``asr_symbol_modality/...``)."""
    from neurst_tpu_torch.utils.param_bridge import state_dict_to_flat
    _, _, tm, flat, _ = pair
    back = state_dict_to_flat(tm)
    assert sorted(back) == sorted(flat)
    assert any(k.startswith("asr_decoder/") for k in back)
    assert "asr_symbol_modality/weights" in back
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


def _jax_tx():
    return jax_chain(JaxAdam(OPT), JaxNoam(LR))


def _port_step(cfg, flat):
    model = neurst_tpu_torch.build_model(cfg, src_meta=SRC_META,
                                         trg_meta=TRG_META,
                                         asr_meta=ASR_META, device="cpu")
    load_flat_params(model, flat)
    lr = neurst_tpu_torch.build_lr_schedule({"lr_schedule.class": "noam",
                                             "lr_schedule.params": LR})
    tx = create_optax_chain(neurst_tpu_torch.build_optimizer(
        {"optimizer.class": "adam", "optimizer.params": OPT}), lr)
    crit = neurst_tpu_torch.build_criterion(JOINT)
    step = make_train_step(model, crit, tx, lr_schedule=lr)
    return model, crit, step, TrainState.create(
        dict(model.named_parameters()), tx)


def test_joint_loss_gradients_and_two_steps(pair):
    jm, params, _, flat, batches = pair
    crit = jax_build_criterion(JOINT)
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]

    def loss_fn(p, batch):
        out, aux = jm.call_train(p, batch)
        return crit.reduce_loss(batch, out) + aux

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, jbatches[0])
    tx = _jax_tx()
    jstep = jax.jit(jax_make_train_step(jm, crit, tx,
                                        lr_schedule=JaxNoam(LR)))
    state = JaxTrainState.create(params, tx)
    metrics = []
    for batch in jbatches:
        state, m = jstep(state, batch, jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})

    model, _, step, tstate = _port_step(_config(), flat)
    tloss, aux, tgrads = step.compute_grads(tstate.params, batches[0])
    assert _rel(tloss, loss) <= TOL and float(aux) == 0.0
    ref = flat_to_state_dict({k: np.asarray(v) for k, v in
                              flatten_params(grads).items()}, model)
    assert sorted(tgrads) == sorted(ref)
    assert any(n.startswith("asr_decoder.") for n in tgrads)
    for name, g in tgrads.items():
        want = ref[name]
        assert float((g - want).abs().max()) \
            <= GRAD_TOL * float(want.abs().max()) + 1e-9, name
    for batch, want in zip(batches, metrics):
        tstate, m = step(tstate, batch)
        assert _rel(m["loss"], want["loss"]) <= TOL
        assert _rel(m["grad_norm"], want["grad_norm"]) <= TOL
    lrs = JaxNoam(LR)
    atol = 2 * (float(lrs(0)) + float(lrs(1)))
    ref = flat_to_state_dict({k: np.asarray(v) for k, v in flatten_params(
        state.params).items()}, model)
    for name, p in model.named_parameters():
        assert float((p.detach() - ref[name]).abs().max()) <= atol, name


def test_reduce_metrics_match_jax(pair):
    jm, params, tm, _, batches = pair
    jcrit = jax_build_criterion(JOINT)
    tcrit = neurst_tpu_torch.build_criterion(JOINT)
    jeval = jax.jit(jax_make_eval_step(jm, jcrit))
    teval = make_eval_step(tm, tcrit)
    ref = jcrit.reduce_metrics([jeval(params, {k: jnp.asarray(v)
                                               for k, v in b.items()})
                                for b in batches])
    ours = tcrit.reduce_metrics([teval(b) for b in batches])
    assert sorted(ours) == sorted(ref) == ["asr_NLL", "asr_PPL", "st_NLL",
                                           "st_PPL"]
    for k in ref:
        assert _rel(ours[k], ref[k]) <= TOL, k
    assert type(tcrit.as_metric()).__name__ == "MetricWrapper"
    assert tcrit.as_metric().flag == jcrit.as_metric().flag == "NLL"


def test_dropout_streams_of_the_two_decoders():
    """At dropout 0.1 with one key: the transcript decoder's masks are
    its own (with the translation decoder's weights, vocabulary and
    inputs it gives other outputs than the translation decoder, which it
    matches at dropout 0); the translation head draws the single-task
    SpeechTransformer's masks; the same (key, step) repeats the loss
    bitwise and the next step does not."""
    cfg = _config(dropout=0.1)
    same_meta = dict(TRG_META)
    model = neurst_tpu_torch.build_model(cfg, src_meta=SRC_META,
                                         trg_meta=TRG_META,
                                         asr_meta=same_meta, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.asr_symbol_modality.weights.copy_(
            model.target_symbol_modality.weights)
        model.asr_decoder.load_state_dict(model.decoder.state_dict())
    rng = np.random.RandomState(3)
    batch = _batch(rng, [32, 21, 9], [6, 4, 2], [6, 4, 2], asr_len=6)
    batch["asr_trg_input"] = batch["trg_input"]
    key = fold_in(make_key(7), 3)
    with torch.no_grad():
        plain = model(batch, is_training=False)
        dropped = model(batch, is_training=True, dropout_key=key)
    assert torch.equal(plain["st"], plain["asr"])
    assert not torch.equal(dropped["st"], dropped["asr"])

    single_cfg = dict(cfg, **{"model.class": "SpeechTransformer"})
    single_cfg["model.params"] = {
        k: v for k, v in cfg["model.params"].items()
        if k != "generation_output"}
    single = neurst_tpu_torch.build_model(single_cfg, src_meta=SRC_META,
                                          trg_meta=TRG_META, device="cpu")
    single.load_state_dict({k: v for k, v in model.state_dict().items()
                            if not k.startswith("asr_")})
    with torch.no_grad():
        st = single(batch, is_training=True, dropout_key=key)
    assert torch.equal(st, dropped["st"])

    crit = neurst_tpu_torch.build_criterion(JOINT)
    lr = neurst_tpu_torch.build_lr_schedule({"lr_schedule.class": "noam",
                                             "lr_schedule.params": LR})
    tx = create_optax_chain(neurst_tpu_torch.build_optimizer(
        {"optimizer.class": "adam", "optimizer.params": OPT}), lr)
    step = make_train_step(model, crit, tx)
    params = dict(model.named_parameters())
    losses = [float(step.compute_grads(params, batch,
                                       fold_in(make_key(7), s))[0])
              for s in (5, 5, 6)]
    assert losses[0] == losses[1] != losses[2]
    with pytest.raises(ValueError, match="dropout key"):
        step.compute_grads(params, batch)


def _until_eos(row, eos):
    row = list(row)
    return row[:row.index(eos) + 1] if eos in row else row


@pytest.mark.parametrize("head", ["st", "asr"])
def test_beam_search_on_each_head(pair, head):
    jm, params, tm, _ = _models(_config(generation_output=head), pair[1])
    assert tm.generation_meta == (ASR_META if head == "asr" else TRG_META)
    rng = np.random.RandomState(4)
    src = {"src": rng.randn(3, 29, 16, 1).astype(np.float32),
           "src_length": np.asarray([29, 17, 6], np.int32)}
    jsearch = jax_build_search({"search_method.class": "beam_search",
                                "search_method.params": SEARCH})
    jsearch.set_model(jm)
    jh, js = jsearch(params, src)
    tsearch = neurst_tpu_torch.build_search_layer(
        {"search_method.class": "beam_search",
         "search_method.params": SEARCH})
    tsearch.set_model(tm)
    th, ts = tsearch(src)
    eos = (ASR_META if head == "asr" else TRG_META)["eos_id"]
    for ours, ref in zip(_np(th).tolist(), np.asarray(jh).tolist()):
        assert _until_eos(ours, eos) == _until_eos(ref, eos)
    assert float(np.abs(_np(ts) - np.asarray(js)).max()) <= SCORE_TOL
    assert any(eos in row for row in _np(th).tolist())
    vocab = (ASR_META if head == "asr" else TRG_META)["vocab_size"]
    assert int(_np(th).max()) < vocab


# ------------------------------------------------ mixed_speech_text

def test_mixed_speech_text_order_matches_jax(tmp_path):
    rng = np.random.RandomState(6)
    paths = {}
    for kind in ("asr", "st"):
        for name in ("a", "b"):
            path = str(tmp_path / f"{kind}_{name}.tfrecords")
            paths.setdefault(kind, {})[name] = path
            with RecordWriter(path) as w:
                for _ in range(int(rng.randint(3, 7))):
                    ex = {"audio": rng.randn(4 * FEATURE_DIM).astype(
                              np.float32),
                          "transcript": rng.randint(4, 20, size=int(
                              rng.randint(2, 6))).astype(np.int64)}
                    if kind == "st":
                        ex["translation"] = rng.randint(4, 24, size=int(
                            rng.randint(2, 6))).astype(np.int64)
                    w.write(build_example(ex))
    mt = str(tmp_path / "mt.tfrecords")
    paths["mt"] = {"text": mt}
    with RecordWriter(mt) as w:
        for _ in range(5):
            w.write(build_example({
                "feature": rng.randint(4, 20, size=3).astype(np.int64),
                "label": rng.randint(4, 20, size=4).astype(np.int64)}))
    common = {"feature_key": "audio", "transcript_key": "transcript"}
    params = {
        "asr_record_paths": paths["asr"], "st_record_paths": paths["st"],
        "mt_record_paths": paths["mt"],
        "asr_common_properties": common,
        "st_common_properties": dict(common, translation_key="translation"),
        "data_sampler.class": "data_sampler",
        "data_sampler.params": {"sample_ratios": {
            "asr:a": 1.0, "asr:b": 2.0, "st:a": 3.0, "st:b": 1.0,
            "mt:text": 2.0}},
        "seed": 11}
    cfg = {"dataset.class": "mixed_speech_text", "dataset.params": params}
    for shard in (0, 1):
        ours = build_dataset(cfg).build_iterator(shard_id=shard,
                                                 total_shards=2)()
        ref = jax_build_dataset(cfg).build_iterator(shard_id=shard,
                                                    total_shards=2)()
        tags = set()
        for _ in range(64):
            a, b = next(ours), next(ref)
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]), err_msg=k)
            tags.add((a["task_of"], a["dataset_key"]))
        assert {t for t, _ in tags} == {"asr", "st", "mt"}
    # by size where no ratios are given
    del params["data_sampler.params"]
    ours = build_dataset(cfg).build_iterator()()
    ref = jax_build_dataset(cfg).build_iterator()()
    assert [next(ours)["dataset_key"] for _ in range(64)] \
        == [next(ref)["dataset_key"] for _ in range(64)]
