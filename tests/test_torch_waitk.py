"""The port's wait-k Transformer and task against the JAX package's.

A ``waitk_transformer`` (d 32, 2 + 2 layers, 4 heads, filter 64,
vocabulary 256, monotonic encoder, ``wait_k: [2, 3, 5]``, float32) gets
one set of weights from the JAX initializers, carried into the port
through ``utils/param_bridge``; both packages run the same numpy-seeded
batches (``jax_default_matmul_precision=float32`` from conftest; TF32
off).  JAX's flash attention runs as its own tests run it on the CPU
(the Pallas interpreter), the port's through its plain version.

Tolerances: logits and loss 1e-5 relative (logits relative to their
largest |value|); every gradient within 1e-4 of its largest |value|;
the wait-k bias, the lagging draws and their fields exact.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import neurst_tpu_torch  # noqa: E402
from neurst_tpu.criterions.label_smoothed_cross_entropy import \
    LabelSmoothedCrossEntropy as JaxCriterion  # noqa: E402
from neurst_tpu.layers import layer_utils as jax_layer_utils  # noqa: E402
from neurst_tpu.models.model import build_model as jax_build  # noqa: E402
from neurst_tpu.models.waitk_transformer import \
    WaitkTransformer as JaxWaitk  # noqa: E402
from neurst_tpu.tasks.task import build_task as jax_build_task  # noqa: E402
from neurst_tpu.utils.checkpoints import flatten_params  # noqa: E402
from neurst_tpu.utils.compat import ModeKeys as JaxModeKeys  # noqa: E402
from neurst_tpu_torch.data.datasets.dataset import \
    build_dataset  # noqa: E402
from neurst_tpu_torch.exps.trainer import split_microbatches  # noqa: E402
from neurst_tpu_torch.layers import layer_utils  # noqa: E402
from neurst_tpu_torch.layers.attentions import \
    multi_head_attention as port_mha  # noqa: E402
from neurst_tpu_torch.models.waitk_transformer import \
    WaitkTransformer  # noqa: E402
from neurst_tpu_torch.optimizers.optimizers import \
    create_optax_chain  # noqa: E402
from neurst_tpu_torch.parallel import make_train_step  # noqa: E402
from neurst_tpu_torch.tasks.task import build_task  # noqa: E402
from neurst_tpu_torch.utils.compat import ModeKeys  # noqa: E402
from neurst_tpu_torch.utils.param_bridge import (  # noqa: E402
    flat_to_state_dict, load_flat_params)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5
GRAD_TOL = 1e-4
WAIT_K = [2, 3, 5]
META = {"vocab_size": 256, "eos_id": 1, "bos_id": 2, "unk_id": 3}
CRITERION = {"label_smoothing": 0.1}
EXAMPLES = "tests/examples"


def _cfg(flash=False, wait_k=WAIT_K):
    params = {"modality.dim": 32, "modality.timing": "sinusoids",
              "modality.share_embedding_and_softmax_weights": True,
              "encoder.attention_monotonic": True,
              "encoder.enable_flash_attention": flash,
              "dtype": "float32", "wait_k": wait_k}
    for side in ("encoder", "decoder"):
        params.update({f"{side}.num_layers": 2, f"{side}.hidden_size": 32,
                       f"{side}.num_attention_heads": 4,
                       f"{side}.filter_size": 64})
    return {"model.class": "waitk_transformer", "model.params": params}


def _batch(rng, batch=3, src_len=9, trg_len=7):
    src_lengths = np.asarray([src_len, src_len - 4, 3][:batch])
    trg_lengths = np.asarray([trg_len, 2, trg_len - 1][:batch])
    return {
        "src": rng.randint(4, 256, (batch, src_len)).astype(np.int32),
        "src_padding": (np.arange(src_len)[None] >= src_lengths[:, None]
                        ).astype(np.float32),
        "trg_input": rng.randint(4, 256, (batch, trg_len)).astype(np.int32),
        "trg": rng.randint(4, 256, (batch, trg_len)).astype(np.int32),
        "trg_padding": (np.arange(trg_len)[None] >= trg_lengths[:, None]
                        ).astype(np.float32)}


def _with_k(batch, k):
    return dict(batch, waitk_lagging=np.asarray(k, np.int32))


@pytest.fixture(scope="module", params=[False, True],
                ids=["dense", "flash"])
def models(request):
    cfg = _cfg(flash=request.param)
    jm = jax_build(cfg, src_meta=META, trg_meta=META)
    params = jm.init_params(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    tm = neurst_tpu_torch.build_model(cfg, src_meta=META, trg_meta=META,
                                      device="cpu")
    load_flat_params(tm, flat)
    return jm, params, tm


def _rel_close(ours, want, tol=TOL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) \
        else np.asarray(ours)
    want = np.asarray(want)
    assert float(np.abs(ours - want).max()) <= tol * float(
        np.abs(want).max())


@pytest.mark.parametrize("q, m, k", [(1, 1, 1), (5, 9, 3), (7, 4, 2),
                                     (6, 6, 0)])
def test_waitk_bias_matches_jax(q, m, k):
    ours = layer_utils.waitk_cross_attention_bias(q, m, k)
    want = np.asarray(jax_layer_utils.waitk_cross_attention_bias(q, m, k))
    assert ours.shape == (1, 1, q, m)
    np.testing.assert_array_equal(ours.numpy(), want)
    # a 0-d tensor lagging (a batch's field) gives the same bias
    np.testing.assert_array_equal(layer_utils.waitk_cross_attention_bias(
        q, m, torch.tensor(k, dtype=torch.int32)).numpy(), want)


def test_flags_and_laggings_match_jax():
    def flags(cls):
        return {f.name: f.default for f in cls.class_or_method_args()}
    assert flags(WaitkTransformer) == flags(JaxWaitk)
    for wait_k, smallest in ((4, 4), ("[7, 3, 5]", 3), ([9, 2], 2)):
        cfg = _cfg(wait_k=wait_k)
        tm = neurst_tpu_torch.build_model(cfg, src_meta=META, trg_meta=META,
                                          device="meta")
        jm = jax_build(cfg, src_meta=META, trg_meta=META)
        assert tm.wait_k == jm.wait_k == smallest
        assert tm._wait_k_choices == jm._wait_k_choices
    rng = np.random.default_rng(0)
    draws = {tm.sample_lagging(rng) for _ in range(200)}
    assert draws == {9, 2}


@pytest.mark.parametrize("k", [None] + WAIT_K)
def test_teacher_forced_logits_match_jax(models, k):
    """At each k of the list, and with no field (the smallest k)."""
    jm, params, tm = models
    batch = _batch(np.random.RandomState(1))
    if k is not None:
        batch = _with_k(batch, k)
    with torch.no_grad():
        _rel_close(tm(batch), jm.call(params, batch))


def test_lagging_changes_the_logits(models):
    _, _, tm = models
    batch = _batch(np.random.RandomState(2))
    with torch.no_grad():
        a, b = tm(_with_k(batch, 2)), tm(_with_k(batch, 5))
        assert torch.equal(tm(batch), a)
    assert not torch.allclose(a, b)


def test_loss_and_every_gradient_match_jax(models):
    jm, params, tm = models
    batch = _with_k(_batch(np.random.RandomState(3)), 3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jcrit = JaxCriterion(CRITERION)

    def loss_fn(p):
        out, aux = jm.call_train(p, jbatch)
        return jcrit.reduce_loss(jbatch, out) + aux

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    assert not jm.supports_fused_softmax_ce()
    assert not tm.supports_fused_softmax_ce()
    step = make_train_step(tm, neurst_tpu_torch.build_criterion(
        {"criterion.class": "label_smoothed_cross_entropy",
         "criterion.params": CRITERION}), create_optax_chain(
        neurst_tpu_torch.build_optimizer({"optimizer.class": "adam"}), 1e-3))
    ours, _, our_grads = step.compute_grads(dict(tm.named_parameters()),
                                            batch)
    assert abs(float(ours) - float(loss)) <= TOL * abs(float(loss))
    ref = flat_to_state_dict({k: np.asarray(v) for k, v in
                              flatten_params(grads).items()}, tm)
    for name, g in our_grads.items():
        assert float((g - ref[name]).abs().max()) \
            <= GRAD_TOL * float(ref[name].abs().max()) + 1e-9, name


@pytest.mark.parametrize("k", [2, 5])
def test_stepwise_decode_matches_teacher_forcing(models, k):
    """Decode steps at lagging k from the cache give the teacher-forced
    logits at each position, in both packages; the port's steps match
    the JAX module's steps."""
    jm, params, tm = models
    batch = _with_k(_batch(np.random.RandomState(4)), k)
    src = {key: batch[key] for key in ("src", "src_padding")}
    trg_len = batch["trg_input"].shape[1]
    with torch.no_grad():
        forced = tm(batch)
        step_fn, init = tm.prepare_generation(src, trg_len)
        cache = init["decoder_internal_cache"]
        jstep, jinit = jm.prepare_generation(params, src, trg_len)
        jcache = jinit["decoder_internal_cache"]
        module = jm._module
        for t in range(trg_len):
            ids = batch["trg_input"][:, t]
            logits, cache = tm.decode_step(torch.from_numpy(ids), cache, t,
                                           decode_lagging=k)
            _rel_close(logits, forced[:, t].numpy())
            want, jcache = module.apply(
                {"params": params}, jnp.asarray(ids), jcache, t, k,
                method=module.decode_step)
            _rel_close(logits, want)


def test_decode_step_masks_with_the_smallest_k(models):
    jm, params, tm = models
    batch = _batch(np.random.RandomState(5))
    src = {key: batch[key] for key in ("src", "src_padding")}
    with torch.no_grad():
        _, init = tm.prepare_generation(src, 4)
        cache = init["decoder_internal_cache"]
        ids = torch.from_numpy(batch["trg_input"][:, 0])
        default, _ = tm.decode_step(ids, cache, 0)
        smallest, _ = tm.decode_step(ids, cache, 0, decode_lagging=2)
    assert torch.equal(default, smallest)


def test_prefix_encoder_states_equal_full_source_states(models):
    """A monotonic encoder gives a source prefix (padded to a multiple
    of 8, as the streaming agent pads it) the states the full source has
    at those positions, in both packages."""
    jm, params, tm = models
    src = np.random.RandomState(6).randint(4, 256, (1, 13)).astype(np.int32)
    with torch.no_grad():
        full, _ = tm.incremental_encode(src)
    jfull, _ = jm.incremental_encode(params, src)
    _rel_close(full, jfull)
    for n in (1, 5, 12):
        pad_len = -(-n // 8) * 8
        prefix = np.full((1, pad_len), 1, np.int32)
        prefix[0, :n] = src[0, :n]
        padding = (np.arange(pad_len)[None] >= n).astype(np.float32)
        with torch.no_grad():
            ours, _ = tm.incremental_encode(prefix, padding)
        assert float((ours[:, :n] - full[:, :n]).abs().max()) <= 1e-5 * \
            float(full.abs().max())
        want, _ = jm.incremental_encode(params, prefix, padding)
        _rel_close(ours[:, :n], np.asarray(want)[:, :n])


def test_decoder_stays_dense_under_lagging(models, monkeypatch):
    """The decoder turns its flash path off when a lagging is given (the
    wait-k mask is arbitrary), as the JAX decoder does: with the decoder's
    flash switch on, teacher forcing at lagging 3 launches no flash call
    and gives the flash-off decoder's logits."""
    jm, params, tm = models
    cfg = _cfg(flash=tm.encoder.enable_flash_attention)
    cfg["model.params"]["decoder.enable_flash_attention"] = True
    flashy = neurst_tpu_torch.build_model(cfg, src_meta=META, trg_meta=META,
                                          device="cpu")
    flashy.load_state_dict(tm.state_dict())
    assert flashy.decoder.enable_flash_attention
    batch = _with_k(_batch(np.random.RandomState(7)), 3)
    with torch.no_grad():
        enc, padding = flashy.encode(batch)
        calls = []
        original = port_mha.flash_attention
        monkeypatch.setattr(port_mha, "flash_attention",
                            lambda *a, **kw: calls.append(1) or original(
                                *a, **kw))
        out, _ = flashy.decoder(flashy.trg_modality(
            torch.from_numpy(batch["trg_input"])), memory=enc,
            memory_padding=padding, decode_lagging=3)
        assert not calls
        dense, _ = tm.decoder(tm.trg_modality(
            torch.from_numpy(batch["trg_input"])), memory=enc,
            memory_padding=padding, decode_lagging=3)
    assert torch.equal(out, dense)
    jflash = jax_build(cfg, src_meta=META, trg_meta=META)
    with torch.no_grad():
        _rel_close(flashy(batch), jflash.call(params, batch))


def _task_cfg(wait_k):
    pipeline = {"vocab_path": f"{EXAMPLES}/vocab.txt"}
    return {"task.class": "waitk_translation", "task.params": {
        "wait_k": wait_k, "batch_size": 64, "batch_by_tokens": True,
        "max_src_len": 16, "max_trg_len": 16, "shuffle_buffer": 0,
        "src_data_pipeline.class": "TextDataPipeline",
        "src_data_pipeline.params": pipeline,
        "trg_data_pipeline.class": "TextDataPipeline",
        "trg_data_pipeline.params": pipeline}}


def _train_batches(task, seed, n):
    ds = build_dataset({"dataset.class": "parallel_text", "dataset.params": {
        "src_file": f"{EXAMPLES}/train.src",
        "trg_file": f"{EXAMPLES}/train.trg"}})
    it = task.create_batch_iterator(ds, ModeKeys.TRAIN,
                                    dict(task.args, seed=seed))()
    return [next(it) for _ in range(n)]


def test_task_draws_a_0d_lagging_per_train_batch():
    """Each TRAIN batch holds a 0-d int32 ``waitk_lagging`` from the
    choices (the JAX task's field has the same type); the draws repeat
    with the seed and change with it; INFER batches hold none; the model
    the task builds is ``waitk_transformer`` with the task's laggings."""
    cfg = _task_cfg("[3, 5, 7, 9]")
    task = build_task(cfg)
    jtask = jax_build_task(cfg)
    assert task.get_config()["wait_k"] == jtask.get_config()["wait_k"] \
        == [3, 5, 7, 9]
    batches = _train_batches(task, 0, 12)
    draws = [b["waitk_lagging"] for b in batches]
    for d in draws:
        assert isinstance(d, np.ndarray) and d.shape == () \
            and d.dtype == np.int32 and int(d) in (3, 5, 7, 9)
    assert len({int(d) for d in draws}) > 1
    assert [int(d) for d in draws] == [
        int(b["waitk_lagging"]) for b in _train_batches(build_task(cfg), 0,
                                                        12)]
    assert [int(d) for d in draws] != [
        int(b["waitk_lagging"]) for b in _train_batches(build_task(cfg), 1,
                                                        12)]
    raw = {"feature": batches[0]["src"], "label": batches[0]["trg"],
           "sample_mask": batches[0]["sample_mask"]}
    want = jtask.example_to_input(raw, JaxModeKeys.TRAIN)["waitk_lagging"]
    assert want.shape == () and want.dtype == np.int32
    assert "waitk_lagging" not in task.example_to_input(
        {"feature": raw["feature"]}, ModeKeys.INFER)
    model = task.build_model({"model.params": _cfg()["model.params"]},
                             device="meta")
    assert isinstance(model, WaitkTransformer) and model.wait_k == 2


def test_lagging_field_reaches_the_decoder_through_update_cycle(models):
    """A TRAIN batch's 0-d field broadcasts over ``update_cycle``
    micro-batches (``split_microbatches``) and each micro-batch's forward
    masks with it: the update_cycle-2 loss and gradients equal the
    whole batch's at that k, which differ from another k's, and the loss
    matches the JAX model's at that k."""
    jm, params, tm = models
    batch = _with_k(_batch(np.random.RandomState(8), batch=2), 5)
    batch["trg_padding"][1] = 0.0
    batch["sample_mask"] = np.ones(2, np.float32)
    split = split_microbatches(batch, 2)
    assert split["waitk_lagging"].shape == (2,)
    assert split["waitk_lagging"][1].shape == ()
    crit = neurst_tpu_torch.build_criterion(
        {"criterion.class": "label_smoothed_cross_entropy",
         "criterion.params": CRITERION})
    tx = create_optax_chain(neurst_tpu_torch.build_optimizer(
        {"optimizer.class": "adam"}), 1e-3)
    params_t = dict(tm.named_parameters())
    whole = make_train_step(tm, crit, tx).compute_grads(params_t, batch)
    cycled = make_train_step(tm, crit, tx, update_cycle=2).compute_grads(
        params_t, {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in split.items()})
    other = make_train_step(tm, crit, tx).compute_grads(
        params_t, dict(batch, waitk_lagging=np.asarray(2, np.int32)))
    assert abs(float(cycled[0]) - float(whole[0])) <= 1e-6 * float(whole[0])
    assert abs(float(other[0]) - float(whole[0])) > 1e-4
    for name, g in whole[2].items():
        assert float((cycled[2][name] - g).abs().max()) \
            <= 1e-5 * float(g.abs().max()) + 1e-9, name
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out, _ = jm.call_train(params, jbatch)
    want = JaxCriterion(CRITERION).reduce_loss(jbatch, out)
    assert abs(float(cycled[0]) - float(want)) <= TOL * float(want)


def test_r10_the_task_laggings_do_not_reach_the_model():
    """ROADMAP R10, kept in both packages: parsing the recipe fills the
    model's ``wait_k`` flag with its default (3) before the task's
    ``build_model`` could pass the task's list on, so the model decodes
    at 3 whatever the task draws from."""
    from neurst_tpu.cli.run_exp import parse_and_merge as jax_parse
    from neurst_tpu_torch.cli.run_exp import parse_and_merge
    recipe = "examples/simultaneous_translation/waitk_training_args.yml"
    argv = ["--config_paths", recipe, "--task.params", "{wait_k: [5, 7]}"]
    for parsed in (parse_and_merge(argv), jax_parse(argv)):
        assert parsed["task.params"]["wait_k"] == [5, 7]
        assert parsed["model.params"]["wait_k"] == 3
