"""The parts of the port's training entry against the JAX package's, on
the CPU: the TRAIN buckets (boundaries, batch sizes, transcript caps),
SpecAugment, the shuffle and prefetch iterators, the TRAIN batches of an
epoch and their micro-batch split, the optimizers, the freeze and rate
schedule wrappers and the learning-rate schedules (against optax and the
JAX package's), the validators' metrics, savers and early stop,
``avg_checkpoint``, and the plain flash attention on a length-0 row
against the Pallas kernels in interpret mode.
"""

import itertools
import logging
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import neurst_tpu_torch  # noqa: E402
from neurst_tpu.data import dataset_utils as jax_du  # noqa: E402
from neurst_tpu.data.recordio import RecordWriter, build_example  # noqa: E402
from neurst_tpu.utils.audio_lib import SpecAugment as JaxSpecAugment  # noqa: E402
from neurst_tpu_torch.data import dataset_utils as port_du  # noqa: E402
from neurst_tpu_torch.utils.audio_lib import SpecAugment  # noqa: E402
from neurst_tpu_torch.utils.compat import ModeKeys  # noqa: E402

FEATURE_DIM = 16
WORDS = ["the", "cat", "sat", "on", "mat", "dog", "ran", "a", "big", "red",
         "house", "we", "saw", "it"]


# ----------------------------- buckets ------------------------------ #

class _Status:
    status = {"audio": "projected", "transcript": "projected"}


def _jax_shapes(args, caplog, vocab):
    from neurst_tpu.tasks.speech2text import SpeechToText as JaxTask
    task = JaxTask({"transcript_data_pipeline.class": "TextDataPipeline",
                    "transcript_data_pipeline.params": {"vocab_path": vocab}})
    caplog.clear()
    with caplog.at_level(logging.INFO):
        task.create_batch_iterator(_Status(), ModeKeys.TRAIN, args)
    return [(int(m.group(1)), int(m.group(2)),
             [int(x) for x in m.group(3).strip("[]").split(",")])
            for m in (re.match(r"\s+- batch=(\d+) frames<=(\d+) "
                               r"transcript<=(\[.*\])", r.getMessage())
                      for r in caplog.records) if m]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(WORDS) + "\n")
    return str(path)


@pytest.mark.parametrize(
    "max_src,min_bucket,budget,ratio,no_efficiency,update_cycle",
    list(itertools.product((3000, 1000), (128, 64), (120000, 20000),
                           (12.0, None), (None, True), (1, 2))))
def test_bucket_shapes_match_jax(caplog, vocab, max_src, min_bucket, budget,
                                 ratio, no_efficiency, update_cycle):
    from neurst_tpu.tasks.speech2text import \
        create_audio_bucket_boundaries as jax_bounds
    from neurst_tpu_torch.tasks.speech2text import (
        create_audio_bucket_boundaries, train_bucket_shapes)
    args = {"batch_size": budget, "max_src_len": max_src,
            "max_trg_len": 150, "min_src_bucket_boundary": min_bucket,
            "experimental_frame_transcript_ratio": ratio,
            "disable_batch_efficiency": no_efficiency,
            "batch_size_multiple": max(8, update_cycle)}
    assert create_audio_bucket_boundaries(max_src, min_bucket) \
        == jax_bounds(max_src, min_bucket)
    _, ours = train_bucket_shapes(args)
    assert [tuple(s) for s in ours] == [tuple(s) for s in
                                        _jax_shapes(args, caplog, vocab)]
    assert all(bs % max(8, update_cycle) == 0 for bs, _, _ in ours)


def test_bucket_budget_must_exceed_max_src_len():
    from neurst_tpu_torch.tasks.speech2text import train_bucket_shapes
    with pytest.raises(ValueError, match="must exceed"):
        train_bucket_shapes({"batch_size": 3000, "max_src_len": 3000})


# ---------------------------- SpecAugment ---------------------------- #

@pytest.mark.parametrize("setting", [
    "LB", "LD", "SM", "SS",
    {"freq_mask_n": 3, "freq_mask_f": 5, "time_mask_n": 2,
     "time_mask_t": 9, "time_mask_p": 0.5},
    "{freq_mask_n: 2, freq_mask_f: 4, time_mask_n: 3, time_mask_t: 20, "
    "mask_value: 0.0}"], ids=["LB", "LD", "SM", "SS", "dict", "yaml"])
def test_specaugment_is_bitwise_jax(setting):
    spec = np.random.RandomState(0).randn(300, 80).astype(np.float32)
    ours, ref = SpecAugment.build(setting), JaxSpecAugment.build(setting)
    for seed in range(3):
        got = ours.apply_numpy(spec, np.random.RandomState(seed))
        want = ref.apply_numpy(spec, np.random.RandomState(seed))
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, spec)
    np.random.seed(5)
    got = ours(spec[:40])
    np.random.seed(5)
    np.testing.assert_array_equal(got, ref(spec[:40]))
    assert SpecAugment.build(None) is None


# ----------------------------- iterators ----------------------------- #

@pytest.mark.parametrize("buffer,seed", [(1, 0), (7, 3), (64, 11),
                                         (500, 2)])
def test_shuffle_iterator_order_matches_jax(buffer, seed):
    ours = list(port_du.shuffle_iterator(iter(range(200)), buffer, seed))
    assert ours == list(jax_du.shuffle_iterator(iter(range(200)), buffer,
                                                seed))
    assert sorted(ours) == list(range(200))


def test_prefetch_iterator_raises_upstream_errors_after_the_items():
    def upstream():
        yield from range(5)
        raise ValueError("bad record")

    got = []
    with pytest.raises(ValueError, match="bad record"):
        for x in port_du.prefetch_iterator(upstream(), buffer_size=2):
            got.append(x)
    assert got == list(range(5))


def test_prefetch_iterator_stops_when_abandoned():
    before = threading.active_count()
    it = port_du.prefetch_iterator(itertools.count(), buffer_size=4)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    assert threading.active_count() == before + 1
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before


# --------------------------- TRAIN batches --------------------------- #

def _train_setup(tmp_path, vocab, n=40):
    rng = np.random.RandomState(5)
    records = str(tmp_path / "train.tfrecords")
    with RecordWriter(records) as w:
        for _ in range(n):
            audio = rng.randn(int(rng.randint(10, 90)), FEATURE_DIM)
            text = " ".join(rng.choice(WORDS, int(rng.randint(1, 12))))
            w.write(build_example({"audio": audio.astype(np.float32)
                                   .reshape(-1), "translation": text}))
    task_params = {"audio_feature_dim": FEATURE_DIM, "batch_size": 1200,
                   "max_src_len": 80, "max_trg_len": 10,
                   "truncate_src": True, "truncate_trg": True,
                   "min_src_bucket_boundary": 24,
                   "experimental_frame_transcript_ratio": 6.0,
                   "specaug": "SM", "shuffle_buffer": 0,
                   "transcript_data_pipeline.class": "TextDataPipeline",
                   "transcript_data_pipeline.params": {
                       "vocab_path": vocab, "language": "en"}}
    ds = {"dataset.class": "audio_tfrecord",
          "dataset.params": {"data_path": records,
                             "transcript_key": "translation"}}
    return task_params, ds


@pytest.mark.parametrize("update_cycle", [1, 2])
def test_train_batches_match_jax(tmp_path, vocab, update_cycle):
    from neurst_tpu.data.datasets.dataset import build_dataset as jax_ds
    from neurst_tpu.exps.trainer import _split_microbatches
    from neurst_tpu.tasks.task import build_task as jax_task
    from neurst_tpu_torch.data.datasets.dataset import build_dataset
    from neurst_tpu_torch.exps.trainer import split_microbatches
    from neurst_tpu_torch.tasks.task import build_task
    task_params, ds = _train_setup(tmp_path, vocab)
    args = {"batch_size_multiple": max(8, update_cycle)}
    batches = {}
    for side, build_t, build_d in (("jax", jax_task, jax_ds),
                                   ("port", build_task, build_dataset)):
        task = build_t({"task.class": "speech2text",
                        "task.params": task_params})
        it = task.create_batch_iterator(build_d(ds), ModeKeys.TRAIN, args)
        np.random.seed(9)
        batches[side] = list(it())
    assert len(batches["port"]) == len(batches["jax"]) > 4
    padded = 0
    for ours, ref in zip(batches["port"], batches["jax"]):
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        assert ours["src"].dtype == np.float32
        padded += int((ours["src_length"] == 0).any())
        if update_cycle > 1:
            split, ref_split = (split_microbatches(ours, update_cycle),
                                _split_microbatches(ref, update_cycle))
            assert sorted(split) == sorted(ref_split)
            for k in ref_split:
                np.testing.assert_array_equal(split[k], ref_split[k])
    assert padded >= 2
    assert max(b["trg"].shape[1] for b in batches["port"]) <= 16


# ------------------- optimizers, wrappers, schedules ----------------- #

def _params(rng):
    return {"enc": {"w": rng.randn(5, 3).astype(np.float32),
                    "b": rng.randn(3).astype(np.float32)},
            "dec": {"w": rng.randn(4, 4).astype(np.float32)}}


def _flat(tree):
    return {f"{a}.{b}": v for a, sub in tree.items() for b, v in sub.items()}


def _run_both(jax_tx, port_tx, steps=6, seed=0):
    rng = np.random.RandomState(seed)
    params = _params(rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    pparams = {k: torch.from_numpy(v.copy())
               for k, v in _flat(params).items()}
    jstate, pstate = jax_tx.init(jparams), port_tx.init(pparams)
    for _ in range(steps):
        grads = jax.tree_util.tree_map(
            lambda x: (3.0 * rng.randn(*x.shape)).astype(np.float32), params)
        jup, jstate = jax_tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, jup)
        pup, pstate = port_tx.update(
            {k: torch.from_numpy(v) for k, v in _flat(grads).items()},
            pstate, pparams)
        for k, u in pup.items():
            pparams[k] = pparams[k] + u
    for k, v in _flat(jax.tree_util.tree_map(np.asarray, jparams)).items():
        np.testing.assert_allclose(pparams[k].numpy(), v, rtol=2e-5,
                                   atol=2e-6, err_msg=k)
    return pparams


OPTIMIZERS = [("adam", {"beta_1": 0.9, "beta_2": 0.98, "epsilon": 1e-9}),
              ("adam", {"weight_decay": 0.01}), ("adam", {"amsgrad": True}),
              ("adagrad", {}), ("adagrad", {"initial_accumulator_value": 0.,
                                            "epsilon": 1e-3}),
              ("adadelta", {}), ("adadelta", {"rho": 0.9}),
              ("sgd", {}), ("sgd", {"momentum": 0.9}),
              ("sgd", {"momentum": 0.9, "nesterov": True})]


@pytest.mark.parametrize("clip", [None, "value", "norm"])
@pytest.mark.parametrize("name,params", OPTIMIZERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OPTIMIZERS)])
def test_optimizer_chains_match_optax(name, params, clip):
    from neurst_tpu.optimizers import build_optimizer as jax_opt
    from neurst_tpu.optimizers import create_optax_chain as jax_chain
    from neurst_tpu_torch.optimizers.optimizers import (build_optimizer,
                                                         create_optax_chain)
    cfg = {"optimizer.class": name, "optimizer.params": params}
    kw = {"clip_value": 0.5} if clip == "value" else (
        {"clip_norm": 1.0} if clip == "norm" else {})

    def lr(count):
        return 0.05 / (1.0 + count)
    _run_both(jax_chain(jax_opt(cfg), lr, **kw),
              create_optax_chain(build_optimizer(cfg), lr, **kw))


def test_freeze_matches_optax_multi_transform():
    """The JAX trainer's freeze (``multi_transform`` with ``set_to_zero``
    for the matched names): the clipping norm sees only the trained
    ones."""
    from neurst_tpu.optimizers import build_optimizer as jax_opt
    from neurst_tpu.optimizers import create_optax_chain as jax_chain
    from neurst_tpu_torch.optimizers.optimizers import (build_optimizer,
                                                         create_optax_chain,
                                                         freeze)
    cfg = {"optimizer.class": "adam", "optimizer.params": {}}
    labels = {"enc": {"w": "frozen", "b": "frozen"}, "dec": {"w": "train"}}
    jtx = optax.multi_transform(
        {"train": jax_chain(jax_opt(cfg), 0.01, clip_norm=0.5),
         "frozen": optax.set_to_zero()}, labels)
    ptx = freeze(create_optax_chain(build_optimizer(cfg), 0.01,
                                    clip_norm=0.5),
                 lambda n: n.startswith("enc"))
    out = _run_both(jtx, ptx)
    ref = _flat(_params(np.random.RandomState(0)))
    for k in ("enc.w", "enc.b"):
        np.testing.assert_array_equal(out[k].numpy(), ref[k])


def test_rate_schedule_matches_jax():
    from neurst_tpu.optimizers import build_optimizer as jax_opt
    from neurst_tpu.optimizers import create_optax_chain as jax_chain
    from neurst_tpu.optimizers.rate_schedule_optimizer import \
        rate_scheduled_updates as jax_rate
    from neurst_tpu_torch.optimizers.optimizers import (build_optimizer,
                                                         create_optax_chain)
    from neurst_tpu_torch.optimizers.rate_schedule_optimizer import \
        rate_scheduled_updates
    cfg = {"optimizer.class": "sgd", "optimizer.params": {}}
    _run_both(jax_rate(jax_chain(jax_opt(cfg), 0.1), "enc", freeze_until=2,
                       ramp_steps=3),
              rate_scheduled_updates(
                  create_optax_chain(build_optimizer(cfg), 0.1), "enc",
                  freeze_until=2, ramp_steps=3,
                  name_of=lambda n: n.replace(".", "/")), steps=7)


SCHEDULES = [
    ("noam", {"dmodel": 256, "warmup_steps": 5, "initial_factor": 3.5,
              "end_factor": 1.5, "start_decay_at": 8, "decay_steps": 6}),
    ("noam", {"dmodel": 512, "warmup_steps": 4000}),
    ("inverse_sqrt", {"warmup_steps": 6, "peak_lr": 1e-3, "init_lr": 1e-5}),
    ("piecewise", {"boundaries": [3, 9], "values": [1e-3, 5e-4, 1e-4]}),
    ("constant", {"learning_rate": 7e-4})]


@pytest.mark.parametrize("initial_step", [0, 7])
@pytest.mark.parametrize("name,params", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULES)])
def test_schedules_match_jax(name, params, initial_step):
    from neurst_tpu.optimizers import build_lr_schedule as jax_build
    from neurst_tpu.utils import compat as jax_compat
    from neurst_tpu_torch.optimizers.schedules.lr_schedules import \
        build_lr_schedule
    from neurst_tpu_torch.utils import compat
    cfg = {"lr_schedule.class": name, "lr_schedule.params": params}
    jax_compat.register_initial_step(initial_step)
    compat.register_initial_step(initial_step)
    try:
        ref, ours = jax_build(cfg), build_lr_schedule(cfg)
    finally:
        jax_compat.register_initial_step(0)
        compat.register_initial_step(0)
    for step in range(20):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6)


# ----------------------------- validators ---------------------------- #

@pytest.fixture(scope="module")
def dev(tmp_path_factory, vocab):
    """A toy float32 model with the same weights in both packages, and a
    dev set of 5 utterances with whole-number features (the JAX EVAL and
    INFER batchers read features as int32: ROADMAP R5)."""
    from neurst_tpu.models.speech_transformer import SpeechTransformer
    from neurst_tpu.tasks.task import build_task as jax_task
    from neurst_tpu.utils.checkpoints import flatten_params
    from neurst_tpu_torch.tasks.task import build_task
    from neurst_tpu_torch.utils.param_bridge import load_flat_params
    root = tmp_path_factory.mktemp("dev")
    rng = np.random.RandomState(2)
    records = str(root / "dev.tfrecords")
    with RecordWriter(records) as w:
        for _ in range(5):
            audio = np.round(3 * rng.randn(int(rng.randint(20, 40)),
                                           FEATURE_DIM))
            w.write(build_example({
                "audio": audio.astype(np.float32).reshape(-1),
                "translation": " ".join(rng.choice(WORDS, 4))}))
    task_cfg = {"task.class": "speech2text", "task.params": {
        "audio_feature_dim": FEATURE_DIM,
        "transcript_data_pipeline.class": "TextDataPipeline",
        "transcript_data_pipeline.params": {"vocab_path": vocab}}}
    hp = SpeechTransformer.build_model_args_by_name("speech_transformer_toy")
    model_cfg = {"model.class": "SpeechTransformer",
                 "model.params": dict(hp["model.params"], dtype="float32")}
    jtask, ptask = jax_task(task_cfg), build_task(task_cfg)
    jmodel = jtask.build_model(model_cfg)
    params = jax.tree_util.tree_map(
        lambda x: 3.0 * np.asarray(x), jmodel.init_params(
            jax.random.PRNGKey(4)))
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    pmodel = ptask.build_model(model_cfg, device="cpu")
    load_flat_params(pmodel, flat)
    args = {"eval_dataset.class": "audio_tfrecord",
            "eval_dataset.params": {"data_path": records,
                                    "transcript_key": "translation"},
            "eval_batch_size": 2, "eval_steps": 1,
            "eval_search_method.params": {"beam_size": 2,
                                          "maximum_decode_length": 6},
            "eval_metric.class": "bleu", "eval_keep_best_checkpoints": 1}
    return {"root": root, "jax": (jtask, jmodel, params),
            "port": (ptask, pmodel, flat), "args": args}


@pytest.mark.parametrize("name", ["criterion_validator",
                                  "seq_generation_validator"])
def test_validator_metric_and_saved_best_match_jax(dev, name):
    from neurst_tpu.training.validator import build_validator as jax_build
    from neurst_tpu_torch.training.validator import \
        build_validator as port_build
    cfg = {"validator.class": name, "validator.params": dev["args"]}
    out = {}
    for side, build in (("jax", jax_build), ("port", port_build)):
        task, model, params = dev[side]
        model_dir = str(dev["root"] / f"{name}_{side}")
        validator = build(cfg).build(task, model, model_dir)
        assert validator.should_eval(3)
        assert validator.validate(3, params) is False
        out[side] = (validator._recorder.best, model_dir)
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=1e-5)
    if name == "seq_generation_validator":
        from neurst_tpu.utils.checkpoints import restore_checkpoint_params
        for sub in ("best", "best_avg"):
            ref = restore_checkpoint_params(
                os.path.join(out["jax"][1], sub, "ckpt-3.npz"))
            ours = restore_checkpoint_params(
                os.path.join(out["port"][1], sub, "ckpt-3.npz"))
            assert sorted(ours) == sorted(ref)
            for k in ref:
                np.testing.assert_array_equal(ours[k], ref[k])


@pytest.mark.parametrize("greater", [True, False])
def test_recorder_savers_and_early_stop_match_jax(tmp_path, greater):
    """A sequence of metric values through both packages' recorders with
    keep-best 2 and averaged 2: the same stop decisions, the same kept
    checkpoints and the same averages."""
    from neurst_tpu.metrics.metric import MetricWrapper as JaxWrapper
    from neurst_tpu.training.validator import \
        TrainingStatusRecorder as JaxRecorder
    from neurst_tpu.utils.checkpoints import restore_checkpoint_params
    from neurst_tpu_torch.metrics.metric import MetricWrapper
    from neurst_tpu_torch.training.validator import TrainingStatusRecorder
    rng = np.random.RandomState(1)
    values = [3.0, 2.0, 2.5, 1.0, 4.0, 0.5, 0.7, 0.6]
    recorders = {
        "jax": JaxRecorder(JaxWrapper("NLL", greater), str(tmp_path / "j"),
                           keep_best=2, keep_best_avg=2, estop_patience=2),
        "port": TrainingStatusRecorder(MetricWrapper("NLL", greater),
                                       str(tmp_path / "p"), keep_best=2,
                                       keep_best_avg=2, estop_patience=2)}
    stops = {"jax": [], "port": []}
    for step, value in enumerate(values, 1):
        params = {"a/kernel": rng.randn(3, 2).astype(np.float32),
                  "b/bias": rng.randn(2).astype(np.float32)}
        for side, recorder in recorders.items():
            stops[side].append(recorder.record(step, value, dict(params)))
    assert stops["port"] == stops["jax"] and any(stops["port"])
    for sub in ("best", "best_avg"):
        names = sorted(os.listdir(tmp_path / "j" / sub))
        assert sorted(os.listdir(tmp_path / "p" / sub)) == names
        for f in names:
            if f.endswith(".npz"):
                ref = restore_checkpoint_params(str(tmp_path / "j" / sub / f))
                ours = restore_checkpoint_params(str(tmp_path / "p" / sub / f))
                for k in ref:
                    np.testing.assert_allclose(ours[k], ref[k], rtol=0,
                                               atol=1e-7)


# --------------------------- avg_checkpoint -------------------------- #

def test_avg_checkpoint_matches_jax(tmp_path):
    from neurst_tpu.cli import avg_checkpoint as jax_avg
    from neurst_tpu.utils.checkpoints import (restore_checkpoint_params,
                                              save_checkpoint)
    from neurst_tpu_torch.cli import avg_checkpoint
    rng = np.random.RandomState(3)
    model_dir = str(tmp_path / "model")
    for step in (2, 4, 6, 8):
        save_checkpoint(model_dir, step, {
            "enc": {"kernel": rng.randn(7, 5).astype(np.float32)},
            "bias": rng.randn(5).astype(np.float32)})
    with open(os.path.join(model_dir, "model_configs.yml"), "w") as f:
        f.write("model.class: SpeechTransformer\n")
    for name, main in (("jax", jax_avg.main), ("port", avg_checkpoint.main)):
        main(["--model_dir", model_dir, "--last_n", "3", "--output_dir",
              str(tmp_path / name)])
    ref = restore_checkpoint_params(str(tmp_path / "jax" / "ckpt-8.npz"))
    ours = restore_checkpoint_params(str(tmp_path / "port" / "ckpt-8.npz"))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == np.float32
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-7)
    assert os.path.exists(tmp_path / "port" / "model_configs.yml")


# ---------------------- flash on a length-0 row ---------------------- #

@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_plain_flash_on_a_length0_row(dropout):
    """The plain forward and backward at an odd bucket length (T 46) with
    a length-0 row: finite, that row's o / dq / dk / dv exactly 0, and
    the other rows within 1e-5 of the Pallas kernels in interpret mode
    (dropout 0; the JAX kernels draw other masks)."""
    from neurst_tpu.ops.flash_attention import \
        flash_attention as jax_flash
    from neurst_tpu_torch.ops import flash_attention as port
    from neurst_tpu_torch.utils.rng import DropoutKey
    rng = np.random.RandomState(6)
    b, t, n, h = 3, 46, 2, 64
    q, k, v, do = (rng.randn(b, t, n, h).astype(np.float32)
                   for _ in range(4))
    lens = np.asarray([46, 17, 0], np.int32)
    key = DropoutKey(5, 9, stream=1 << 16) if dropout else None
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = port.flash_attention(*leaves, torch.from_numpy(lens),
                               dropout_rate=dropout, dropout_key=key)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for x in (out,) + grads:
        assert bool(torch.isfinite(x).all())
        assert bool((x[-1] == 0).all())
    if dropout:
        return
    ref, vjp = jax.vjp(lambda *a: jax_flash(
        *a, lengths=jnp.asarray(lens), interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = vjp(jnp.asarray(do))
    for ours, want in zip((out,) + grads, (ref,) + tuple(ref_grads)):
        want = np.asarray(want)
        np.testing.assert_allclose(ours.detach().numpy()[:2], want[:2],
                                   rtol=1e-4, atol=1e-5)
