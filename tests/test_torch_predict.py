"""The port's ``predict`` entry against the JAX package's, end to end on
the CPU.

One ``speech_transformer_toy`` model dir, written the way the JAX trainer
writes it (``save_checkpoint`` of ``init_params``-shaped weights and
``ModelConfigs.dump`` of the task's and model's configs; float32, encoder
flash attention on, so the JAX side runs the Pallas kernel in interpret
mode), one ``audio_tfrecord`` file of 7 utterances (16-dim features,
at most 64 frames, so every batch of 4 pads to one shape and the last
batch carries a row of length 0), a word vocabulary with BPE codes and the
Moses tokenizer, and a config shaped like the MuST-C recipe's
``st_prediction_args.yml``.  ``neurst_tpu.cli.run_exp.cli_main`` and the
port's (``--device cpu``) give the same hypothesis strings, the same
output file, and the same sample count, BLEU and WER within 1e-6.

The features are whole numbers: the JAX package's INFER batcher casts
audio to int32 (ROADMAP R5), the port keeps float32, and with whole
numbers the two read the same features.  A separate case decodes
fractional features with the JAX model and ``BeamSearch`` on the batches
the port built and holds the port CLI's hypotheses against them.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from neurst_tpu.cli import run_exp as jax_run_exp  # noqa: E402
from neurst_tpu.data.recordio import RecordWriter, build_example  # noqa: E402
from neurst_tpu.tasks.task import build_task as jax_build_task  # noqa: E402
from neurst_tpu.utils.checkpoints import (flatten_params,  # noqa: E402
                                          save_checkpoint)
from neurst_tpu.utils.configurable import ModelConfigs  # noqa: E402
from neurst_tpu_torch.cli import run_exp as port_run_exp  # noqa: E402

FEATURE_DIM = 16
WORDS = ["the", "cat", "sat", "on", "mat", "dog", "ran", "a", "big", "red",
         "house", "we", "saw", "it", "."]
# subword units of WORDS under CODES, and the words themselves
SUBWORDS = ["c@@", "at", "d@@", "og", "ma@@", "t", "h@@", "ouse", "s@@",
            "a", "r@@", "an", "ed", "b@@", "ig", "o@@", "n"]
CODES = ["#version: 0.2", "a t</w>", "o g</w>", "o u", "ou s", "ous e</w>",
         "m a", "a n</w>", "e d</w>", "i g</w>", "t h", "th e</w>",
         "s a", "sa t</w>", "o n</w>", "w e</w>", "s a", "i t</w>"]
PREDICT = {
    "entry.class": "predict",
    "entry.params": {
        "search_method.class": "beam_search",
        "search_method.params": {"beam_size": 2, "length_penalty": -1,
                                 "maximum_decode_length": 8},
        "metric.class": "bleu"},
    "dataset.class": "audio_tfrecord",
    "dataset.params": {"feature_key": "audio",
                       "transcript_key": "translation"},
    "batch_size": 4}


def _port_hypotheses(model_dir, pipeline_params, utterances):
    """The port's beam search (the test's search settings) on each
    utterance alone, decoded to text: references that share n-grams with
    the hypotheses, so BLEU is not 0."""
    import neurst_tpu_torch
    from neurst_tpu_torch.data.data_pipelines import build_data_pipeline
    from neurst_tpu_torch.utils.configurable import ModelConfigs
    from neurst_tpu_torch.utils.checkpoints import (latest_checkpoint,
                                                    restore_checkpoint_params)
    from neurst_tpu_torch.utils.param_policy import restore_inference_params
    cfg = ModelConfigs.load(model_dir)
    pipeline = build_data_pipeline({"data_pipeline.class": "TextDataPipeline",
                                    "data_pipeline.params": pipeline_params})
    model = neurst_tpu_torch.build_model(
        cfg, src_meta={"audio_feature_dim": FEATURE_DIM},
        trg_meta=pipeline.meta, device="cpu")
    restore_inference_params(model, restore_checkpoint_params(
        latest_checkpoint(model_dir)))
    search = neurst_tpu_torch.build_search_layer({
        "search_method.class": "beam_search",
        "search_method.params": PREDICT["entry.params"][
            "search_method.params"]})
    search.set_model(model)
    texts = []
    for audio in utterances:
        hyp, _ = search({"src": audio[None, :, :, None],
                         "src_length": np.asarray([len(audio)], np.int32)})
        texts.append(pipeline.decode(hyp[0].tolist()))
    return texts


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("predict"))
    rng = np.random.RandomState(7)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(WORDS + SUBWORDS) + "\n")
    codes = os.path.join(root, "codes.bpe")
    with open(codes, "w") as f:
        f.write("\n".join(CODES) + "\n")
    pipeline_params = {"vocab_path": vocab, "language": "en",
                       "tokenizer": "moses", "subtokenizer": "bpe",
                       "subtokenizer_codes": codes}

    task = jax_build_task({
        "task.class": "SpeechToText",
        "task.params": {
            "audio_feature_dim": FEATURE_DIM,
            "transcript_data_pipeline.class": "TextDataPipeline",
            "transcript_data_pipeline.params": pipeline_params}})
    from neurst_tpu.models.speech_transformer import SpeechTransformer
    cfg = SpeechTransformer.build_model_args_by_name("speech_transformer_toy")
    params = dict(cfg["model.params"], dtype="float32")
    params["encoder.enable_flash_attention"] = True
    model = task.build_model({"model.class": "SpeechTransformer",
                              "model.params": params})
    # the JAX initializers' weights, tripled so that the hypotheses depend
    # on the audio, and an EOS bias so that most end inside the window
    weights = jax.tree_util.tree_map(
        lambda x: 3.0 * np.array(x), model.init_params(jax.random.PRNGKey(0)))
    eos = task.trg_pipeline.meta["eos_id"]
    weights["target_symbol_modality"]["bias"][eos] += 20.0
    model_dir = os.path.join(root, "model")
    save_checkpoint(model_dir, 1, weights)
    ModelConfigs.dump(task.model_configs(model), model_dir)

    utterances = [np.round(3.0 * rng.randn(int(rng.randint(20, 65)),
                                           FEATURE_DIM)).astype(np.float32)
                  for _ in range(7)]
    references = _port_hypotheses(model_dir, pipeline_params, utterances)
    for i in (1, 4):
        references[i] = " ".join(rng.choice(WORDS, int(rng.randint(2, 9))))
    records = os.path.join(root, "test.tfrecords")
    with RecordWriter(records) as w:
        for audio, ref in zip(utterances, references):
            w.write(build_example({"audio": audio.reshape(-1),
                                   "translation": ref}))

    config = json.loads(json.dumps(PREDICT))
    config["dataset.params"]["data_path"] = records
    cfg_path = os.path.join(root, "predict.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    return root, model_dir, cfg_path, records, flatten_params(weights)


def _run_both(workdir, metric):
    root, model_dir, cfg_path, _, _ = workdir
    out = {}
    for name, main, extra in (("jax", jax_run_exp.cli_main, []),
                              ("port", port_run_exp.cli_main,
                               ["--device", "cpu"])):
        hypo = os.path.join(root, f"hypo.{name}.{metric}.txt")
        result = main(["--config_paths", cfg_path, "--model_dir", model_dir,
                       "--output_file", hypo, "--metric.class", metric]
                      + extra)
        with open(hypo) as f:
            out[name] = (result, f.read())
    return out


@pytest.mark.parametrize("metric", ["bleu", "wer"])
def test_cli_predict_matches_jax(workdir, metric):
    out = _run_both(workdir, metric)
    (jres, jfile), (pres, pfile) = out["jax"], out["port"]
    assert pres["samples"] == jres["samples"] == 7
    assert pres["hypotheses"] == jres["hypotheses"]
    assert pfile == jfile and len(pfile.splitlines()) == 7
    keys = ["BLEU", "UncasedBLEU"] if metric == "bleu" else ["WER"]
    for key in keys:
        assert abs(pres[key] - jres[key]) <= 1e-6, (key, pres[key],
                                                     jres[key])
    # words of several kinds, and (BLEU) a score that is not 0
    assert len(set(pres["hypotheses"])) > 1
    if metric == "bleu":
        assert pres["BLEU"] > 0.0
    np.testing.assert_allclose(pres["scores"], jres["scores"], atol=1e-4)
    assert set(pres["timing"]) == {"read_batch_s", "decode_s",
                                   "detok_metric_s", "first_batch_s"}


def test_cli_multi_set_predict_matches_jax(workdir):
    """The recipes' multi-set prediction (``MultipleDataset`` of ``dev``
    and ``tst-COMMON``, as in must-c/st_prediction_args.yml): per-dataset
    hypotheses, output files ``<file>.<name>`` and metrics equal to the
    JAX CLI's (within 1e-6), and the weighted mixture within 1e-5."""
    root, model_dir, cfg_path, records, _ = workdir
    sets = {"multiple_datasets": {
        name: {"dataset.class": "audio_tfrecord",
               "dataset.params": {"data_path": records,
                                  "feature_key": "audio",
                                  "transcript_key": "translation"}}
        for name in ("dev", "tst-COMMON")},
        "sample_weights": {"dev": 1.0, "tst-COMMON": 3.0}}
    out = {}
    for name, main, extra in (("jax", jax_run_exp.cli_main, []),
                              ("port", port_run_exp.cli_main,
                               ["--device", "cpu"])):
        hypo = os.path.join(root, f"multi.{name}.txt")
        result = main(["--config_paths", cfg_path, "--model_dir", model_dir,
                       "--dataset.class", "MultipleDataset",
                       "--dataset.params", json.dumps(sets),
                       "--output_file", hypo, "--save_metric",
                       hypo + ".json"] + extra)
        files = {}
        for ds in ("dev", "tst-COMMON"):
            with open(f"{hypo}.{ds}") as f:
                files[ds] = f.read()
        with open(hypo + ".json") as f:
            saved = json.load(f)
        out[name] = (result, files, saved)
    (jres, jfiles, jsaved), (pres, pfiles, psaved) = out["jax"], out["port"]
    assert sorted(pres["datasets"]) == sorted(jres["datasets"]) == [
        "dev", "tst-COMMON"]
    assert pfiles == jfiles
    for ds in ("dev", "tst-COMMON"):
        p, j = pres["datasets"][ds], jres["datasets"][ds]
        assert p["hypotheses"] == j["hypotheses"]
        assert p["samples"] == j["samples"] == 7
        for key in ("BLEU", "UncasedBLEU"):
            assert abs(p[key] - j[key]) <= 1e-6
    for key in ("BLEU", "UncasedBLEU"):
        assert abs(pres["weighted"][key] - jres["weighted"][key]) <= 1e-5
        assert abs(psaved["weighted"][key] - jsaved["weighted"][key]) <= 1e-5
    assert pres["weighted"]["BLEU"] > 0.0
    assert sorted(psaved["datasets"]) == sorted(jsaved["datasets"])


@pytest.fixture(scope="module")
def fractional(workdir):
    """Records of 7 utterances with fractional features, and a predict
    config that reads them."""
    root, _, cfg_path, _, _ = workdir
    rng = np.random.RandomState(11)
    records = os.path.join(root, "fractional.tfrecords")
    with RecordWriter(records) as w:
        for _ in range(7):
            audio = (3.0 * rng.randn(int(rng.randint(20, 65)), FEATURE_DIM)
                     ).astype(np.float32)
            w.write(build_example({
                "audio": audio.reshape(-1),
                "translation": " ".join(rng.choice(WORDS, 5))}))
    with open(cfg_path) as f:
        config = json.load(f)
    config["dataset.params"]["data_path"] = records
    path = os.path.join(root, "fractional.json")
    with open(path, "w") as f:
        json.dump(config, f)
    return path


def test_cli_predict_fractional_features_match_jax_beam_search(
        workdir, fractional):
    """The port decodes float32 features, which the JAX CLI cannot witness
    (its INFER batcher truncates audio to int32, ROADMAP R5).  The JAX
    model and ``BeamSearch``, called directly on the batches the port's
    task builds from fractional features, give the port CLI's
    hypotheses."""
    from neurst_tpu.layers.search.sequence_search import \
        build_search_layer as jax_build_search_layer
    from neurst_tpu.utils.checkpoints import (latest_checkpoint,
                                              restore_checkpoint_params)
    from neurst_tpu.utils.compat import DataStatus
    from neurst_tpu.utils.param_policy import \
        restore_inference_params as jax_restore_inference_params
    from neurst_tpu_torch.utils.compat import ModeKeys
    root, model_dir, _, _, _ = workdir
    argv = ["--config_paths", fractional, "--model_dir", model_dir]
    hypo = os.path.join(root, "hypo.fractional.txt")
    ours = port_run_exp.cli_main(argv + ["--output_file", hypo,
                                         "--device", "cpu"])

    args = port_run_exp.parse_and_merge(argv + ["--device", "cpu"])
    port_task = port_run_exp.build_task(args)
    batches = list(port_task.create_batch_iterator(
        port_run_exp.build_dataset(args), ModeKeys.INFER, args)())
    assert any(np.any(b["src"] != np.round(b["src"])) for b in batches)

    jargs = jax_run_exp.parse_and_merge(argv)
    task = jax_build_task(jargs)
    model = task.build_model({"model.class": jargs["model.class"],
                              "model.params": jargs["model.params"]})
    params, _ = jax_restore_inference_params(
        model, model.init_params(jax.random.PRNGKey(0)),
        restore_checkpoint_params(latest_checkpoint(model_dir)))
    search = jax_build_search_layer(jargs["entry.params"])
    search.set_model(model)
    generate = jax.jit(lambda p, inp: search(p, inp))
    decode = task.get_data_postprocess_fn(DataStatus.PROJECTED)
    theirs = []
    for batch in batches:
        model_inp = {k: v for k, v in batch.items()
                     if isinstance(v, np.ndarray) and v.dtype != object}
        hyp = np.asarray(generate(params, model_inp)[0])
        top_k = hyp.shape[0] // len(batch["sample_mask"])
        theirs += [decode(hyp[i * top_k].tolist())
                   for i, keep in enumerate(batch["sample_mask"]) if keep]
    assert ours["samples"] == len(theirs) == 7
    assert ours["hypotheses"] == theirs
    assert len(set(theirs)) > 1
    with open(hypo) as f:
        assert f.read().splitlines() == theirs


def test_parse_and_merge_matches_jax(workdir):
    """The MuST-C recipe's prediction config over the model dir's saved
    config resolves to the same flags in both packages (the port adds its
    ``device`` flag)."""
    root, model_dir, _, records, _ = workdir
    recipe = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "examples", "speech_transformer", "must-c",
                          "st_prediction_args.yml")
    argv = ["--config_paths", recipe, "--model_dir", model_dir,
            "--dataset.params", json.dumps({"data_path": records}),
            "--batch_size", "16"]
    ours = port_run_exp.parse_and_merge(argv)
    assert ours.pop("device") is None
    assert ours == jax_run_exp.parse_and_merge(argv)
    assert ours["entry.params"]["search_method.params"][
        "length_penalty"] == -1.0
    assert ours["model.params"]["encoder.enable_flash_attention"] is True


def test_cli_refuses_what_the_port_lacks(workdir):
    _, model_dir, cfg_path, _, _ = workdir
    base = ["--config_paths", cfg_path, "--model_dir", model_dir,
            "--device", "cpu"]
    for extra in (["--int8_serving"], ["--enable_quant"],
                  ["--distributed_init"], ["--include", "plugin.py"]):
        with pytest.raises(NotImplementedError):
            port_run_exp.cli_main(base + extra)
    # speculative decode is ported: without a draft it asks for one
    with pytest.raises(ValueError, match="draft_model_dir"):
        port_run_exp.cli_main(base + ["--search_method", "speculative"])
    with pytest.raises(LookupError):
        port_run_exp.cli_main(base + ["--search_method", "no_such_search"])


@pytest.mark.parametrize("extra, match", [
    (["--distribution_strategy", "mirrored"], "distribution_strategy"),
    (["--enable_xla"], "enable_xla"),
    (["--search_method.params", '{"padded_decode": false}'],
     "padded_decode")])
def test_cli_refuses_flag_values_the_port_does_not_honour(workdir, extra,
                                                          match):
    """Flags kept for the recipes' sake parse as in the JAX package, but a
    value that asks for behaviour the port lacks raises."""
    _, model_dir, cfg_path, _, _ = workdir
    with pytest.raises(NotImplementedError, match=match):
        port_run_exp.cli_main(["--config_paths", cfg_path, "--model_dir",
                               model_dir, "--device", "cpu"] + extra)


def test_restore_inference_params_matches_the_checkpoint(workdir):
    """The model dir's checkpoint reaches the port's model through
    ``latest_checkpoint`` and ``restore_inference_params``."""
    import torch

    from neurst_tpu_torch.utils import checkpoints as ckpt
    from neurst_tpu_torch.utils.param_bridge import flat_to_state_dict
    from neurst_tpu_torch.utils.param_policy import restore_inference_params
    _, model_dir, _, _, flat = workdir
    path = ckpt.latest_checkpoint(model_dir)
    assert path.endswith("ckpt-1.npz") and ckpt.list_checkpoints(
        model_dir) == [1]
    args = port_run_exp.parse_and_merge(["--model_dir", model_dir,
                                         "--entry", "predict"])
    task = port_run_exp.build_task(args)
    model = task.build_model({"model.class": args["model.class"],
                              "model.params": args["model.params"]},
                             device="cpu")
    restore_inference_params(model, ckpt.restore_checkpoint_params(path))
    want = flat_to_state_dict({k: np.asarray(v) for k, v in flat.items()},
                              model)
    for name, value in model.state_dict().items():
        assert torch.equal(value, want[name]), name
