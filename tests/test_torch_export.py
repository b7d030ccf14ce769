"""The port's ``export`` entry (``neurst_tpu_torch/exps/export.py``)
against its eager beam search and the JAX package's live search
(``neurst_tpu/exps/export.py``; the form of
``tests/exps/test_validation_and_export.py``'s export tests).

Each export (text ids, speech features with the flash encoder, raw
audio, int8 serving) of a seeded model dir is reloaded in a fresh
interpreter that imports ``neurst_tpu_torch.exps.export`` alone; its
hypotheses and scores equal the port's eager ``BeamSearch`` bitwise, and
the JAX package's live search up to the first EOS (R3) with scores
within 1e-4.  The static beam step equals the eager search after every
number of steps; raw audio equals ``device_logfbank`` followed by the
feature export; the custom ops are one node each in an exported program
and survive ``save`` / ``load``.  ``top_sampling`` exports (text, speech;
top-k / nucleus / temperature with 2 samples, and the argmax) give the
eager search's tokens and scores under its seed; ``speculative_decode``
exports (the n-gram draft, a draft model) give the eager speculative
search's output, which is plain greedy decoding's; speculative sampling
raises.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import port_test_support  # noqa: F401  (one torch thread per worker)

jax = pytest.importorskip("jax")
jax.config.update("jax_default_matmul_precision", "float32")

from neurst_tpu.layers.search.sequence_search import \
    build_search_layer as jax_build_search  # noqa: E402
from neurst_tpu.tasks.task import build_task as jax_build_task  # noqa: E402
from neurst_tpu.utils import checkpoints as jax_ckpt  # noqa: E402

import neurst_tpu_torch  # noqa: E402,F401
from neurst_tpu_torch.exps.base_experiment import (BaseExperiment,  # noqa
                                                   build_exp)
from neurst_tpu_torch.exps.export import (ENCODE_FILE,  # noqa: E402
                                          load_exported)
from neurst_tpu_torch.layers.quantization.quant_layers import \
    set_int8_serving  # noqa: E402
from neurst_tpu_torch.layers.search.beam_search import (  # noqa: E402
    beam_search_result, beam_step, initial_beam_state, sequence_beam_search)
from neurst_tpu_torch.layers.search.sequence_search import \
    build_search_layer  # noqa: E402
from neurst_tpu_torch.ops.device_fbank import device_logfbank  # noqa: E402
from neurst_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_fwd, flash_attention_reference)
from neurst_tpu_torch.ops.fused_ffn import fused_ffn_fwd  # noqa: E402
from neurst_tpu_torch.tasks.task import build_task  # noqa: E402
from neurst_tpu_torch.utils import checkpoints as port_ckpt  # noqa: E402
from neurst_tpu_torch.utils.param_bridge import \
    unstack_scan_layers  # noqa: E402

from port_test_support import REPO  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

VOCAB = os.path.join(REPO, "tests", "examples", "vocab.txt")
BEAM, MAX_LEN = 3, 10
SEARCH = {"search_method.class": "beam_search",
          "search_method.params": {"beam_size": BEAM,
                                   "maximum_decode_length": MAX_LEN,
                                   "extra_decode_length": MAX_LEN,
                                   "length_penalty": 0.6}}
TEXT_TASK = {"task.class": "translation", "task.params": {
    "src_data_pipeline.class": "TextDataPipeline",
    "src_data_pipeline.params": {"vocab_path": VOCAB},
    "trg_data_pipeline.class": "TextDataPipeline",
    "trg_data_pipeline.params": {"vocab_path": VOCAB}}}
SPEECH_TASK = {"task.class": "speech2text", "task.params": {
    "transcript_data_pipeline.class": "TextDataPipeline",
    "transcript_data_pipeline.params": {"vocab_path": VOCAB},
    "audio_feature_dim": 16}}
TEXT_MODEL = {"model.class": "transformer", "model.params": {
    "modality.dim": 16, "modality.timing": "sinusoids",
    "modality.share_embedding_and_softmax_weights": False,
    "encoder.num_layers": 1, "decoder.num_layers": 1,
    "encoder.hidden_size": 16, "decoder.hidden_size": 16,
    "encoder.num_attention_heads": 2, "decoder.num_attention_heads": 2,
    "encoder.filter_size": 32, "decoder.filter_size": 32,
    "dtype": "float32"}}
AUDIO_SAMPLES = 4000
# the fbank frames of AUDIO_SAMPLES: the feature export serves the raw
# audio's features too
FRAMES = 24


def _speech_model():
    from neurst_tpu.models.speech_transformer import SpeechTransformer
    cfg = SpeechTransformer.build_model_args_by_name(
        "speech_transformer_toy")
    params = dict(cfg["model.params"], dtype="float32")
    params["encoder.enable_flash_attention"] = True
    params["modality.share_embedding_and_softmax_weights"] = False
    return {"model.class": "speech_transformer", "model.params": params}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _until_eos(ids, eos):
    out = []
    for row in _np(ids).tolist():
        out.append(tuple(row[:row.index(eos) + 1] if eos in row else row))
    return out


def _seeded_dir(root, name, task_cfg, model_cfg, seed):
    """A model dir of seeded weights (0.5 x a normal draw: random tied or
    untrained softmaxes mostly repeat one token) saved by the JAX
    package; returns (dir, JAX model, JAX params)."""
    jtask = jax_build_task(task_cfg)
    jmodel = jtask.build_model(model_cfg)
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda x: (0.5 * rng.randn(*x.shape)).astype(np.float32),
        jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(seed)))
    model_dir = os.path.join(root, name)
    jax_ckpt.save_checkpoint(model_dir, 1, jax.tree_util.tree_map(
        np.asarray, params))
    with open(os.path.join(model_dir, "model_configs.yml"), "w") as f:
        json.dump(dict(task_cfg, **model_cfg), f)
    return model_dir, jmodel, params


def _port(task_cfg, model_cfg, model_dir):
    task = build_task(task_cfg)
    model = task.build_model(model_cfg, device="cpu")
    BaseExperiment(model=model, model_dir=model_dir).restore_params()
    return task, model


def _export(task_cfg, model_cfg, model_dir, path, batch, src_len, **extra):
    task = build_task(task_cfg)
    model = task.build_model(model_cfg, device="cpu")
    entry = build_exp({"entry.class": "export", "entry.params": dict(
        SEARCH, export_path=path, export_batch_size=batch,
        export_src_length=src_len, **extra)},
        task=task, model=model, model_dir=model_dir)
    assert entry.run() == path
    return path


def _text_inputs():
    rng = np.random.RandomState(3)
    lengths = np.asarray([7, 4, 6])
    src = rng.randint(4, 40, (3, 7)).astype(np.int32)
    src[np.arange(3), lengths - 1] = 42  # the vocabulary's EOS
    src[np.arange(7)[None] >= lengths[:, None]] = 0
    return {"src": src, "src_padding": (np.arange(7)[None] >= lengths[
        :, None]).astype(np.float32)}


def _speech_inputs():
    rng = np.random.RandomState(4)
    lengths = np.asarray([FRAMES, 17], np.int32)
    src = rng.randn(2, FRAMES, 16, 1).astype(np.float32)
    src[np.arange(FRAMES)[None] >= lengths[:, None]] = 0.0
    return {"src": src, "src_length": lengths}


def _audio_inputs():
    rng = np.random.RandomState(5)
    return {"audio": (rng.randn(2, AUDIO_SAMPLES) * 1000).astype(np.float32),
            "audio_length": np.asarray([AUDIO_SAMPLES, 3100], np.int32)}


RELOAD = r"""
import json, os, sys, time
import numpy as np
from neurst_tpu_torch.exps.export import load_exported
while not os.path.exists(sys.argv[1]):
    time.sleep(0.05)
jobs = json.load(open(sys.argv[1]))
for path, inputs, out in jobs:
    with np.load(inputs) as data:
        hyp, scores = load_exported(path, "cpu")(dict(data))
    np.savez(out, hyp=hyp.numpy(), scores=scores.numpy())
assert not any(m == "jax" or m.startswith(("jax.", "neurst_tpu."))
               for m in sys.modules)
"""


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("export"))
    jobs_path = os.path.join(root, "jobs.json")
    # the fresh interpreter imports while the exports are made; it waits
    # for the jobs file
    reload = subprocess.Popen([sys.executable, "-c", RELOAD, jobs_path],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
    try:
        return _exports(root, jobs_path, reload)
    finally:
        reload.kill()


def _exports(root, jobs_path, reload):
    text_dir, jtext, jtext_params = _seeded_dir(root, "text", TEXT_TASK,
                                                TEXT_MODEL, 1)
    speech_model = _speech_model()
    speech_dir, jspeech, jspeech_params = _seeded_dir(
        root, "speech", SPEECH_TASK, speech_model, 5)
    kinds = {
        "text": (TEXT_TASK, TEXT_MODEL, text_dir, 3, 7, {}, _text_inputs()),
        "speech": (SPEECH_TASK, speech_model, speech_dir, 2, FRAMES, {},
                   _speech_inputs()),
        "raw_audio": (SPEECH_TASK, speech_model, speech_dir, 2,
                      AUDIO_SAMPLES, {"export_raw_audio": True},
                      _audio_inputs())}
    out = {"root": root, "kinds": kinds,
           "jax": {"text": (jtext, jtext_params),
                   "speech": (jspeech, jspeech_params)}}
    jobs = []
    for kind, (task_cfg, model_cfg, model_dir, batch, src_len, extra,
               inputs) in kinds.items():
        path = _export(task_cfg, model_cfg, model_dir,
                       os.path.join(root, f"export_{kind}"), batch, src_len,
                       **extra)
        np.savez(os.path.join(root, f"{kind}_inputs.npz"), **inputs)
        jobs.append([path, os.path.join(root, f"{kind}_inputs.npz"),
                     os.path.join(root, f"{kind}_reloaded.npz")])
    set_int8_serving(True)
    try:
        path = _export(TEXT_TASK, TEXT_MODEL, text_dir,
                       os.path.join(root, "export_int8"), 3, 7)
        _, model = _port(TEXT_TASK, TEXT_MODEL, text_dir)
        out["int8_eager"] = _eager(model, _text_inputs())
    finally:
        set_int8_serving(False)
    jobs.append([path, os.path.join(root, "text_inputs.npz"),
                 os.path.join(root, "int8_reloaded.npz")])
    with open(jobs_path + ".tmp", "w") as f:
        json.dump(jobs, f)
    os.replace(jobs_path + ".tmp", jobs_path)
    _, err = reload.communicate(timeout=600)
    assert reload.returncode == 0, err[-4000:]
    for kind in list(kinds) + ["int8"]:
        with np.load(os.path.join(root, f"{kind}_reloaded.npz")) as data:
            out[f"{kind}_reloaded"] = (data["hyp"], data["scores"])
    return out


def _eager(model, inputs):
    search = build_search_layer(SEARCH)
    search.set_model(model)
    hyp, scores = search({k: torch.from_numpy(v) for k, v in inputs.items()})
    return _np(hyp), _np(scores)


@pytest.mark.parametrize("kind", ["text", "speech", "int8"])
def test_reloaded_export_equals_eager_beam_search(exports, kind):
    base = "text" if kind == "int8" else kind
    task_cfg, model_cfg, model_dir, _, _, _, inputs = exports["kinds"][base]
    if kind == "int8":
        want = exports["int8_eager"]
    else:
        want = _eager(_port(task_cfg, model_cfg, model_dir)[1], inputs)
    hyp, scores = exports[f"{kind}_reloaded"]
    np.testing.assert_array_equal(hyp, want[0])
    np.testing.assert_array_equal(scores, want[1])
    assert len(set(map(tuple, hyp.tolist()))) > 1, "decodes all equal"


@pytest.mark.parametrize("kind", ["text", "speech"])
def test_reloaded_export_equals_jax_live_search(exports, kind):
    jmodel, params = exports["jax"][kind]
    inputs = exports["kinds"][kind][-1]
    search = jax_build_search(SEARCH)
    search.set_model(jmodel)
    jhyp, jscores = search(params, inputs)
    hyp, scores = exports[f"{kind}_reloaded"]
    assert _until_eos(hyp, 42) == _until_eos(jhyp, 42)
    np.testing.assert_allclose(scores, np.asarray(jscores), atol=1e-4)


def test_export_dir_holds_the_programs_weights_and_configs(exports):
    path = os.path.join(exports["root"], "export_speech")
    assert sorted(os.listdir(path)) == sorted([
        "generation.pt2", "generation_step.pt2", "generation.graph.txt",
        "ckpt-0.npz", "checkpoint.json", "model_configs.yml"])
    # the JAX package reads the served weights (float32 here: exact)
    ours = jax_ckpt.restore_checkpoint_params(os.path.join(path,
                                                           "ckpt-0.npz"))
    want = unstack_scan_layers(port_ckpt.restore_checkpoint_params(
        os.path.join(exports["root"], "speech", "ckpt-1.npz")))
    assert sorted(ours) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(ours[name], want[name], err_msg=name)
    text = open(os.path.join(path, "generation.graph.txt")).read()
    assert "neurst_tpu_torch.flash_attention_fwd" in text
    ep = torch.export.load(os.path.join(path, ENCODE_FILE))
    flash = [n for n in ep.graph.nodes if n.op == "call_function"
             and "flash_attention_fwd" in str(n.target)]
    layers = _speech_model()["model.params"]["encoder.num_layers"]
    assert len(flash) == layers


def test_raw_audio_export_equals_fbank_then_feature_export(exports):
    """The raw-audio program equals ``device_logfbank`` on the same
    waveforms followed by the feature program, bitwise (both compute the
    features with the same op; R8 is a difference to the JAX op)."""
    from neurst_tpu_torch.exps.export import load_exported
    inputs = _audio_inputs()
    feats, frames = device_logfbank(torch.from_numpy(inputs["audio"]),
                                    torch.from_numpy(inputs["audio_length"]),
                                    nfilt=16)
    assert feats.shape[1] == FRAMES
    hyp, scores = load_exported(os.path.join(exports["root"],
                                             "export_speech"), "cpu")(
        {"src": feats[..., None], "src_length": frames})
    raw_hyp, raw_scores = exports["raw_audio_reloaded"]
    np.testing.assert_array_equal(raw_hyp, _np(hyp))
    np.testing.assert_array_equal(raw_scores, _np(scores))


def test_static_beam_step_equals_eager_search_step_by_step(exports):
    """After every number of steps n the static step's state gives the
    eager search's result at maximum_decode_length n."""
    task_cfg, model_cfg, model_dir, _, _, _, inputs = \
        exports["kinds"]["text"]
    _, model = _port(task_cfg, model_cfg, model_dir)
    meta = model.generation_meta
    args = dict(beam_size=BEAM, length_penalty=0.6,
                minimum_decode_length=3)
    with torch.no_grad():
        _, init = model.prepare_generation(inputs, MAX_LEN)
        src_maxlen = init["encoder_inputs_maxlen"]
        state = initial_beam_state(init, BEAM, MAX_LEN)
        time = torch.zeros_like(state["ids"])
        for n in range(1, MAX_LEN + 1):
            state = beam_step(model.decode_steps, state, time,
                              eos_id=meta["eos_id"], unk_id=meta["unk_id"],
                              **args)
            time = time + 1
            if n < args["minimum_decode_length"]:
                continue
            # the eager loop stops after n steps at src_maxlen + extra
            s2l, eager_init = model.prepare_generation(inputs, MAX_LEN)
            want = sequence_beam_search(s2l, eager_init,
                                        maximum_decode_length=MAX_LEN,
                                        extra_decode_length=n - src_maxlen,
                                        **args)
            got = beam_search_result(state, BEAM, 1, 0.6)
            np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
            np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
            if bool(state["finished"].all()):
                break
    assert n > args["minimum_decode_length"]


def test_custom_ops_are_one_node_each_through_save_and_load(tmp_path):
    rng = np.random.RandomState(6)

    class Ops(torch.nn.Module):
        def forward(self, q, k, v, lengths, x, w1, b1, w2, b2):
            o, lse = flash_attention_fwd(q, k, v, lengths)
            y, _ = fused_ffn_fwd(x, w1, b1, w2, b2)
            return o, lse, y

    args = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in (
        [2, 5, 2, 8], [2, 6, 2, 8], [2, 6, 2, 8])]
    args.append(torch.tensor([6, 3], dtype=torch.int32))
    args += [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in (
        [7, 16], [32, 16], [32], [16, 32], [16])]
    ep = torch.export.export(Ops(), tuple(args))
    path = str(tmp_path / "ops.pt2")
    torch.export.save(ep, path)
    loaded = torch.export.load(path)
    targets = [str(n.target) for n in loaded.graph.nodes
               if n.op == "call_function"]
    assert targets.count("neurst_tpu_torch.flash_attention_fwd.default") == 1
    assert targets.count("neurst_tpu_torch.fused_ffn_fwd.default") == 1
    o, lse, y = loaded.module()(*args)
    want_o, want_lse = flash_attention_reference(*args[:4])
    np.testing.assert_array_equal(_np(o), _np(want_o))
    np.testing.assert_array_equal(_np(lse), _np(want_lse))
    np.testing.assert_array_equal(
        _np(y), _np(fused_ffn_fwd(*args[4:])[0]))


def _export_search(exports, kind, search, name, draft=False):
    """The ``kind`` export of ``search`` ({search_method.class, .params}),
    loaded here, and the eager search on the same model and inputs."""
    task_cfg, model_cfg, model_dir, batch, src_len, extra, inputs = \
        exports["kinds"][kind]
    search = json.loads(json.dumps(search))
    if draft:
        search["search_method.params"]["draft_model_dir"] = model_dir
    task = build_task(task_cfg)
    model = task.build_model(model_cfg, device="cpu")
    path = os.path.join(exports["root"], name)
    entry = build_exp({"entry.class": "export", "entry.params": dict(
        search, export_path=path, export_batch_size=batch,
        export_src_length=src_len, **extra)},
        task=task, model=model, model_dir=model_dir)
    assert entry.run() == path
    loaded = load_exported(path, "cpu")(inputs)
    _, model = _port(task_cfg, model_cfg, model_dir)
    eager = build_search_layer(search)
    eager.set_model(model)
    eager.prepare()
    want = eager({k: torch.from_numpy(v) for k, v in inputs.items()})
    return loaded, want, model, inputs


SAMPLING = {"search_method.class": "top_sampling",
            "search_method.params": {
                "top_k": 6, "top_p": 0.95, "temperature": 1.3,
                "num_samples": 2, "seed": 11,
                "maximum_decode_length": MAX_LEN,
                "extra_decode_length": MAX_LEN}}


@pytest.mark.parametrize("kind,top_k", [("text", 6), ("speech", 6),
                                        ("text", 1)])
def test_exported_sampling_equals_eager_under_its_seed(exports, kind,
                                                       top_k):
    """The step takes the draws that ``torch.multinomial`` takes from the
    seeded generator: the loaded search gives the eager ``top_sampling``'s
    tokens and scores (``top_k`` 1: the argmax, no draws)."""
    search = json.loads(json.dumps(SAMPLING))
    search["search_method.params"]["top_k"] = top_k
    (hyp, scores), (want, want_scores), _, _ = _export_search(
        exports, kind, search, f"sampling_{kind}_{top_k}")
    np.testing.assert_array_equal(_np(hyp), _np(want))
    np.testing.assert_array_equal(_np(scores), _np(want_scores))
    if top_k > 1:  # the draws matter
        assert len({tuple(r) for r in _np(hyp).tolist()}) > 1


SPECULATIVE = {"search_method.class": "speculative_decode",
               "search_method.params": {
                   "draft_method": "ngram", "speculative_k": 3,
                   "maximum_decode_length": MAX_LEN,
                   "extra_decode_length": MAX_LEN}}


@pytest.mark.parametrize("kind,draft", [("text", "ngram"),
                                        ("text", "model"),
                                        ("speech", "ngram")])
def test_exported_speculative_equals_plain_greedy(exports, kind, draft):
    """The exported draft (n-gram lookup, or a draft model: here the
    target's own weights) and k-token verification step decode as the
    eager speculative search, whose output is plain greedy decoding's."""
    search = json.loads(json.dumps(SPECULATIVE))
    search["search_method.params"]["draft_method"] = draft
    (hyp, scores), (want, want_scores), model, inputs = _export_search(
        exports, kind, search, f"speculative_{kind}_{draft}",
        draft=draft == "model")
    np.testing.assert_array_equal(_np(hyp), _np(want))
    np.testing.assert_array_equal(_np(scores), _np(want_scores))
    greedy = build_search_layer({
        "search_method.class": "beam_search", "search_method.params": {
            "beam_size": 1, "maximum_decode_length": MAX_LEN,
            "extra_decode_length": MAX_LEN, "length_penalty": -1}})
    greedy.set_model(model)
    plain, _ = greedy({k: torch.from_numpy(v) for k, v in inputs.items()})
    eos = model.generation_meta["eos_id"]
    assert _until_eos(hyp, eos) == _until_eos(plain, eos)


def test_export_refuses_speculative_sampling(exports):
    task_cfg, model_cfg, model_dir = exports["kinds"]["text"][:3]
    task = build_task(task_cfg)
    model = task.build_model(model_cfg, device="cpu")
    search = json.loads(json.dumps(SPECULATIVE))
    search["search_method.params"]["sampling"] = True
    entry = build_exp({"entry.class": "export", "entry.params": dict(
        search, export_path=os.path.join(exports["root"], "refused"))},
        task=task, model=model, model_dir=model_dir)
    with pytest.raises(ValueError, match="speculative sampling"):
        entry.run()
