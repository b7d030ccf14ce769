"""The port's registries hold every name the JAX package registers, and
the data the port's own text tools are held to cannot go stale unseen.

* Every module path of the JAX package has a counterpart in the port,
  and every registry of the JAX package (tokenizers, metrics, models,
  ...) is a subset of the port's same-named registry (the port registers
  a few names more).  The generic ``seq2seq`` model the port registers now
  gives the JAX ``seq2seq`` model's logits on the same weights.
* ``tests/fixtures/text_goldens/goldens.json`` (what ``chip_smoke.py``'s
  ``text_tools`` phase holds the port to on the card) equals what
  ``tests/tools/make_text_goldens.py`` makes from sacremoses, sacrebleu
  and the ``tokenizers`` SentencePiece on this host, and the port gives
  every golden line; ``tests/fixtures/spm`` equals what
  ``tests/tools/make_spm_fixture.py`` writes.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("sacremoses")
pytest.importorskip("sacrebleu")
pytest.importorskip("transformers.utils.sentencepiece_model_pb2_new")

import chip_smoke  # noqa: E402
import neurst_tpu  # noqa: E402,F401
import neurst_tpu_torch  # noqa: E402
from neurst_tpu.utils.registry import \
    REGISTRIES as JAX_REGISTRIES  # noqa: E402
from neurst_tpu_torch.utils.registry import REGISTRIES  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tests", "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("registry", sorted(JAX_REGISTRIES))
def test_port_registry_holds_every_jax_name(registry):
    missing = set(JAX_REGISTRIES[registry]) - set(REGISTRIES.get(
        registry, {}))
    assert not missing, (registry, sorted(missing))


def test_every_jax_module_has_a_port_counterpart():
    def modules(package):
        root = os.path.join(REPO, package)
        return {os.path.relpath(os.path.join(base, f), root)
                for base, _, files in os.walk(root) for f in files
                if f.endswith(".py")}
    missing = modules("neurst_tpu") - modules("neurst_tpu_torch")
    assert not missing, sorted(missing)


@pytest.mark.parametrize("name", ["spm", "sentencepiece", "thai", "moses"])
def test_text_tokenizer_names(name):
    assert name in REGISTRIES["tokenizer"]


@pytest.mark.parametrize("name", ["uncased_bleu", "sacre_bleu",
                                  "sacrebleu"])
def test_bleu_metric_names(name):
    assert name in REGISTRIES["metric"]


def test_seq2seq_model_matches_jax():
    import jax.numpy as jnp
    import torch
    from neurst_tpu.models.model import build_model as jax_build
    from neurst_tpu.models.transformer import Transformer
    from neurst_tpu.utils.checkpoints import flatten_params
    from neurst_tpu_torch.utils.param_bridge import load_flat_params
    params = dict(Transformer.build_model_args_by_name(
        "transformer_toy")["model.params"], dtype="float32")
    for side in ("encoder", "decoder"):
        for rate in ("attention_dropout_rate", "ffn_dropout_rate",
                     "layer_postprocess_dropout_rate"):
            params[f"{side}.{rate}"] = 0.0
    cfg = {"model.class": "seq2seq", "model.params": params}
    meta = {"vocab_size": 24, "eos_id": 1, "bos_id": 2, "unk_id": 3}
    jm = jax_build(cfg, src_meta=meta, trg_meta=meta)
    weights = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in flatten_params(weights).items()}
    rng = np.random.RandomState(0)
    batch = {"src": rng.randint(0, 24, (2, 7)).astype(np.int32),
             "src_padding": np.array([[0] * 7, [0] * 5 + [1] * 2],
                                     np.float32),
             "trg_input": rng.randint(0, 24, (2, 5)).astype(np.int32)}
    want = np.asarray(jax.jit(jm.call)(weights, {
        k: jnp.asarray(v) for k, v in batch.items()}))
    model = neurst_tpu_torch.build_model(cfg, src_meta=meta, trg_meta=meta,
                                         device="cpu")
    assert type(model).__name__ == "EncoderDecoderModel"
    load_flat_params(model, flat)
    with torch.no_grad():
        got = model(batch).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_goldens_are_current_and_the_port_gives_them():
    with open(os.path.join(REPO, chip_smoke.TEXT_GOLDENS),
              encoding="utf-8") as f:
        committed = json.load(f)
    assert committed == json.loads(json.dumps(_tool(
        "make_text_goldens").goldens()))
    chip_smoke.text_tools_phase()


def test_spm_fixtures_are_current(tmp_path):
    tool = _tool("make_spm_fixture")
    tool.OUT = str(tmp_path)
    tool.main()
    fixtures = os.path.join(REPO, chip_smoke.SPM_FIXTURES)
    assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(fixtures))
    for name in os.listdir(fixtures):
        with open(os.path.join(fixtures, name), "rb") as a, \
                open(os.path.join(tmp_path, name), "rb") as b:
            assert a.read() == b.read(), name
