"""The port's checkpoint converters against the JAX package's.

Each of the six registrations converts the same seeded state dict (the
public layout's key names and shapes, ``chip_smoke``'s builders at small
widths) in both packages: the names and arrays are bitwise equal, and so
are the ``ckpt-0.npz`` files both CLIs write, member by member (the zip
members' timestamps differ, so the test compares the members' names,
order and bytes).  Where ``transformers`` is installed, HuggingFace's
BERT, GPT-2 and wav2vec 2.0 modules against the port's models after
conversion, at the JAX package's tolerance (5e-4, 5e-3 for wav2vec 2.0:
``tests/models/test_converters.py``).
"""

import os
import zipfile

import numpy as np
import pytest
import torch

import port_test_support  # noqa: F401  (one torch thread per worker)

pytest.importorskip("jax")

import chip_smoke  # noqa: E402
import neurst_tpu_torch  # noqa: E402
from neurst_tpu.cli.convert_checkpoint import main as jax_cli  # noqa: E402
from neurst_tpu.utils.converters.converter import \
    build_converter as jax_converter  # noqa: E402
from neurst_tpu_torch.cli.convert_checkpoint import \
    main as port_cli  # noqa: E402
from neurst_tpu_torch.utils.converters import build_converter  # noqa: E402
from neurst_tpu_torch.utils.converters.tf_bundle import \
    load_bundle  # noqa: E402
from neurst_tpu_torch.utils.param_bridge import load_flat_params  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures",
                        "reference_goldens")
SMALL = {
    "bert": dict(layers=2, dim=32, heads=4, filter=64, vocab=53,
                 positions=40, token_types=2),
    "gpt2": dict(layers=2, dim=32, heads=4, positions=40, vocab=57),
    "wav2vec2": dict(layers=2, dim=32, heads=2, filter=64,
                     conv_channels=512, pos_kernel=128, pos_groups=16),
    "fairseq": dict(layers=2, dim=32, heads=4, filter=64, vocab=61),
}


def _source(name, tmp_path):
    """(torch checkpoint or npz path, num_heads) for a registration."""
    path = str(tmp_path / f"{name}.pt")
    if name in ("fairseq_transformer", "fairseq_transformer2"):
        cfg = SMALL["fairseq"]
        chip_smoke.save_torch_checkpoint(
            path, chip_smoke.fairseq_transformer_state_dict(
                1, cfg, in_proj=name.endswith("2")), fairseq=True)
    elif name == "google_bert":
        cfg = SMALL["bert"]
        state = chip_smoke.bert_state_dict(2, cfg)
        chip_smoke.save_torch_checkpoint(
            path, {f"bert.{k}": v for k, v in state.items()})
    elif name == "openai_gpt2":
        cfg = SMALL["gpt2"]
        chip_smoke.save_torch_checkpoint(path,
                                         chip_smoke.gpt2_state_dict(3, cfg))
    elif name == "fairseq_wav2vec2":
        cfg = SMALL["wav2vec2"]
        chip_smoke.save_torch_checkpoint(
            path, chip_smoke.wav2vec2_state_dict(4, cfg))
    else:  # neurst_transformer: a {tf variable name: array} npz
        path = str(tmp_path / "reference.npz")
        variables = load_bundle(os.path.join(FIXTURES, "corpus_tf_ckpt"))
        np.savez(path, **{k.split("/.ATTRIBUTES/")[0].replace(".S", "/"): v
                          for k, v in variables.items()
                          if v.dtype == np.float32})
        return path, 2
    return path, cfg["heads"]


NAMES = ["fairseq_transformer", "fairseq_transformer2", "google_bert",
         "openai_gpt2", "fairseq_wav2vec2", "neurst_transformer"]


@pytest.mark.parametrize("name", NAMES)
def test_converter_arrays_and_cli_files_equal_jax(name, tmp_path):
    path, heads = _source(name, tmp_path)
    args = {"converter.class": name, "converter.params": {"num_heads": heads}}
    ours = build_converter(args).convert_to_flat(path)
    want = jax_converter(args).convert_to_flat(path)
    assert list(ours) == list(want)
    for key, value in want.items():
        assert ours[key].dtype == value.dtype == np.float32, key
        assert ours[key].shape == value.shape, key
        assert ours[key].tobytes() == value.tobytes(), key
    argv = ["--converter", name, "--from_path", path, "--num_heads",
            str(heads)]
    port_cli(argv + ["--to_path", str(tmp_path / "port")])
    jax_cli(argv + ["--to_path", str(tmp_path / "jax")])
    members = []
    for side in ("port", "jax"):
        with zipfile.ZipFile(tmp_path / side / "ckpt-0.npz") as z:
            members.append([(i.filename, z.read(i.filename))
                            for i in z.infolist()])
        assert (tmp_path / side / "checkpoint.json").exists()
    assert members[0] == members[1]


def test_fairseq_both_attention_layouts_convert_alike(tmp_path):
    """The fused ``in_proj`` layout and the separate q/k/v projections of
    the same weights give the same arrays."""
    cfg = SMALL["fairseq"]
    fused = chip_smoke.fairseq_transformer_state_dict(5, cfg, in_proj=True)
    split = {}
    d = cfg["dim"]
    for key, value in fused.items():
        if key.endswith(".in_proj_weight") or key.endswith(".in_proj_bias"):
            base, kind = key.rsplit(".in_proj_", 1)
            for i, proj in enumerate(("q_proj", "k_proj", "v_proj")):
                split[f"{base}.{proj}.{kind}"] = value[i * d:(i + 1) * d]
        else:
            split[key] = value
    flats = []
    for name, state in (("fused", fused), ("split", split)):
        path = chip_smoke.save_torch_checkpoint(
            str(tmp_path / f"{name}.pt"), state, fairseq=True)
        flats.append(build_converter({
            "converter.class": "fairseq_transformer",
            "converter.params": {"num_heads": cfg["heads"]}}
        ).convert_to_flat(path))
    assert sorted(flats[0]) == sorted(flats[1])
    for key in flats[0]:
        np.testing.assert_array_equal(flats[0][key], flats[1][key])


def _hf_parity(tmp_path, hf, converter, heads, cfg, metas, inputs, out_key,
               hf_out, tol):
    path = str(tmp_path / "hf.bin")
    torch.save(hf.state_dict(), path)
    flat = build_converter({"converter.class": converter,
                            "converter.params": {"num_heads": heads}}
                           ).convert_to_flat(path)
    model = neurst_tpu_torch.build_model(cfg, device="cpu", **metas)
    load_flat_params(model, flat)
    with torch.no_grad():
        ours = model(inputs)
    ours = ours[out_key] if out_key else ours
    assert tuple(ours.shape) == tuple(hf_out.shape)
    assert float((ours - hf_out).abs().max()) < tol


def test_gpt2_hf_parity(tmp_path):
    transformers = pytest.importorskip("transformers")
    hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=23, n_positions=64, n_embd=16, n_layer=2, n_head=2,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)).eval()
    ids = np.array([[5, 7, 9, 11, 2], [1, 3, 2, 8, 4]], np.int64)
    with torch.no_grad():
        want = hf(torch.tensor(ids)).logits
    _hf_parity(tmp_path, hf, "openai_gpt2", 2,
               {"model.class": "gpt2", "model.params": {
                   "num_layers": 2, "hidden_size": 16,
                   "num_attention_heads": 2, "filter_size": 64,
                   "max_positions": 64, "dtype": "float32"}},
               {"trg_meta": {"vocab_size": 23, "eos_id": 22}},
               {"trg_input": ids}, None, want, 5e-4)


def test_bert_hf_parity(tmp_path):
    transformers = pytest.importorskip("transformers")
    hf = transformers.BertModel(transformers.BertConfig(
        vocab_size=29, hidden_size=16, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)).eval()
    ids = np.array([[2, 5, 7, 9], [4, 6, 8, 1]], np.int64)
    with torch.no_grad():
        want = hf(torch.tensor(ids)).last_hidden_state
    _hf_parity(tmp_path, hf, "google_bert", 2,
               {"model.class": "bert", "model.params": {
                   "num_layers": 2, "hidden_size": 16,
                   "num_attention_heads": 2, "filter_size": 64,
                   "max_positions": 64, "dtype": "float32"}},
               {"src_meta": {"vocab_size": 29}},
               {"src": ids, "src_padding": np.zeros([2, 4], np.float32)},
               "encoder_outputs", want, 5e-4)


def test_wav2vec2_hf_parity(tmp_path):
    transformers = pytest.importorskip("transformers")
    hf = transformers.Wav2Vec2Model(transformers.Wav2Vec2Config(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, conv_dim=[512] * 7,
        num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16,
        do_stable_layer_norm=False, feat_extract_norm="group",
        hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0,
        layerdrop=0.0, activation_dropout=0.0)).eval()
    wav = np.random.RandomState(0).randn(1, 4000).astype(np.float32)
    with torch.no_grad():
        want = hf(torch.tensor(wav)).last_hidden_state
    _hf_parity(tmp_path, hf, "fairseq_wav2vec2", 2,
               {"model.class": "wav2vec2", "model.params": {
                   "num_layers": 2, "hidden_size": 32,
                   "num_attention_heads": 2, "filter_size": 64,
                   "dtype": "float32"}},
               {}, {"src": wav}, "encoder_outputs", want, 5e-3)
