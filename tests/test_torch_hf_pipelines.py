"""The HuggingFace tokenizer and the BERT and GPT-2 data pipelines in the
port against the JAX package's.  Both need ``transformers`` (these cases
skip without it); the tokenizers are built offline from files written
here (a WordPiece vocabulary; a byte-level BPE ``vocab.json`` and
``merges.txt``) and saved as a local tokenizer dir, which both packages
load through ``AutoTokenizer.from_pretrained``.  Token ids, token
strings and decoded text are equal."""

import json

import pytest

pytest.importorskip("jax")
transformers = pytest.importorskip("transformers")

from neurst_tpu.data.data_pipelines.data_pipeline import \
    build_data_pipeline as jax_pipeline  # noqa: E402
from neurst_tpu.data.text.tokenizer import \
    build_tokenizer as jax_tokenizer  # noqa: E402
from neurst_tpu_torch.data.data_pipelines import \
    build_data_pipeline  # noqa: E402
from neurst_tpu_torch.data.text import build_tokenizer  # noqa: E402

TEXTS = ["Hello, world! unaffable tokenizers", "the quick brown fox",
         "a b c d"]
WORDPIECE = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", ",",
             "world", "!", "un", "##aff", "##able", "token", "##izer", "##s",
             "the", "quick", "brown", "fox", "a", "b", "c", "d"]


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("bert_tok")
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(WORDPIECE) + "\n")
    tok = transformers.BertTokenizer(vocab_file=str(vocab))
    tok.save_pretrained(str(root / "tok"))
    return root


@pytest.fixture(scope="module")
def gpt2_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("gpt2_tok")
    gpt2 = transformers.models.gpt2.tokenization_gpt2
    tokens = sorted(set(gpt2.bytes_to_unicode().values()))
    merges = ["Ġ t", "h e", "Ġt he", "o r", "Ġ w", "Ġw or", "l d",
              "Ġwor ld"]
    for m in merges:
        tokens.append(m.replace(" ", ""))
    tokens.append("<|endoftext|>")
    vocab = {t: i for i, t in enumerate(tokens)}
    (root / "vocab.json").write_text(json.dumps(vocab))
    (root / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges)
                                     + "\n")
    tok = transformers.GPT2Tokenizer(vocab_file=str(root / "vocab.json"),
                                     merges_file=str(root / "merges.txt"))
    tok.save_pretrained(str(root / "tok"))
    # the pipeline's vocabulary: the encoder.json tokens in id order
    (root / "encoder.txt").write_text("\n".join(tokens) + "\n")
    return root


def test_huggingface_tokenizer_matches_jax(bert_dir):
    args = {"tokenizer.class": "huggingface", "tokenizer.params": {}}
    ours, theirs = build_tokenizer("huggingface"), jax_tokenizer(args)
    for tok in (ours, theirs):
        tok.init_subtokenizer(str(bert_dir / "tok"))
    for text in TEXTS:
        assert ours.tokenize(text) == theirs.tokenize(text)
        assert ours.tokenize(text, return_str=True) == theirs.tokenize(
            text, return_str=True)
        joined = theirs.tokenize(text, return_str=True)
        assert ours.detokenize(joined) == theirs.detokenize(joined)


def test_uninitialized_tokenizer_raises():
    with pytest.raises(ValueError, match="not initialized"):
        build_tokenizer("huggingface").tokenize("a")


def _pipelines(cls, params):
    cfg = {"data_pipeline.class": cls, "data_pipeline.params": params}
    return build_data_pipeline(cfg), jax_pipeline(cfg)


def test_bert_pipeline_matches_jax(bert_dir):
    ours, theirs = _pipelines("BertDataPipeline", {
        "vocab_path": str(bert_dir / "vocab.txt"),
        "tokenizer_name": str(bert_dir / "tok")})
    assert ours.meta == theirs.meta
    for text in TEXTS:
        ids = theirs.encode(text)
        assert ours.encode(text) == ids
        assert ids[0] == ours.meta["cls_id"] and ids[-1] == \
            ours.meta["sep_id"]
        assert ours.decode(ids) == theirs.decode(ids)


def test_gpt2_pipeline_matches_jax(gpt2_dir):
    ours, theirs = _pipelines("GPT2DataPipeline", {
        "vocab_path": str(gpt2_dir / "encoder.txt"),
        "tokenizer_name": str(gpt2_dir / "tok")})
    assert ours.meta == theirs.meta
    assert ours.meta["eos_id"] == ours.meta["pad_id"]
    for text in TEXTS:
        ids = theirs.encode(text)
        assert ours.encode(text) == ids and ids[-1] == ours.meta["eos_id"]
        assert ours.decode(ids) == theirs.decode(ids)


def test_pipelines_need_a_vocabulary():
    for cls in ("BertDataPipeline", "GPT2DataPipeline"):
        with pytest.raises(ValueError, match="vocab_path"):
            build_data_pipeline({"data_pipeline.class": cls,
                                 "data_pipeline.params": {}})
