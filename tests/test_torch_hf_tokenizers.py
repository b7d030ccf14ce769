"""The port's own WordPiece and byte-level BPE (``wordpiece``,
``byte_level_bpe``, read from a tokenizer directory by
``hf_tokenizer_files``) against ``AutoTokenizer`` (the fast tokenizers of
``transformers`` / ``tokenizers``, what the JAX wrapper builds), on the
committed fixture directories under ``tests/fixtures/hf/``: BERT cased
and uncased, GPT-2 and RoBERTa, each as a ``tokenizer.json`` directory
and as a slow-files one.  Tokens, ids and ``convert_tokens_to_string``
are equal on seeded lines of many scripts, accents, control characters,
emoji, whitespace of every kind and special tokens inside a line; the
character classes equal the ``tokenizers`` ones over every code point;
the ``huggingface`` tokenizer and the ``bert`` and ``gpt2`` pipelines
equal the JAX package's.  All exact.  The fixtures and goldens are what
``tests/tools/make_tokenizer_goldens.py`` writes, and the tables what
``tests/tools/make_hf_tables.py`` writes."""

import importlib.util
import json
import os
import warnings

import pytest

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")
pytest.importorskip("jax")

from neurst_tpu_torch.data.data_pipelines import \
    build_data_pipeline  # noqa: E402
from neurst_tpu_torch.data.text import build_tokenizer  # noqa: E402
from neurst_tpu_torch.data.text import hf_unicode_tables  # noqa: E402
from neurst_tpu_torch.data.text.byte_level_bpe import (  # noqa: E402
    GPT2_PATTERN, bytes_to_unicode)
from neurst_tpu_torch.data.text.hf_tokenizer_files import \
    load_tokenizer_dir  # noqa: E402
from neurst_tpu_torch.data.text.wordpiece import (  # noqa: E402
    BertNormalizer, bert_pre_tokenize)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "hf")
GOLDENS = os.path.join(REPO, "tests", "fixtures", "text_goldens",
                       "tokenizer_goldens.json")
NAMES = ("bert_cased", "bert_uncased", "gpt2", "roberta")
DIRS = [f"{name}_{kind}" for name in NAMES for kind in ("fast", "slow")]


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tests", "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TOOL = _tool("make_tokenizer_goldens")


def _auto(path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return transformers.AutoTokenizer.from_pretrained(path)


@pytest.fixture(scope="module")
def goldens():
    with open(GOLDENS, encoding="utf-8") as f:
        return json.load(f)["hf"]


@pytest.mark.parametrize("name", DIRS)
def test_tokenizer_equals_auto_tokenizer(name):
    """Seeded lines other than the goldens': tokens, ids and the
    detokenized text of the port equal ``AutoTokenizer``'s, on the
    ``tokenizer.json`` directory and on the slow files."""
    path = os.path.join(FIXTURES, name)
    ours, theirs = load_tokenizer_dir(path), _auto(path)
    assert theirs.is_fast
    family = name.rsplit("_", 1)[0]
    lines = TOOL.mixed_lines(300, 1000 + DIRS.index(name),
                             TOOL.hf_specials(family))
    for s in lines:
        tokens = theirs.tokenize(s)
        assert ours.tokenize(s) == tokens, s
        assert ours.convert_tokens_to_ids(tokens) == \
            theirs.convert_tokens_to_ids(tokens), s
        assert ours.convert_tokens_to_string(tokens) == \
            theirs.convert_tokens_to_string(tokens), s


@pytest.mark.parametrize("part", list(TOOL.PARTS))
def test_goldens_are_current_and_the_port_gives_them(goldens, part):
    """The committed goldens are ``AutoTokenizer``'s on both directories
    of the fixture, and the port gives them from both."""
    g = goldens[part]
    assert g["lines"] == TOOL.mixed_lines(
        TOOL.HF_LINES, 40 + list(TOOL.PARTS).index(part),
        TOOL.hf_specials(g["fixture"]))
    for kind in ("fast", "slow"):
        path = os.path.join(FIXTURES, f"{g['fixture']}_{kind}")
        theirs, ours = _auto(path), load_tokenizer_dir(path)
        want = [theirs.tokenize(s) for s in g["lines"]]
        assert want == g["tokens"], kind
        assert [theirs.convert_tokens_to_ids(t) for t in want] == g["ids"]
        assert [theirs.convert_tokens_to_string(t) for t in want] == \
            g["detokenized"]
        assert [ours.tokenize(s) for s in g["lines"]] == g["tokens"], kind
        assert [ours.convert_tokens_to_ids(t) for t in g["tokens"]] == \
            g["ids"]
        assert [ours.convert_tokens_to_string(t) for t in g["tokens"]] \
            == g["detokenized"]
    lines = g["lines"]
    assert any("\x1c" in s for s in lines) and any("　" in s
                                                    for s in lines)
    assert any(s.count(t) and not s.startswith(t) for s in lines
               for t in TOOL.hf_specials(g["fixture"]))


def test_fixtures_are_current(tmp_path):
    TOOL.build_fixtures(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == sorted(DIRS)
    for name in DIRS:
        files = sorted(os.listdir(os.path.join(FIXTURES, name)))
        assert files == sorted(os.listdir(tmp_path / name)), name
        for f in files:
            with open(os.path.join(FIXTURES, name, f), "rb") as a:
                assert a.read() == (tmp_path / name / f).read_bytes(), f


def _code_points(lo=0, hi=0x110000):
    return [chr(c) for c in range(lo, hi) if not 0xD800 <= c <= 0xDFFF]


def _members(ranges):
    return {c for lo, hi in ranges for c in range(lo, hi + 1)}


def test_letter_number_and_whitespace_classes_over_every_code_point():
    """``\\p{L}``, ``\\p{N}`` and ``\\s`` of the ``tokenizers`` regular
    expressions (the engine and classes of the ``ByteLevel``
    pre-tokenizer's pattern), each replaced by its class's letter over
    every code point, are the committed classes."""
    from tokenizers import Regex, normalizers
    text = "".join(_code_points())
    marked = normalizers.Sequence([
        normalizers.Replace(Regex(r"\p{L}"), "L"),
        normalizers.Replace(Regex(r"\p{N}"), "N"),
        normalizers.Replace(Regex(r"\s"), "S")]).normalize_str(text)
    assert len(marked) == len(text)
    for mark, ranges in (("L", hf_unicode_tables.LETTER),
                         ("N", hf_unicode_tables.NUMBER),
                         ("S", hf_unicode_tables.WHITESPACE)):
        want = {ord(c) for c, m in zip(text, marked) if m == mark}
        assert _members(ranges) == want, mark


def test_byte_level_pattern_splits_as_tokenizers_does():
    """GPT-2's pattern with the committed classes splits as the
    ``ByteLevel`` pre-tokenizer does, each code point after a letter and
    before ``!1`` and itself again (so that a code point in a wrong class
    splits otherwise): over the Basic Multilingual Plane, and every code
    point where the classes and Python's ``unicodedata`` disagree."""
    import unicodedata
    letters = _members(hf_unicode_tables.LETTER)
    numbers = _members(hf_unicode_tables.NUMBER)

    def table(c):
        return "L" if c in letters else "N" if c in numbers else ""

    def python(c):
        cat = unicodedata.category(chr(c))[0]
        return cat if cat in "LN" else ""
    other = [chr(c) for c in range(0x10000, 0x110000)
             if table(c) != python(c)]
    assert other
    for chars in (_code_points(0, 0x10000), other):
        text = "".join(f"a{c}!1{c}" for c in chars)
        want = [span for _, span in tokenizers.pre_tokenizers.ByteLevel(
            add_prefix_space=False).pre_tokenize_str(text)]
        assert [m.span() for m in GPT2_PATTERN.finditer(text)] == want


@pytest.mark.parametrize("lo, hi", [
    (lo, min(lo + 0x40000, 0x110000)) for lo in range(0, 0x110000, 0x40000)])
def test_bert_classes_equal_tokenizers_over_every_code_point(lo, hi):
    """``BertNormalizer`` (each option alone) and ``BertPreTokenizer``
    on every code point after a letter: the control, whitespace,
    punctuation and nonspacing-mark classes, the CJK ranges and the
    lowercase and accent-stripping of each character are the
    ``tokenizers`` ones."""
    text = "".join(f"a{c}" for c in _code_points(lo, hi)) + "a"
    for flags in ({"clean_text": True}, {"handle_chinese_chars": True},
                  {"strip_accents": True}, {"lowercase": True}):
        kw = dict(clean_text=False, handle_chinese_chars=False,
                  strip_accents=False, lowercase=False)
        kw.update(flags)
        want = tokenizers.normalizers.BertNormalizer(**kw).normalize_str(
            text)
        assert BertNormalizer(**kw)(text) == want, flags
    want = [w for w, _ in tokenizers.pre_tokenizers.BertPreTokenizer()
            .pre_tokenize_str(text)]
    assert bert_pre_tokenize(text) == want


def test_byte_map_and_whitespace():
    """GPT-2's byte map is transformers' own, and the committed
    whitespace is Rust's (U+0085 in, U+001C out: Python's ``\\s`` has
    both)."""
    spaces = _members(hf_unicode_tables.WHITESPACE)
    assert 0x1c not in spaces and 0x85 in spaces and 0x20 in spaces
    assert bytes_to_unicode() == \
        transformers.models.gpt2.tokenization_gpt2.bytes_to_unicode()


def _edited(tmp_path, fixture, edit):
    """A copy of a ``_fast`` fixture whose tokenizer.json ``edit``
    changed."""
    src, dst = os.path.join(FIXTURES, fixture), tmp_path / fixture
    dst.mkdir()
    for name in os.listdir(src):
        with open(os.path.join(src, name), encoding="utf-8") as f:
            text = f.read()
        if name == "tokenizer.json":
            fast = json.loads(text)
            edit(fast)
            text = json.dumps(fast, ensure_ascii=False)
        (dst / name).write_text(text, encoding="utf-8")
    return str(dst)


def _added(fast, *tokens):
    size = 1 + max([t["id"] for t in fast["added_tokens"]]
                   + list(fast["model"]["vocab"].values()))
    vocab = fast["model"]["vocab"]
    for content, flags in tokens:
        if content not in vocab:
            size += 1
        fast["added_tokens"].append(dict(
            {"id": vocab.get(content, size - 1), "content": content,
             "single_word": False,
             "lstrip": False, "rstrip": False, "normalized": True,
             "special": False}, **flags))


def test_added_token_flags_ignore_merges_and_unknown_bytes(tmp_path):
    """Added tokens with ``single_word``, ``lstrip``, ``rstrip`` and
    ``normalized`` (matched on the normalized text), a BPE with
    ``ignore_merges``, and a BPE vocabulary without some bytes, with and
    without an unknown token: as ``AutoTokenizer``."""
    def bert(fast):
        _added(fast, ("Quick", {}), ("[keep]", {"normalized": False,
                                                "rstrip": True}),
               ("fox", {"single_word": True}))

    def gpt2(fast):
        _added(fast, ("hello", {"single_word": True, "rstrip": True}),
               (" world", {"lstrip": True}))
        fast["model"]["ignore_merges"] = True

    def missing(unk):
        def edit(fast):
            vocab = fast["model"]["vocab"]
            for c in "xzĠ":
                vocab[f"<{c}>"] = vocab.pop(c)
            fast["model"]["merges"] = [
                m for m in fast["model"]["merges"]
                if not set("xzĠ") & set(m if isinstance(m, str) else
                                        "".join(m))]
            fast["model"]["unk_token"] = unk
            if unk:
                vocab[unk] = len(vocab)
        return edit
    lines = TOOL.mixed_lines(150, 77, ["[keep]", "hello", " world"]) + [
        "the Quick brown fox", "afox fox! foxy", "[keep]   x [keep]",
        "hello world", "ahello  hello, world", "sayhello world"]
    for fixture, edit in (("bert_uncased_fast", bert), ("gpt2_fast", gpt2),
                          ("gpt2_fast", missing(None)),
                          ("gpt2_fast", missing("<unk>"))):
        sub = tmp_path / f"case{len(os.listdir(tmp_path))}"
        sub.mkdir()
        path = _edited(sub, fixture, edit)
        ours, theirs = load_tokenizer_dir(path), _auto(path)
        for s in lines:
            tokens = theirs.tokenize(s)
            assert ours.tokenize(s) == tokens, (fixture, s)
            assert ours.convert_tokens_to_ids(tokens) == \
                theirs.convert_tokens_to_ids(tokens), (fixture, s)


def test_huggingface_tokenizer_equals_the_jax_wrapper(goldens):
    from neurst_tpu.data.text.tokenizer import build_tokenizer as jax_build
    for part, g in goldens.items():
        ours = build_tokenizer("huggingface")
        theirs = jax_build({"tokenizer.class": "hf", "tokenizer.params": {}})
        path = os.path.join(FIXTURES, f"{g['fixture']}_slow")
        for tok in (ours, theirs):
            tok.init_subtokenizer(path)
        for s in g["lines"][:150]:
            joined = theirs.tokenize(s, return_str=True)
            assert ours.tokenize(s, return_str=True) == joined
            assert ours.tokenize(s) == theirs.tokenize(s)
            assert ours.detokenize(joined) == theirs.detokenize(joined)


@pytest.mark.parametrize("cls, vocab, fixture", [
    ("BertDataPipeline", "vocab.txt", "bert_uncased_fast"),
    ("BertDataPipeline", "vocab.txt", "bert_cased_slow"),
    ("GPT2DataPipeline", "vocab.json", "gpt2_fast")])
def test_pipelines_equal_the_jax_pipelines(goldens, cls, vocab, fixture):
    from neurst_tpu.data.data_pipelines.data_pipeline import \
        build_data_pipeline as jax_pipeline
    path = os.path.join(FIXTURES, fixture)
    cfg = {"data_pipeline.class": cls, "data_pipeline.params": {
        "vocab_path": os.path.join(path, vocab), "tokenizer_name": path}}
    ours, theirs = build_data_pipeline(cfg), jax_pipeline(cfg)
    assert ours.meta == theirs.meta
    part = "gpt2_bpe" if cls.startswith("GPT2") else "wordpiece_uncased"
    for s in goldens[part]["lines"][:150]:
        ids = theirs.encode(s)
        assert ours.encode(s) == ids, s
        assert ours.decode(ids) == theirs.decode(ids), s
    if cls.startswith("GPT2"):
        assert ours.meta["eos_id"] == ours.vocab.map_token_to_id(
            "<|endoftext|>") == ours.meta["vocab_size"] - 1


def test_an_unsupported_class_raises_and_names_it(tmp_path):
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "T5Tokenizer"}))
    with pytest.raises(NotImplementedError, match="T5Tokenizer"):
        load_tokenizer_dir(str(tmp_path))
    with open(os.path.join(FIXTURES, "bert_cased_fast",
                           "tokenizer.json")) as f:
        fast = json.load(f)
    fast["model"]["type"] = "Unigram"
    other = tmp_path / "unigram"
    other.mkdir()
    (other / "tokenizer.json").write_text(json.dumps(fast))
    with pytest.raises(NotImplementedError, match="Unigram"):
        load_tokenizer_dir(str(other))


@pytest.mark.parametrize("codes", ["bert-base-uncased", "gpt2",
                                   "/no/such/dir"])
def test_a_hub_name_raises(codes):
    tok = build_tokenizer("huggingface")
    with pytest.raises(ValueError, match="not a local directory"):
        tok.init_subtokenizer(codes)


def test_never_split_is_ignored_as_the_fast_tokenizer_does(tmp_path):
    """BERT's slow ``never_split`` does not reach the fast tokenizer
    ``AutoTokenizer`` builds, nor the port's."""
    src = os.path.join(FIXTURES, "bert_uncased_slow")
    for name in os.listdir(src):
        with open(os.path.join(src, name), encoding="utf-8") as f:
            text = f.read()
        if name == "tokenizer_config.json":
            cfg = json.loads(text)
            cfg["never_split"] = ["Hello", "[keep]"]
            text = json.dumps(cfg)
        (tmp_path / name).write_text(text, encoding="utf-8")
    ours, theirs = load_tokenizer_dir(str(tmp_path)), _auto(str(tmp_path))
    for s in ("Hello [keep] world", "HELLO hello", "[keep]"):
        assert ours.tokenize(s) == theirs.tokenize(s)


def test_a_vocab_json_is_read_in_id_order():
    """The slow GPT-2 class saves ``vocab.json`` sorted by token, not by
    id.  The port's pipeline reads it in id order, so its ids are the
    tokenizer's; the JAX pipeline takes the file's order (ROADMAP R17)."""
    from neurst_tpu.data.data_pipelines.data_pipeline import \
        build_data_pipeline as jax_pipeline
    path = os.path.join(FIXTURES, "gpt2_slow")
    with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
        vocab = json.load(f)
    assert list(vocab) != sorted(vocab, key=vocab.get)
    cfg = {"data_pipeline.class": "GPT2DataPipeline",
           "data_pipeline.params": {
               "vocab_path": os.path.join(path, "vocab.json"),
               "tokenizer_name": path}}
    ours, theirs = build_data_pipeline(cfg), jax_pipeline(cfg)
    auto = _auto(path)
    assert ours.meta["eos_id"] == vocab["<|endoftext|>"]
    for s in ("hello world", "the quick brown fox"):
        ids = ours.encode(s)
        assert ids == auto.convert_tokens_to_ids(auto.tokenize(s)) + [
            ours.meta["eos_id"]]
        assert ours.decode(ids) == s
        assert theirs.encode(s) != ids


def test_chip_smoke_gpt2_tokenizer_dir(tmp_path):
    """The GPT-2 directory ``chip_smoke.py``'s ``gpt2_lm`` phase writes
    (here at 600 entries): ``AutoTokenizer`` and the port's ``gpt2``
    pipeline read it alike, <|endoftext|> is the last id and the eos, and
    each line of the phase's corpus is one token a word and its EOS."""
    import numpy as np

    import chip_smoke
    rng = np.random.RandomState(0)
    path = str(tmp_path / "gpt2")
    words = chip_smoke.write_gpt2_tokenizer(path, rng, 600, 40)
    text = chip_smoke.write_mono(str(tmp_path / "lines.txt"), rng, words,
                                 20, 4, 30)
    pipeline = build_data_pipeline({
        "data_pipeline.class": "gpt2", "data_pipeline.params": {
            "vocab_path": os.path.join(path, "vocab.json"),
            "tokenizer_name": path}})
    auto = _auto(path)
    assert pipeline.meta["vocab_size"] == 600
    assert pipeline.meta["eos_id"] == 599 == auto.convert_tokens_to_ids(
        chip_smoke.EOT)
    with open(text) as f:
        lines = f.read().splitlines()
    for line in lines:
        ids = pipeline.encode(line)
        assert ids == auto.convert_tokens_to_ids(auto.tokenize(line)) + [599]
        assert len(ids) == len(line.split()) + 1
        assert pipeline.decode(ids) == line
