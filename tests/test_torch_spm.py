"""The port's own SentencePiece (``spm``): the ``.model`` reader
(``utils/sentencepiece_model.py``), the charsmap and normalizer
(``data/text/spm_normalizer.py``) and the encoder / decoder
(``data/text/spm.py``), on the CPU, with no ``sentencepiece`` package.

The fixtures (``tests/fixtures/spm``, ``tests/tools/make_spm_fixture.py``)
are unigram and BPE models with the ``identity`` rule or a charsmap the
tool builds, user-defined pieces and byte fallback.  The oracle is the
SentencePiece implementation of the ``tokenizers`` package, converted
from the same files by transformers' ``SpmConverter``
(``tests/tools/make_text_goldens.py``: ``hf_spm``, ``hf_pieces``,
``hf_decoder``), and protobuf for the reader.

* The reader against protobuf's parse: every piece, score and type, the
  trainer and normalizer specs; proto2 defaults for absent fields and
  unknown fields of every wire type skipped.
* The charsmap reader against ``tokenizers.normalizers.Precompiled`` on
  the same bytes.
* Pieces and decodes against the oracle, exactly, on the fixture corpus
  and seeded mixed lines.
* Where ``tokenizers`` departs from SentencePiece, a hand-written case
  holds the port to SentencePiece (the ``test_departure_*`` cases, each
  naming the difference and showing both sides).
* The ``spm`` tokenizer's interface, the multilingual pipeline's default
  tokenizer, and ``thai``: the JAX ``spm`` and ``thai`` raise
  ``ImportError`` on this host (no sentencepiece, no pythainlp), and the
  port's ``thai`` does too.
"""

import importlib.util
import os

import pytest

jax = pytest.importorskip("jax")
pb = pytest.importorskip("transformers.utils.sentencepiece_model_pb2_new")
tokenizers = pytest.importorskip("tokenizers")

from neurst_tpu_torch.data.text import spm as port_spm  # noqa: E402
from neurst_tpu_torch.data.text.spm_normalizer import (  # noqa: E402
    CharsMap, Normalizer)
from neurst_tpu_torch.data.text.tokenizer import build_tokenizer  # noqa: E402
from neurst_tpu_torch.utils import sentencepiece_model as spmodel  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "spm")
MODELS = ("unigram", "unigram_nfkc", "unigram_bytes", "bpe", "bpe_bytes")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tests", "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


GOLDENS = _tool("make_text_goldens")
FIXTURE = _tool("make_spm_fixture")


def _path(name):
    return os.path.join(FIXTURES, f"{name}.model")


def _proto(name):
    m = pb.ModelProto()
    with open(_path(name), "rb") as f:
        m.ParseFromString(f.read())
    return m


def _processor(data):
    return port_spm.SentencePieceProcessor(spmodel.read_model(data))


# ------------------------------------------------------------ the reader

@pytest.mark.parametrize("name", MODELS)
def test_reader_matches_protobuf(name):
    proto, model = _proto(name), spmodel.read_model(_path(name))
    assert [(p.piece, p.score, p.type) for p in model.pieces] == [
        (p.piece, p.score, p.type) for p in proto.pieces]
    ts, ns = proto.trainer_spec, proto.normalizer_spec
    for field in ("model_type", "unk_id", "bos_id", "eos_id", "pad_id",
                  "unk_piece", "bos_piece", "eos_piece", "pad_piece",
                  "unk_surface", "byte_fallback",
                  "treat_whitespace_as_suffix"):
        assert getattr(model, field) == getattr(ts, field), field
    for field in ("name", "precompiled_charsmap", "add_dummy_prefix",
                  "remove_extra_whitespaces", "escape_whitespaces"):
        assert getattr(model.normalizer_spec, field) == getattr(ns, field)
    assert model.denormalizer_spec is None
    assert model.pad_id == -1


def _varint(v):
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        out.append((v & 0x7F) | (0x80 if v > 0x7F else 0))
        v >>= 7
        if not v:
            return bytes(out)


def _unknown_fields():
    """A field of each wire type the reader does not know: varint,
    fixed64, length-delimited, a group with a field inside, fixed32."""
    return (_varint(90 << 3 | 0) + _varint(300)
            + _varint(91 << 3 | 1) + b"\x01" * 8
            + _varint(92 << 3 | 2) + _varint(3) + b"abc"
            + _varint(93 << 3 | 3) + _varint(1 << 3 | 0) + _varint(7)
            + _varint(93 << 3 | 4)
            + _varint(94 << 3 | 5) + b"\x02" * 4)


def test_reader_defaults_and_unknown_fields():
    m = pb.ModelProto()
    for piece, t in (("<unk>", 2), ("a", 1), ("▁a", 1)):
        sp = m.pieces.add()
        sp.piece, sp.type = piece, t
    m.pieces[1].score = -1.5
    m.normalizer_spec.remove_extra_whitespaces = False
    m.denormalizer_spec.name = "denorm"
    trainer = pb.TrainerSpec(pad_id=-1, bos_id=-1, byte_fallback=False)
    data = (m.SerializeToString() + _unknown_fields()
            + _varint(2 << 3 | 2)
            + _varint(len(trainer.SerializeToString()
                          + _unknown_fields()))
            + trainer.SerializeToString() + _unknown_fields())
    check = pb.ModelProto()
    check.ParseFromString(data)
    assert check.trainer_spec.bos_id == -1
    model = spmodel.read_model(data)
    assert [(p.piece, p.score, p.type) for p in model.pieces] == [
        ("<unk>", 0.0, 2), ("a", -1.5, 1), ("▁a", 0.0, 1)]
    assert (model.model_type, model.unk_id, model.bos_id, model.eos_id,
            model.pad_id) == (1, 0, -1, 2, -1)
    assert model.unk_surface == " ⁇ " and model.unk_piece == "<unk>"
    ns = model.normalizer_spec
    assert (ns.add_dummy_prefix, ns.remove_extra_whitespaces,
            ns.escape_whitespaces) == (True, False, True)
    assert model.denormalizer_spec.name == "denorm"
    assert not model.denormalizer_spec.precompiled_charsmap
    with pytest.raises(ValueError):
        spmodel.read_model(data[:-3] + _varint(2 << 3 | 2) + _varint(50))


# ---------------------------------------------------------- the charsmap

def test_charsmap_reader_matches_tokenizers_precompiled():
    import numpy as np
    from tokenizers import normalizers
    with open(os.path.join(FIXTURES, "charsmap.bin"), "rb") as f:
        blob = f.read()
    charsmap, ref = CharsMap(blob), normalizers.Precompiled(blob)

    def ours(text):
        data, out, pos = text.encode("utf-8"), b"", 0
        while pos < len(data):
            match = charsmap.longest_match(data, pos)
            n = match[1] if match else len(text[len(
                data[:pos].decode("utf-8"))].encode("utf-8"))
            out += match[0] if match else data[pos:pos + n]
            pos += n
        return out.decode("utf-8")
    keys = sorted(FIXTURE.CHARSMAP)
    for key in keys:
        assert ours(key) == ref.normalize_str(key) == FIXTURE.CHARSMAP[key]
    rng = np.random.RandomState(2)
    alphabet = keys + list("abcxyz ÅåéΩ日")
    for _ in range(300):
        text = "".join(alphabet[int(i)] for i in rng.randint(
            len(alphabet), size=int(rng.randint(0, 25))))
        assert ours(text) == ref.normalize_str(text), repr(text)
    assert not CharsMap(b"") and CharsMap(b"").longest_match(b"a") is None
    with pytest.raises(ValueError):
        CharsMap(blob[:10])


# ------------------------------------------------- against the oracle

@pytest.fixture(scope="module")
def oracles():
    return {name: GOLDENS.hf_spm(_path(name)) for name in MODELS}


@pytest.mark.parametrize("name", MODELS)
def test_pieces_and_decode_match_tokenizers(oracles, name):
    tokenizer, proto = oracles[name]
    sp = _processor(_path(name))
    decoder = GOLDENS.hf_decoder()
    lines = GOLDENS.spm_lines(seed=23, n=200)
    unknown = 0
    for text in lines:
        want = GOLDENS.hf_pieces(tokenizer, proto, text)
        assert sp.encode_as_pieces(text) == want, repr(text)
        assert sp.decode_pieces(want) == decoder.decode(want), want
        unknown += any(sp.piece_to_id(p) == 0 or p.startswith("<0x")
                       for p in want)
    assert unknown > 10  # the lines meet unknown characters


# -------------------------------------------- where tokenizers departs

def _normalized(name, text, **spec):
    model = spmodel.read_model(_path(name))
    for k, v in spec.items():
        setattr(model.normalizer_spec, k, v)
    user = [p.piece for p in model.pieces if p.type == spmodel.USER_DEFINED]
    return Normalizer(model.normalizer_spec, user).normalize(text).decode()


def test_departure_charsmap_key_before_a_combining_mark(oracles):
    """tokenizers applies the shortest key that prefixes a grapheme to the
    whole grapheme (dropping the mark); SentencePiece maps the longest key
    at each byte and keeps the mark."""
    text = "Ｖ́x"
    assert _normalized("unigram_nfkc", text) == "▁V́x"
    tokenizer, _ = oracles["unigram_nfkc"]
    assert tokenizer.normalizer.normalize_str(text) == "Vx"


def test_departure_trailing_whitespace_other_than_space(oracles):
    """SentencePiece's ``remove_extra_whitespaces`` strips spaces only (a
    tab is a character, unknown here); tokenizers strips any trailing
    whitespace."""
    sp = _processor(_path("unigram"))
    assert sp.encode_as_pieces("ab\t")[-1].endswith("\t")
    tokenizer, proto = oracles["unigram"]
    assert not GOLDENS.hf_pieces(tokenizer, proto, "ab\t")[-1].endswith(
        "\t")


def test_departure_literal_space_symbol_at_the_ends(oracles):
    """SentencePiece adds its dummy ``▁`` before a text that starts with a
    literal ``▁`` and strips a trailing one as a space; tokenizers does
    neither."""
    assert _normalized("unigram", "▁ab") == "▁▁ab"
    assert _normalized("unigram", "ab▁▁") == "▁ab"
    tokenizer, _ = oracles["unigram"]
    words = tokenizer.pre_tokenizer.pre_tokenize_str(
        tokenizer.normalizer.normalize_str("▁ab"))
    assert "".join(w for w, _ in words) == "▁ab"


def test_departure_decode_leading_space_pieces():
    """With ``remove_extra_whitespaces`` SentencePiece 0.2.0 drops the
    leading ``▁`` of every piece until the text is not empty;
    tokenizers's decoder drops one space."""
    sp = _processor(_path("unigram"))
    assert sp.decode_pieces(["▁", "▁ab", "▁c"]) == "ab c"
    assert GOLDENS.hf_decoder().decode(["▁", "▁ab", "▁c"]) == " ab c"


def test_departure_decode_unknown_and_invalid_bytes():
    """``<unk>`` decodes to the model's unknown surface (`` ⁇ ``); an
    invalid UTF-8 byte run to one U+FFFD a byte, the valid characters
    after it kept (tokenizers replaces every byte of the run)."""
    sp = _processor(_path("unigram_bytes"))
    assert sp.decode_pieces(["<unk>", "▁a"]) == " ⁇  a"
    assert sp.decode_pieces(["▁a", "<0xE6>", "<0x97>", "<0x41>"]) == \
        "a��A"
    assert GOLDENS.hf_decoder().decode(["▁a", "<0xE6>", "<0x97>",
                                        "<0x41>"]) == "a���"


@pytest.mark.parametrize("name", ["unigram", "bpe"])
def test_departure_user_defined_pieces_inside_text(oracles, name):
    """A user-defined piece passes the normalizer whole and is one piece,
    in the middle of the normalized text; tokenizers splits it out before
    normalizing and starts the text after it with a dummy ``▁``."""
    sp = _processor(_path(name))
    pieces = sp.encode_as_pieces("ab<sep>cd")
    assert "<sep>" in pieces and "".join(pieces) == "▁ab<sep>cd"
    tokenizer, _ = oracles[name]
    tokens = tokenizer.encode("ab<sep>cd", add_special_tokens=False).tokens
    assert "<sep>" in tokens and tokens[tokens.index("<sep>") + 1] \
        .startswith("▁")


def test_user_defined_bonus_in_unigram():
    """A user-defined piece inside a word wins the Viterbi path (its
    score is ``length x max(score, FLT_MIN) - 0.1``)."""
    sp = _processor(_path("unigram"))
    assert "@@" in sp.encode_as_pieces("the@@them")


@pytest.mark.parametrize("spec,text,want", [
    ({"remove_extra_whitespaces": False}, "  a  b ", "▁▁▁a▁▁b▁"),
    ({"add_dummy_prefix": False}, "  a  b ", "a▁b"),
    ({"escape_whitespaces": False}, " a  b", " a b"),
    ({}, "   ", ""), ({}, "", "")])
def test_whitespace_options_by_hand(spec, text, want):
    assert _normalized("unigram", text, **spec) == want


def _model_bytes(name, **trainer):
    m = _proto(name)
    for k, v in trainer.items():
        setattr(m.trainer_spec, k, v)
    return m.SerializeToString()


def test_word_and_char_models_by_hand():
    word = _processor(_model_bytes("unigram", model_type=3))
    assert word.encode_as_pieces("the  thezz the") == [
        "▁the", "▁thezz", "▁the"]
    assert word.piece_to_id("▁thezz") == 0
    char = _processor(_model_bytes("unigram", model_type=4))
    assert char.encode_as_pieces("ab qz") == ["▁", "a", "b", "▁", "qz"]


def test_control_pieces_vanish_and_bad_models_raise():
    sp = _processor(_path("bpe"))
    pieces = sp.encode_as_pieces("the cat")
    assert sp.decode_pieces(["<s>"] + pieces + ["</s>"]) == "the cat"
    # a piece not in the vocabulary decodes as it is, ``▁`` and all
    assert sp.decode_pieces(["▁the", "▁zz"]) == "the▁zz"
    with pytest.raises(NotImplementedError):
        _processor(_model_bytes("unigram", treat_whitespace_as_suffix=True))
    m = _proto("unigram")
    m.pieces[0].type = 1
    with pytest.raises(ValueError, match="unk"):
        _processor(m.SerializeToString())
    m = _proto("unigram_bytes")
    del m.pieces[10]
    with pytest.raises(ValueError, match="256 byte pieces"):
        _processor(m.SerializeToString())


# -------------------------------------------------- the tokenizer and thai

def test_spm_tokenizer_interface():
    for name in ("spm", "sentencepiece", "SentencePieceTokenizer"):
        tok = build_tokenizer({"tokenizer.class": name})
        with pytest.raises(ValueError, match="not initialized"):
            tok.tokenize("a")
        tok.init_subtokenizer(_path("unigram_nfkc"))
        pieces = tok.tokenize("ｔｈｅ world")
        assert pieces[0] == "▁the" and isinstance(pieces, list)
        assert tok.tokenize("ｔｈｅ world", return_str=True) == \
            " ".join(pieces)
        assert tok.detokenize(" ".join(pieces)) == "the world"
        assert tok.detokenize(pieces, return_str=False) == ["the", "world"]


def test_multilingual_pipeline_with_an_spm_model(tmp_path):
    from neurst_tpu_torch.data.data_pipelines.multilingual_text_data_pipeline \
        import MultilingualTextDataPipeline
    model = spmodel.read_model(_path("unigram"))
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(p.piece for p in model.pieces) + "\n")
    pipe = MultilingualTextDataPipeline(
        vocab_path=str(vocab), languages=["en", "de"],
        spm_model=_path("unigram"))
    ids = pipe.encode("the world")
    assert ids[-1] == pipe.meta["eos_id"] and len(ids) > 2
    assert pipe.decode(ids) == "the world"


def test_text_pipeline_with_an_spm_subtokenizer(tmp_path):
    """The CTNMT and GigaSpeech recipes' form: ``subtokenizer: spm``
    over a ``.model``, the vocabulary SentencePiece's ``.vocab`` (piece,
    tab, score)."""
    from neurst_tpu_torch.data.data_pipelines.text_data_pipeline import \
        TextDataPipeline
    model = spmodel.read_model(_path("bpe"))
    vocab = tmp_path / "spm.vocab"
    vocab.write_text("".join(f"{p.piece}\t{p.score}\n"
                             for p in model.pieces))
    pipe = TextDataPipeline(vocab_path=str(vocab), subtokenizer="spm",
                            subtokenizer_codes=_path("bpe"))
    ids = pipe.encode("the world")
    sp = _processor(_path("bpe"))
    assert ids[:-1] == [sp.piece_to_id(p) for p in
                        sp.encode_as_pieces("the world")]
    assert pipe.decode(ids) == "the world"


def test_jax_spm_and_thai_raise_without_their_packages():
    from neurst_tpu.data.text.spm import SentencePieceTokenizer
    from neurst_tpu.data.text.thai import ThaiTokenizer
    from neurst_tpu_torch.data.text.thai import ThaiTokenizer as PortThai
    for cls in (SentencePieceTokenizer, ThaiTokenizer, PortThai):
        with pytest.raises(ImportError):
            cls()
    with pytest.raises(ImportError, match="pythainlp"):
        build_tokenizer({"tokenizer.class": "thai"})
