"""The port's own Moses against the JAX package's, which calls sacremoses
0.1.1, exactly, on the CPU.

* The data the port carries (``moses_data/``): every Perluniprops class
  as code-point ranges equals sacremoses' character list over every code
  point, the nonbreaking-prefix lists are its files byte for byte, and
  the viramas, nuktas and CJK ranges its lists.
* ``MosesTokenizer`` (``moses``): tokenize and detokenize against the
  JAX tokenizer with every option (``aggressive_dash_splits``,
  ``escape``, glossaries) on seeded punctuation-, digit- and quote-heavy
  lines, on the committed reversal corpus (``tests/examples``) and in a
  derandomized hypothesis run of 300 examples a language (en, the MuST-C
  targets de, es, fr, it, nl, pt, ro, ru, and zh, ja, fi, cs): the same
  text, or the same exception.
* Punctuation normalization against sacremoses' ``MosesPunctNormalizer``,
  and ``lowercase_and_remove_punctuations`` (the ASR transcript
  normalizer) against the JAX function with sacremoses present while the
  port's runs in an interpreter where ``sys.modules["sacremoses"] =
  None`` (a host without sacremoses, as the card is).
"""

import functools
import os
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")
sacremoses = pytest.importorskip("sacremoses")

from neurst_tpu.data.data_pipelines.data_pipeline import \
    lowercase_and_remove_punctuations as jax_normalize  # noqa: E402
from neurst_tpu.data.text.moses import \
    MosesTokenizer as JaxMoses  # noqa: E402
from neurst_tpu_torch.data.text import moses  # noqa: E402
from neurst_tpu_torch.data.text.moses_normalize import \
    normalize_punctuation  # noqa: E402
from neurst_tpu_torch.data.text.tokenizer import build_tokenizer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MUSTC = ("en", "de", "es", "fr", "it", "nl", "pt", "ro", "ru")
LANGUAGES = MUSTC + ("zh", "ja", "fi", "cs")
GLOSSARIES = [r"\d+\.\d+", "e-mail", "U.S."]
# every option the JAX tokenizer takes
OPTIONS = [dict(aggressive_dash_splits=a, escape=e, glossaries=g)
           for a in (False, True) for e in (False, True)
           for g in (None, GLOSSARIES)]
# pieces of text the rules act on: quotes of each kind, dots, dashes,
# apostrophes and contractions, entities, digits with separators,
# nonbreaking prefixes, the cs and fi detokenizer cases, CJK and Indic
# letters, control characters
FRAGMENTS = (list("abcXYZ éüñçøåšț'\"`.,;:!?-()[]{}<>&|@#$%€£/\\0123456789")
             + ["...", "''", "``", "n't", "'s", "'ll", "'re", " ", "  ",
                "Mr.", "No.", "e.g.", "U.S.", "Nr. 5", "5,300", "3.14",
                "1 000", "«", "»", "„", "“", "”", "‘", "’", "–", "—", "…",
                "@-@", "&amp;", "&#124;", "&quot;", "-li", "e-mail",
                "EU:n", "EU:ssa", "中文", "日本語", "カタカナ", "한국어",
                "क्ष", "\t", "\x01", "l'homme", "dell'anno", "¿", "¡",
                "\U0001F600", " ", "ºC", "nº"])


@functools.lru_cache(maxsize=None)
def _tokenizers(lang, k):
    """(the port's, the JAX package's) tokenizer at ``OPTIONS[k]``."""
    opts = OPTIONS[k]
    return (build_tokenizer({"tokenizer.class": "moses",
                             "tokenizer.params": dict(language=lang,
                                                      **opts)}),
            JaxMoses(language=lang, **opts))


def _outcome(fn, *args):
    """The result of ``fn(*args)``, or the type of what it raised."""
    try:
        return fn(*args)
    except Exception as e:  # both sides must raise alike
        return type(e)


def _seeded_lines(seed, n=40):
    rng = np.random.RandomState(seed)
    return ["".join(FRAGMENTS[int(i)] for i in rng.randint(
        len(FRAGMENTS), size=int(rng.randint(0, 40)))) for _ in range(n)]


def _reversal_corpus():
    with open(os.path.join(REPO, "tests", "examples", "train.src")) as f:
        return f.read().splitlines()[:40]


def _check(lang, text, k):
    ours, ref = _tokenizers(lang, k)
    want = _outcome(ref.tokenize, text, False)
    assert _outcome(ours.tokenize, text, False) == want, (lang, text, k)
    # the JAX wrapper's string is its list joined by spaces
    tokens = " ".join(want)
    assert _outcome(ours.tokenize, text, True) == tokens, (lang, text, k)
    for detok_in in (tokens, text):
        assert _outcome(ours.detokenize, detok_in) == \
            _outcome(ref.detokenize, detok_in), (lang, detok_in)


# ------------------------------------------------------------ the data

def test_perluniprops_ranges_equal_sacremoses_classes():
    from sacremoses.corpus import Perluniprops
    pup = Perluniprops()
    names = sorted(moses._tables())
    assert {"IsN", "IsAlnum", "IsSc", "IsSo", "IsAlpha", "IsLower",
            "IsUpper", "IsPi", "IsPf", "CJK", "Han", "Hangul", "Hiragana",
            "Katakana"} <= set(names)
    for name in names:
        want = set(map(ord, pup.chars(name)))
        got = set()
        for lo, hi in moses.char_ranges(name):
            assert lo <= hi
            got.update(range(lo, hi + 1))
        assert got == want, name


@pytest.mark.parametrize("name", ["IsN", "IsAlnum", "IsSc", "IsSo",
                                  "IsAlpha", "IsLower", "Han", "Hangul",
                                  "Hiragana", "Katakana"])
def test_classes_the_port_reads_hold_no_regex_class_syntax(name):
    """sacremoses pastes these lists into character classes: they must
    hold no character that reads otherwise there."""
    from sacremoses.corpus import Perluniprops
    assert not set("\\][^-") & set(Perluniprops().chars(name))


def test_nonbreaking_prefix_lists_are_sacremoses_files():
    src = os.path.join(os.path.dirname(sacremoses.__file__), "data",
                       "nonbreaking_prefixes")
    ours = os.path.join(os.path.dirname(moses.__file__), "moses_data",
                        "nonbreaking_prefixes")
    assert sorted(os.listdir(src)) == sorted(os.listdir(ours))
    for name in os.listdir(src):
        with open(os.path.join(src, name), "rb") as a, \
                open(os.path.join(ours, name), "rb") as b:
            assert a.read() == b.read(), name


def test_indic_and_cjk_lists_equal_sacremoses():
    from sacremoses.indic import NUKTAS, VIRAMAS
    from sacremoses.util import CJKChars, is_cjk
    assert [chr(c) for c in moses.VIRAMAS] == VIRAMAS
    assert [chr(c) for c in moses.NUKTAS] == NUKTAS
    assert list(moses.CJK_RANGES) == CJKChars().ranges
    for start, end in CJKChars().ranges:
        for cp in (start - 1, start, start + 1, end - 1, end, end + 1):
            assert moses.is_cjk(chr(cp)) == is_cjk(chr(cp))


@pytest.mark.parametrize("lang", LANGUAGES + ("xx", "german"))
def test_prefix_lists_by_language(lang):
    tok = (_tokenizers(lang, 0)[1]._tok if lang in LANGUAGES
           else sacremoses.MosesTokenizer(lang=lang))
    prefixes, numeric = moses._prefixes(lang)
    assert prefixes == set(tok.NONBREAKING_PREFIXES)
    assert numeric == set(tok.NUMERIC_ONLY_PREFIXES)


# ------------------------------------------------ tokenize / detokenize

@pytest.mark.parametrize("lang", LANGUAGES)
def test_seeded_lines_and_reversal_corpus_every_option(lang):
    lines = _seeded_lines(LANGUAGES.index(lang)) + _reversal_corpus()
    for i, text in enumerate(lines):
        _check(lang, text, i % len(OPTIONS))


@pytest.mark.parametrize("lang", LANGUAGES)
def test_hypothesis_lines(lang):
    @settings(max_examples=300, derandomize=True, deadline=None,
              database=None, suppress_health_check=list(HealthCheck))
    @given(st.lists(st.sampled_from(FRAGMENTS), max_size=30).map("".join),
           st.sampled_from(range(len(OPTIONS))))
    def run(text, k):
        _check(lang, text, k)
    run()


@pytest.mark.parametrize("text,want", [
    ("It's a well-known e-mail.", "It &apos;s a well @-@ known e @-@ mail ."),
    ("5,300 $20 (a) [b]", "5,300 $ 20 ( a ) &#91; b &#93;"),
    ("Mr. Smith went... home.", "Mr. Smith went ... home .")])
def test_english_cases_by_hand(text, want):
    tok = _tokenizers("en", OPTIONS.index(dict(
        aggressive_dash_splits=True, escape=True, glossaries=None)))[0]
    assert tok.tokenize(text, return_str=True) == want


def test_czech_dashed_word_raises_as_sacremoses_does():
    """sacremoses 0.1.1's cs detokenizer calls ``next()`` on its token
    list for "<contraction> - li": a TypeError, kept by the port."""
    tokens = ["ab'", "-", "li"]
    with pytest.raises(TypeError):
        sacremoses.MosesDetokenizer(lang="cs").detokenize(tokens)
    with pytest.raises(TypeError):
        moses.moses_detokenize(tokens, "cs")


# ------------------------------------------------------- normalization

@pytest.mark.parametrize("lang", MUSTC + ("cs", "cz", "zh"))
def test_normalizer_substitutions_are_sacremoses(lang):
    from neurst_tpu_torch.data.text.moses_normalize import _substitutions
    assert [(r.pattern, sub) for r, sub in _substitutions(lang)] == list(
        sacremoses.MosesPunctNormalizer(lang=lang).substitutions)


@pytest.mark.parametrize("lang", MUSTC + ("cs", "zh"))
def test_punctuation_normalizer(lang):
    ref = sacremoses.MosesPunctNormalizer(lang=lang)
    for text in _seeded_lines(100 + len(lang), 60):
        assert normalize_punctuation(text, lang) == ref.normalize(text)


# the port's transcript normalizer in a fresh interpreter where
# sacremoses cannot be imported; prints its outputs as JSON
BLOCKED = r"""
import json, sys
sys.modules["sacremoses"] = None
sys.path.insert(0, sys.argv[1])
from neurst_tpu_torch.data.data_pipelines.data_pipeline import (
    lowercase_and_remove_punctuations)
cases = json.load(sys.stdin)
print(json.dumps([lowercase_and_remove_punctuations(*c) for c in cases]))
"""
NORMALIZER_FLAGS = [(True, True), (False, False), (True, False)]


def _transcript_cases():
    lines = ["Hello „World“ – it' s 5\u00a0% «quoted» ``so'' …",
             "L’homme a dit\u00a0: « Non ! »"]
    return [(lang, s, lc, rp) for lang in MUSTC + ("zh", "ja")
            for i, s in enumerate(_seeded_lines(200 + len(lang), 20)
                                  + lines)
            for lc, rp in [NORMALIZER_FLAGS[i % 3]]]


def test_transcript_normalizer_without_sacremoses():
    """The port's ``lowercase_and_remove_punctuations``, where sacremoses
    cannot be imported, equals the JAX function with it (a normalizer
    that catches the ImportError returns the text without Moses
    normalization there)."""
    import json
    import subprocess
    cases = _transcript_cases()
    proc = subprocess.run([sys.executable, "-c", BLOCKED, REPO],
                          input=json.dumps(cases), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    want = [jax_normalize(*c) for c in cases]
    assert got == want
    assert sum(g != " ".join(c[1].split()) for g, c in zip(got, cases)) \
        > len(cases) // 2
