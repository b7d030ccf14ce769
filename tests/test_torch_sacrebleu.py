"""The port's own SacreBLEU (``metrics/sacrebleu_port.py``) and its
``sacre_bleu`` / ``uncased_bleu`` metrics against the JAX package's, which
call sacrebleu 2.6.0, within 1e-9, on the CPU.

* ``corpus_bleu`` (the ``13a`` and ``zh`` tokenizers, cased and
  lowercased) and ``corpus_chrf`` against sacrebleu on seeded corpora:
  one and several reference streams, empty hypotheses, a hypothesis equal
  to its reference, none that matches; the two tokenizers line by line,
  sacrebleu's ``zh`` ranges (two of them, written as five-digit ``\\u``
  escapes, read as shorter ranges) included.
* ``SacreBLEU`` and ``UncasedBLEU`` as metrics against the JAX metrics:
  references as one stream and as lists a sample, zh, and ja (13a on both
  sides: the JAX metric's MeCab tokenizer is missing, so it falls back).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
sacrebleu = pytest.importorskip("sacrebleu")

from neurst_tpu.metrics.metric import \
    build_metric as jax_build_metric  # noqa: E402
from neurst_tpu_torch.metrics import sacrebleu_port  # noqa: E402
from neurst_tpu_torch.metrics.metric import build_metric  # noqa: E402

TOL = 1e-9
WORDS = ("the a cat dog sat on mat . , ! ? Hello world It's don't 3.5 "
         "5,300 - -- ( x ) &amp; &quot; &lt; e-mail l'homme ü ß").split()
# Chinese characters, and the ends of sacrebleu's zh ranges as it reads
# them (U+2001..U+2A6D and U+2F81..U+2FA1 among them)
ZH = list("我们的世界科学今天人们这是一个演讲中文字") + [
    "\u2000", "\u2001", "\u2a6d", "\u2a6e", "\u2f80", "\u2f81",
    "\u2fa1", "\u2fa2", "\uff01", "\u3000", "\u2e80", "\u2600",
    "\u27bf"]


def _sentence(rng, words, lo=0, hi=16):
    n = int(rng.randint(lo, hi))
    return " ".join(words[int(i)] for i in rng.randint(len(words), size=n))


def _corpus(seed, n, streams, words=WORDS):
    rng = np.random.RandomState(seed)
    refs = [[_sentence(rng, words, 1) for _ in range(n)]
            for _ in range(streams)]
    hyps = []
    for i in range(n):
        kind = i % 5
        if kind == 0:
            hyps.append(refs[0][i])
        elif kind == 1:
            hyps.append("")
        else:
            hyps.append(_sentence(rng, words))
    return hyps, refs


CASES = [(seed, n, streams) for seed, (n, streams) in enumerate(
    [(1, 1), (7, 1), (20, 1), (20, 2), (33, 3), (5, 4)])]


@pytest.mark.parametrize("seed,n,streams", CASES)
@pytest.mark.parametrize("tokenize", ["13a", "zh"])
def test_corpus_bleu_and_chrf_match_sacrebleu(seed, n, streams, tokenize):
    words = WORDS + ZH if tokenize == "zh" else WORDS
    hyps, refs = _corpus(seed, n, streams, words)
    for lowercase in (False, True):
        want = sacrebleu.corpus_bleu(hyps, refs, tokenize=tokenize,
                                     lowercase=lowercase).score
        got = sacrebleu_port.corpus_bleu(hyps, refs, tokenize=tokenize,
                                         lowercase=lowercase)
        assert abs(got - want) <= TOL, (lowercase, got, want)
    want = sacrebleu.corpus_chrf(hyps, refs).score
    assert abs(sacrebleu_port.corpus_chrf(hyps, refs) - want) <= TOL


def test_no_match_and_all_empty():
    for hyps, refs in ((["a b c"], [["x y z"]]), ([""], [["x y"]]),
                       (["", ""], [["", "a"]])):
        assert sacrebleu_port.corpus_bleu(hyps, refs) == \
            sacrebleu.corpus_bleu(hyps, refs).score
        assert abs(sacrebleu_port.corpus_chrf(hyps, refs)
                   - sacrebleu.corpus_chrf(hyps, refs).score) <= TOL


@pytest.mark.parametrize("name", ["13a", "zh"])
def test_tokenizers_line_by_line(name):
    from sacrebleu.tokenizers.tokenizer_13a import Tokenizer13a
    from sacrebleu.tokenizers.tokenizer_zh import TokenizerZh
    ref = {"13a": Tokenizer13a, "zh": TokenizerZh}[name]()
    ours = {"13a": sacrebleu_port.tokenize_13a,
            "zh": sacrebleu_port.tokenize_zh}[name]
    rng = np.random.RandomState(3)
    chars = list("ab1.,-&;<>?!\"' \n") + ["&quot;", "&amp;", "<skipped>",
                                         "-\n"] + ZH
    for _ in range(300):
        line = "".join(chars[int(i)] for i in rng.randint(
            len(chars), size=int(rng.randint(0, 30))))
        assert ours(line) == ref(line), repr(line)


def _metric(build, cls, language):
    return build({"metric.class": cls,
                  "metric.params": {"language": language}})


@pytest.mark.parametrize("language", ["en", "de", "zh", "ja"])
@pytest.mark.parametrize("streams", [1, 3])
def test_sacre_bleu_metric_matches_jax(language, streams):
    words = WORDS + ZH if language == "zh" else WORDS
    hyps, refs = _corpus(10 + streams, 24, streams, words)
    # one stream as a list of strings, several as a list a sample
    groundtruth = refs[0] if streams == 1 else [list(r) for r in
                                                zip(*refs)]
    for cls in ("sacre_bleu", "sacrebleu"):
        ours = _metric(build_metric, cls, language)
        ref = _metric(jax_build_metric, cls, language)
        got, want = ours(hyps, groundtruth), ref(hyps, groundtruth)
        assert sorted(got) == sorted(want) == [
            "ChrF", "SacreBLEU", "UncasedSacreBLEU"]
        for key in want:
            assert abs(got[key] - want[key]) <= TOL, (key, got, want)
        assert ours.flag == ref.flag == "SacreBLEU"


@pytest.mark.parametrize("language", ["en", "zh"])
def test_uncased_bleu_metric_matches_jax(language):
    hyps, refs = _corpus(4, 30, 2, WORDS + ZH if language == "zh"
                         else WORDS)
    hyps = [h.upper() if i % 3 else h for i, h in enumerate(hyps)]
    groundtruth = [list(r) for r in zip(*refs)]
    ours = _metric(build_metric, "uncased_bleu", language)
    ref = _metric(jax_build_metric, "uncased_bleu", language)
    got, want = ours(hyps, groundtruth), ref(hyps, groundtruth)
    assert ours.flag == ref.flag == "UncasedBLEU"
    assert got.keys() == want.keys()
    for key in want:
        assert abs(got[key] - want[key]) <= TOL
    assert got["UncasedBLEU"] > got["BLEU"]
    assert ours.greater_or_eq(got, want) and ref.greater_or_eq(want, got)
