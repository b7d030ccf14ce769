"""BLEU metrics (the port's copy of ``neurst_tpu/metrics/bleu.py``).

* ``BLEU``: tokenized corpus BLEU, mteval-v13a-style tokenization,
  character-level for CJK and Thai, cased and uncased values.
* ``UncasedBLEU``: the same values, the case-insensitive one primary.
* ``SacreBLEU``: detokenized BLEU, its lowercased value and chrF through
  the port's own sacrebleu (``metrics/sacrebleu_port.py``).
"""

import math
import re
from collections import Counter
from typing import List

from neurst_tpu_torch.metrics import sacrebleu_port
from neurst_tpu_torch.metrics.metric import Metric, register_metric
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["BLEU", "UncasedBLEU", "SacreBLEU", "corpus_bleu",
           "bleu_tokenize"]


def _is_cjk(ch):
    code = ord(ch)
    return (0x4E00 <= code <= 0x9FFF or 0x3400 <= code <= 0x4DBF
            or 0xF900 <= code <= 0xFAFF or 0x3040 <= code <= 0x30FF)


def bleu_tokenize(text: str, language: str = "en") -> List[str]:
    """mteval-v13a-style tokenization; character-level for CJK/Thai."""
    if language in ("zh", "ja", "ko", "th"):
        out = []
        for ch in text:
            if ch.strip() == "":
                continue
            out.append(ch)
        return out
    text = re.sub(r"<skipped>", "", text)
    text = re.sub(r"-\n", "", text)
    text = re.sub(r"\n", " ", text)
    text = re.sub(r"&quot;", '"', text)
    text = re.sub(r"&amp;", "&", text)
    text = re.sub(r"&lt;", "<", text)
    text = re.sub(r"&gt;", ">", text)
    # mteval pads the line with spaces so the [^0-9] context rules
    # also fire at the line boundaries (e.g. a sentence-final period
    # after a digit: "int8." -> "int8 .")
    text = f" {text} "
    text = re.sub(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])", r" \1 ", text)
    text = re.sub(r"([^0-9])([\.,])", r"\1 \2 ", text)
    text = re.sub(r"([\.,])([^0-9])", r" \1 \2", text)
    text = re.sub(r"([0-9])(-)", r"\1 \2 ", text)
    return text.strip().split()


def _ngrams(tokens: List[str], max_order: int = 4) -> Counter:
    counts = Counter()
    for order in range(1, max_order + 1):
        for i in range(len(tokens) - order + 1):
            counts[tuple(tokens[i:i + order])] += 1
    return counts


def corpus_bleu(hypotheses: List[List[str]], references: List[List[List[str]]],
                max_order: int = 4, smooth: bool = False) -> float:
    """Corpus BLEU over pre-tokenized hypothesis/reference token lists.

    ``references[i]`` is a list of reference token lists for sample i.
    """
    matches = [0] * max_order
    possible = [0] * max_order
    hyp_len, ref_len = 0, 0
    for hyp, refs in zip(hypotheses, references):
        hyp_len += len(hyp)
        ref_len += min((len(r) for r in refs),
                       key=lambda l: (abs(l - len(hyp)), l))
        hyp_ngrams = _ngrams(hyp, max_order)
        ref_ngrams = Counter()
        for r in refs:
            for ng, c in _ngrams(r, max_order).items():
                ref_ngrams[ng] = max(ref_ngrams[ng], c)
        for ng, c in hyp_ngrams.items():
            order = len(ng)
            possible[order - 1] += c
            matches[order - 1] += min(c, ref_ngrams.get(ng, 0))
    precisions = []
    for o in range(max_order):
        if smooth:
            p = (matches[o] + 1.0) / (possible[o] + 1.0)
        elif possible[o] > 0:
            p = matches[o] / possible[o]
        else:
            p = 0.0
        precisions.append(p)
    if min(precisions) > 0:
        geo_mean = math.exp(
            sum(math.log(p) for p in precisions) / max_order)
    else:
        geo_mean = 0.0
    if hyp_len == 0:
        return 0.0
    ratio = hyp_len / max(ref_len, 1)
    bp = 1.0 if ratio > 1.0 else math.exp(1.0 - 1.0 / max(ratio, 1e-9))
    return geo_mean * bp * 100.0


@register_metric("bleu")
class BLEU(Metric):
    """Tokenized BLEU (case-sensitive primary, also reports uncased)."""

    def __init__(self, args=None, language="en"):
        super().__init__(args)
        self._language = self._args.get("language") or language
        self._flag = "BLEU"

    @staticmethod
    def class_or_method_args():
        return [Flag("language", dtype=Flag.TYPE.STRING, default="en",
                     help="The target language (char-level for CJK/Thai).")]

    def call(self, hypothesis, groundtruth) -> dict:
        refs = groundtruth
        if refs and not isinstance(refs[0], (list, tuple)):
            refs = [[r] for r in refs]
        hyp_tok = [bleu_tokenize(h, self._language) for h in hypothesis]
        ref_tok = [[bleu_tokenize(r, self._language) for r in rs]
                   for rs in refs]
        cased = corpus_bleu(hyp_tok, ref_tok)
        hyp_lc = [[t.lower() for t in h] for h in hyp_tok]
        ref_lc = [[[t.lower() for t in r] for r in rs] for rs in ref_tok]
        uncased = corpus_bleu(hyp_lc, ref_lc)
        return {"BLEU": cased, "UncasedBLEU": uncased}


@register_metric("uncased_bleu")
class UncasedBLEU(BLEU):
    def __init__(self, args=None, language="en"):
        super().__init__(args, language)
        self._flag = "UncasedBLEU"


@register_metric("sacre_bleu", "sacrebleu")
class SacreBLEU(Metric):
    """Detokenized BLEU (sacrebleu's defaults: ``13a``, or ``zh`` for
    Chinese; Japanese takes ``13a`` too, as the JAX metric does where
    MeCab is missing), its lowercased value and chrF."""

    def __init__(self, args=None, language="en"):
        super().__init__(args)
        self._language = self._args.get("language") or language
        self._flag = "SacreBLEU"

    @staticmethod
    def class_or_method_args():
        return [Flag("language", dtype=Flag.TYPE.STRING, default="en",
                     help="The target language.")]

    def call(self, hypothesis, groundtruth) -> dict:
        refs = groundtruth
        if refs and isinstance(refs[0], (list, tuple)):
            ref_streams = [list(r) for r in zip(*refs)]
        else:
            ref_streams = [list(refs)]
        tokenize = "zh" if self._language == "zh" else "13a"
        return {"SacreBLEU": sacrebleu_port.corpus_bleu(
                    hypothesis, ref_streams, tokenize=tokenize),
                "UncasedSacreBLEU": sacrebleu_port.corpus_bleu(
                    hypothesis, ref_streams, lowercase=True),
                "ChrF": sacrebleu_port.corpus_chrf(hypothesis, ref_streams)}
