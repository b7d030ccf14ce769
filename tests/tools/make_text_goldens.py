"""Writes ``tests/fixtures/text_goldens/goldens.json``: the outputs of the
text tools the JAX package uses, for the port's own versions to be held
to on a host that lacks them (``chip_smoke.py``'s ``text_tools`` phase on
the card; ``tests/test_torch_text_tools.py`` checks that the file still
equals what the tools give).

* ``moses``: a seeded MuST-C-like corpus a language (en and the MuST-C
  targets de, es, fr, it, nl, pt, ro, ru; ``sample_lines``), its Moses
  punctuation normalization, tokenization (the recipes' form: no XML
  escape) and the detokenization of those tokens, from sacremoses 0.1.1.
* ``sacrebleu``: corpora of hypotheses against one and against three
  reference streams, en and zh, with BLEU (cased, and lowercased), and
  chrF from sacrebleu 2.6.0.
* ``spm``: each model under ``tests/fixtures/spm`` on lines of its
  corpus and seeded mixed lines, its pieces and their decode from the
  SentencePiece implementation of the ``tokenizers`` package (converted
  from the ``.model`` by transformers' ``SpmConverter``, with no
  ``sentencepiece``), unknown pieces as their normalized text.

    python tests/tools/make_text_goldens.py
"""

import json
import os
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(REPO, "tests", "fixtures", "text_goldens",
                   "goldens.json")
SPM_DIR = os.path.join(REPO, "tests", "fixtures", "spm")
SPM_MODELS = ("unigram", "unigram_nfkc", "unigram_bytes", "bpe", "bpe_bytes")
MUSTC_LANGS = ("en", "de", "es", "fr", "it", "nl", "pt", "ro", "ru")
LINES_A_LANGUAGE = 48
# words of each language: accents, apostrophes and the forms its rules
# touch (contractions, elisions, nonbreaking prefixes)
WORDS = {
    "en": "the talk it's don't we'll I'm they're Mr. Dr. U.S. e.g. "
          "science world people's children's one-time well-known cannot "
          "gonna No. 5 $20 30% 1,000 3.14 A.I. I you",
    "de": "die Rede es gibt Dr. Prof. z.B. d.h. Straße Übersetzung "
          "größer Mädchen 3,5 1.000 Nr. 5 Jahr Jahre ein-zwei e-mail",
    "es": "la charla ¿Qué ¡Hola! Sr. Sra. niño año está 3,5 1.000 "
          "económico por qué EE.UU. señor",
    "fr": "la conférence l'homme d'accord qu'il c'est aujourd'hui M. "
          "Mme n° 3,5 1 000 œuvre été très où",
    "it": "la conferenza dell'anno l'uomo un'idea c'è perché città "
          "Sig. 3,5 1.000 più",
    "nl": "de lezing 't is z'n m'n dhr. mevr. blz. één 3,5 1.000 "
          "coöperatie België",
    "pt": "a palestra ação não coração Sr. Sra. 3,5 1.000 está "
          "d'água pôr",
    "ro": "conferința știință țară și în dl. dna. 3,5 1.000 n-a "
          "într-un",
    "ru": "доклад наука «Привет» мир т.е. т.д. г. 3,5 1 000 ёлка "
          "Москва",
}
PUNCT = ['"', "'", ",", ".", "...", "!", "?", ":", ";", "(", ")", "[",
         "]", "-", "--", "\u2013", "\u2014", "\u201e", "\u201c",
         "\u201d", "\u00ab", "\u00bb", "\u2018", "\u2019", "\u00b4",
         "`", "``", "''", "&", "|", "<", ">", "/", "%", "\u2026", "\u00a0",
         "\u00a0%", "\u00a0:", "\u00ab\u00a0", "\u00a0\u00bb", "@", "#"]


def sample_lines(lang, n, seed):
    """``n`` seeded lines of ``lang``: 3-24 of its words with punctuation
    and numbers between, some glued to a word."""
    rng = np.random.RandomState(seed)
    words = WORDS[lang].split()
    out = []
    for _ in range(n):
        parts = []
        for _ in range(int(rng.randint(3, 25))):
            if rng.rand() < 0.3:
                p = PUNCT[int(rng.randint(len(PUNCT)))]
                parts.append(p if rng.rand() < 0.5 or not parts
                             else parts.pop() + p)
            else:
                parts.append(words[int(rng.randint(len(words)))])
        out.append(" ".join(parts))
    return out


def moses_goldens():
    import sacremoses
    out = {}
    for i, lang in enumerate(MUSTC_LANGS):
        lines = sample_lines(lang, LINES_A_LANGUAGE, 100 + i)
        norm = sacremoses.MosesPunctNormalizer(lang=lang)
        tok = sacremoses.MosesTokenizer(lang=lang)
        detok = sacremoses.MosesDetokenizer(lang=lang)
        normalized = [norm.normalize(s) for s in lines]
        tokens = [" ".join(tok.tokenize(s, escape=False)) for s in normalized]
        out[lang] = {"lines": lines, "normalized": normalized,
                     "tokenized": tokens,
                     "detokenized": [detok.detokenize(t.split())
                                     for t in tokens]}
    return out


def sacrebleu_cases():
    """(name, language, hypotheses, reference streams) from the Moses
    corpus: references are the lines, hypotheses the lines with words
    dropped, swapped and lowercased (seeded), some empty."""
    rng = np.random.RandomState(5)
    cases = []
    for lang, streams in (("en", 1), ("en", 3), ("de", 1), ("zh", 2)):
        refs = [sample_lines(lang if lang != "zh" else "en", 32, 7 + k)
                for k in range(streams)]
        if lang == "zh":
            refs = [[_zh(s, rng) for s in stream] for stream in refs]
        hyps = []
        for s in refs[0]:
            words = s.split()
            keep = [w.lower() if rng.rand() < 0.2 else w for w in words
                    if rng.rand() > 0.25]
            if len(keep) > 2 and rng.rand() < 0.3:
                keep[0], keep[1] = keep[1], keep[0]
            hyps.append(" ".join(keep) if rng.rand() > 0.1 else "")
        cases.append((f"{lang}_{streams}ref", lang, hyps, refs))
    return cases


def _zh(line, rng):
    chars = "我们的世界科学今天人们这是一个演讲中文字"
    return "".join(chars[int(rng.randint(len(chars)))] if c.isalpha()
                   else c for c in line)


def sacrebleu_goldens():
    import sacrebleu
    out = {}
    for name, lang, hyps, refs in sacrebleu_cases():
        tok = "zh" if lang == "zh" else "13a"
        out[name] = {
            "language": lang, "hypotheses": hyps, "references": refs,
            "bleu": sacrebleu.corpus_bleu(hyps, refs, tokenize=tok).score,
            "uncased_bleu": sacrebleu.corpus_bleu(
                hyps, refs, lowercase=True).score,
            "chrf": sacrebleu.corpus_chrf(hyps, refs).score}
    return out


def hf_spm(path):
    """The ``tokenizers`` SentencePiece of a ``.model`` and its proto."""
    from transformers.convert_slow_tokenizer import (SpmConverter,
                                                     generate_merges)
    from transformers.utils import sentencepiece_model_pb2_new as pb
    proto = pb.ModelProto()
    with open(path, "rb") as f:
        proto.ParseFromString(f.read())

    class Extractor:
        def __init__(self, _):
            pass

        def extract(self, vocab_scores):
            vocab = {p.piece: i for i, p in enumerate(proto.pieces)}
            return vocab, generate_merges(vocab, vocab_scores)

    class Converter(SpmConverter):
        handle_byte_fallback = proto.trainer_spec.byte_fallback
        SpmExtractor = Extractor

    class Original:
        vocab_file = path
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return Converter(Original()).converted(), proto


def hf_pieces(tokenizer, proto, text):
    """SentencePiece's ``EncodeAsPieces`` through ``tokenizers``: the
    normalizer, the Metaspace words, then the model on each word; an
    unknown piece as its normalized text (``tokenizers`` names it
    ``<unk>``)."""
    unk = proto.pieces[proto.trainer_spec.unk_id].piece
    norm = tokenizer.normalizer.normalize_str(text)
    out = []
    for word, _ in tokenizer.pre_tokenizer.pre_tokenize_str(norm):
        raw = word.encode("utf-8")
        for t in tokenizer.model.tokenize(word):
            if t.value != unk:
                out.append(t.value)
            elif proto.trainer_spec.model_type == 2:
                out.append(raw[t.offsets[0]:t.offsets[1]].decode("utf-8"))
            else:
                out.append(word[t.offsets[0]:t.offsets[1]])
    return out


def hf_decoder():
    """SentencePiece's ``DecodePieces`` in ``tokenizers``: ``▁`` as a
    space, byte pieces as UTF-8, the leading space dropped."""
    from tokenizers import decoders
    return decoders.Sequence([decoders.Replace("▁", " "),
                              decoders.ByteFallback(), decoders.Fuse(),
                              decoders.Strip(" ", 1, 0)])


def spm_lines(seed=11, n=40):
    """Lines of the spm corpus and ``n`` seeded mixed lines (ASCII, the
    charsmap's keys, unknown characters).  No line holds what the
    ``tokenizers`` implementation reads otherwise than SentencePiece (a
    literal ``▁`` at either end, whitespace other than a space at the
    end, a combining mark after a charsmap key): the parity tests hold
    the port to SentencePiece there by hand."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_spm_fixture", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "make_spm_fixture.py"))
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    with open(os.path.join(SPM_DIR, "corpus.txt"), encoding="utf-8") as f:
        lines = f.read().splitlines()[:40]
    rng = np.random.RandomState(seed)
    alphabet = (list("abcdefghijklmnopqrstuvwxyz     ") * 2
                + sorted(fixture.CHARSMAP) + list("日本ßéqz▁.,'-"))
    for _ in range(n):
        chars = [alphabet[int(i)] for i in
                 rng.randint(len(alphabet), size=int(rng.randint(1, 30)))]
        line = "".join(chars).strip("\u2581\t\u3000\u00a0 ")
        lines.append(line)
    return lines


def spm_goldens():
    out = {}
    dec = hf_decoder()
    lines = spm_lines()
    for name in SPM_MODELS:
        tokenizer, proto = hf_spm(os.path.join(SPM_DIR, f"{name}.model"))
        pieces = [hf_pieces(tokenizer, proto, s) for s in lines]
        out[name] = {"lines": lines, "pieces": pieces,
                     "decoded": [dec.decode(p) for p in pieces]}
    return out


def goldens():
    return {"moses": moses_goldens(), "sacrebleu": sacrebleu_goldens(),
            "spm": spm_goldens()}


def main():
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w", encoding="utf-8") as f:
        json.dump(goldens(), f, ensure_ascii=False, indent=0)
        f.write("\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
