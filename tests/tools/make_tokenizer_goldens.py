"""Writes the HuggingFace tokenizer fixtures under ``tests/fixtures/hf/``
and ``tests/fixtures/text_goldens/tokenizer_goldens.json``: what jieba
and ``AutoTokenizer`` give on seeded lines, for the port's own jieba,
WordPiece and byte-level BPE to be held to on a host that lacks them
(``chip_smoke.py``'s ``text_tools`` phase on the card;
``tests/test_torch_hf_tokenizers.py`` and ``tests/test_torch_jieba.py``
check that the files still equal what the packages give).

* Fixtures, built offline (nothing is fetched) from a seeded corpus
  (``mixed_lines``), each as a slow-files directory (``<name>_slow``:
  ``vocab.txt``, or ``vocab.json`` + ``merges.txt``, with
  ``tokenizer_config.json`` and ``special_tokens_map.json``, as the slow
  class saves it) and as a ``tokenizer.json`` directory (``<name>_fast``,
  as ``AutoTokenizer`` saves the fast tokenizer it converts from the
  slow one):

  - ``bert_cased``, ``bert_uncased``: a WordPiece vocabulary of the
    corpus's words, some of their prefixes and ``##`` suffixes, and its
    characters, less a few (which become ``[UNK]``);
  - ``gpt2``: the 256 byte characters, ``BPE_MERGES`` merges learned on
    the corpus (the most frequent pair first, ties by the pair), and
    ``<|endoftext|>``;
  - ``roberta``: the same BPE with RoBERTa's specials and
    ``add_prefix_space``.
* Goldens:

  - ``jieba``: ``JIEBA_LINES`` seeded lines (``jieba_lines``) and
    ``jieba.cut`` of each; then ``GLOSSARY_LINES`` of them cut after
    ``jieba.add_word`` of each of ``GLOSSARIES`` (as the JAX tokenizer
    adds glossaries);
  - ``wordpiece_cased``, ``wordpiece_uncased``, ``gpt2_bpe``,
    ``roberta_bpe``: ``HF_LINES`` lines each, and for each line
    ``tokenize``, the ids of those tokens and ``convert_tokens_to_string``
    of them, from the fast tokenizer ``AutoTokenizer`` loads from the
    ``_fast`` directory (it loads the ``_slow`` one to the same).

    python tests/tools/make_tokenizer_goldens.py
"""

import collections
import gzip
import json
import os
import shutil
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "hf")
OUT = os.path.join(REPO, "tests", "fixtures", "text_goldens",
                   "tokenizer_goldens.json")
JIEBA_LINES = 1000
GLOSSARY_LINES = 100
GLOSSARIES = ["云计算方面", "创新办", "深度学习框架", "语音翻译"]
HF_LINES = 500
BPE_MERGES = 1200
PARTS = {"wordpiece_cased": "bert_cased", "wordpiece_uncased": "bert_uncased",
         "gpt2_bpe": "gpt2", "roberta_bpe": "roberta"}

# pieces of the mixed lines: words of several scripts, accents and
# combining marks, Greek final sigma, CJK, emoji (of Unicode 6 to 16),
# numbers of several kinds, punctuation, control and format characters,
# whitespace of several kinds, letters and digits assigned in Unicode 16
# (which Python 3.12's tables lack), contractions and special tokens
WORDS = (
    "the quick brown fox jumps over lazy dog hello world tokenizers "
    "unaffable running translation speech model people children "
    "don't it's we'll I'm they're you've she'd can't won't Mr. U.S. "
    "Hello World The Quick HELLO SCIENCE iPhone McDonald's e-mail "
    "café naïve façade résumé Übersetzung größer Straße São Paulo "
    "niño año déjà vu coöperation Ελληνικά ΟΔΟΣ οδός Σίσυφος "
    "Привет мир Москва ёлка 中文 字符 日本語 東京 한국어 서울 "
    "العربية مرحبا שלום नमस्ते हिन्दी สวัสดี ภาษาไทย ქართული "
    "Ⅻ ½ ² ³ ٣٤ ३ 3.14 1,000 2024 42 007 $20 30% #hashtag @user "
    "é ä ñ Ᲊᲊ Ɤ \U00010d40\U00010d41 "
    "😀 👍🏽 👨‍👩‍👧 🥰 🫠 🫨 \U0001fae9 ❤️ ™ © ∑ ∞ ≠ → ← ★ ♪").split(" ")
PUNCT = list(".,!?;:()[]{}\"'`~@#$%^&*-_+=/\\|<>") + [
    "«", "»", "“", "”", "‘", "’", "—", "–", "…", "¿", "¡", "。", "，",
    "、", "「", "」", "·", "•", "...", "--", "''", "``"]
CONTROL = ["\x00", "\x01", "\x07", "\x1b", "\x1c", "\x1d", "\x1e", "\x1f",
           "\x7f", "\x85", "​", "‍", "﻿", "­", "�",
           "⁠", "\U000e0001"]
SPACES = [" ", " ", " ", " ", "  ", "\t", "\n", "\r\n", " ", " ",
          "　", " ", " ", " ", " ", "\x0b", "\x0c",
          ""]


def mixed_lines(n, seed, specials=()):
    """``n`` seeded lines of 1-24 pieces (words, punctuation, control
    characters, ``specials``) joined by whitespace of several kinds (or
    nothing)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        parts = []
        for _ in range(int(rng.randint(1, 25))):
            r = rng.rand()
            if r < 0.62:
                piece = WORDS[int(rng.randint(len(WORDS)))]
            elif r < 0.82:
                piece = PUNCT[int(rng.randint(len(PUNCT)))]
            elif r < 0.9:
                piece = CONTROL[int(rng.randint(len(CONTROL)))]
            elif r < 0.95 and specials:
                piece = specials[int(rng.randint(len(specials)))]
            else:
                piece = "".join(chr(int(c)) for c in rng.randint(
                    0x61, 0x7b, size=int(rng.randint(1, 12))))
            parts.append(piece)
            parts.append(SPACES[int(rng.randint(len(SPACES)))])
        if rng.rand() < 0.02:
            parts = ["x" * int(rng.randint(95, 110))]
        out.append("".join(parts[:-1]) if rng.rand() < 0.8
                   else "".join(parts))
    return out


HAN_RUN = "".join(chr(c) for c in range(0x4e00, 0x9fa6))


def jieba_lines(n, seed):
    """``n`` seeded lines of Chinese text for jieba: dictionary words
    drawn by their frequency, runs of random CJK characters (the HMM's
    work), digits, decimals and percentages, Latin words, punctuation,
    ``\\r\\n``, tabs and full-width spaces."""
    words, freqs = _jieba_dictionary()
    cdf = np.cumsum(freqs)
    rng = np.random.RandomState(seed)
    latin = ["hello", "NeurST", "GPU", "H100", "C++", "abc_def", "x-ray",
             "iPhone", "AT&T", "v2.0", "email", "Python3"]
    punct = ["，", "。", "、", "！", "？", "：", "；", "（", "）", "“", "”",
             "《", "》", ",", ".", "!", "?", "-", "…", "·"]
    space = [" ", "  ", "\t", "\r\n", "\n", "　", ""]
    out = []
    for _ in range(n):
        parts = []
        for _ in range(int(rng.randint(2, 30))):
            r = rng.rand()
            if r < 0.55:
                parts.append(words[int(np.searchsorted(
                    cdf, rng.rand() * cdf[-1], side="right"))])
            elif r < 0.72:
                parts.append("".join(HAN_RUN[int(i)] for i in rng.randint(
                    len(HAN_RUN), size=int(rng.randint(2, 6)))))
            elif r < 0.78:
                num = str(int(rng.randint(0, 10 ** int(rng.randint(1, 6)))))
                k = rng.rand()
                if k < 0.3:
                    num += "." + str(int(rng.randint(0, 100)))
                if k > 0.6:
                    num += "%"
                parts.append(num)
            elif r < 0.84:
                parts.append(latin[int(rng.randint(len(latin)))])
            elif r < 0.94:
                parts.append(punct[int(rng.randint(len(punct)))])
            else:
                parts.append(space[int(rng.randint(len(space)))])
        out.append("".join(parts))
    return out


def _jieba_dictionary():
    """(words, frequencies) of the port's copy of jieba's dictionary
    (equal to jieba's own: ``tests/tools/make_jieba_tables.py``)."""
    path = os.path.join(REPO, "neurst_tpu_torch", "data", "text",
                        "jieba_data", "dict.txt.gz")
    words, freqs = [], []
    with gzip.open(path, "rt", encoding="utf-8") as f:
        for line in f:
            word, freq = line.split(" ")[:2]
            words.append(word)
            freqs.append(int(freq))
    return words, np.asarray(freqs, np.float64)


def jieba_goldens():
    import jieba
    jieba.setLogLevel(60)
    lines = jieba_lines(JIEBA_LINES, 23)
    plain = [list(jieba.cut(s)) for s in lines]
    # jieba's add_word changes its global dictionary: the glossary cases
    # come after every plain one
    for word in GLOSSARIES:
        jieba.add_word(word)
    glossary_lines = lines[:GLOSSARY_LINES - len(GLOSSARIES)] + [
        f"我们讨论{w}的问题" for w in GLOSSARIES]
    return {"lines": lines, "cut": plain, "glossaries": GLOSSARIES,
            "glossary_lines": glossary_lines,
            "glossary_cut": [list(jieba.cut(s)) for s in glossary_lines]}


def _bert_vocab(lines, lowercase, seed):
    """A WordPiece vocabulary of ``lines``' words (under the BERT
    normalizer): specials, the frequent words, prefixes and ``##``
    suffixes of the others, every character bare and as ``##``, less a
    few."""
    from tokenizers import normalizers, pre_tokenizers
    norm = normalizers.BertNormalizer(lowercase=lowercase)
    pre = pre_tokenizers.BertPreTokenizer()
    counts = collections.Counter(
        w for s in lines for w, _ in pre.pre_tokenize_str(
            norm.normalize_str(s)))
    rng = np.random.RandomState(seed)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    chars = sorted({c for w in counts for c in w})
    dropped = set(rng.choice(chars, size=max(1, len(chars) // 25),
                             replace=False))
    chars = [c for c in chars if c not in dropped]
    vocab += chars + ["##" + c for c in chars]
    for word, count in sorted(counts.items()):
        if count > 2 and rng.rand() < 0.6:
            vocab.append(word)
        if len(word) > 3:
            k = int(rng.randint(2, len(word)))
            vocab.append(word[:k])
            vocab.append("##" + word[k:])
    return list(dict.fromkeys(vocab))


def _learn_bpe(lines, merges):
    """``merges`` BPE merges of the byte-level pieces of ``lines``: the
    most frequent pair first, ties by the pair."""
    from tokenizers import pre_tokenizers
    pre = pre_tokenizers.ByteLevel(add_prefix_space=False)
    counts = collections.Counter(
        p for s in lines for p, _ in pre.pre_tokenize_str(s))
    words = [list(w) for w in counts]
    freq = list(counts.values())
    pairs = collections.Counter()
    where = collections.defaultdict(set)
    for k, w in enumerate(words):
        for pair in zip(w, w[1:]):
            pairs[pair] += freq[k]
            where[pair].add(k)
    out = []
    while len(out) < merges and pairs:
        best = min(pairs, key=lambda p: (-pairs[p], p))
        out.append(best)
        for k in sorted(where.pop(best)):
            w = words[k]
            for pair in zip(w, w[1:]):
                pairs[pair] -= freq[k]
                if pairs[pair] <= 0:
                    del pairs[pair]
            new, i = [], 0
            while i < len(w):
                if tuple(w[i:i + 2]) == best:
                    new.append(w[i] + w[i + 1])
                    i += 2
                else:
                    new.append(w[i])
                    i += 1
            words[k] = new
            for pair in zip(new, new[1:]):
                pairs[pair] += freq[k]
                where[pair].add(k)
    return out


def build_fixtures(root=FIXTURES):
    """Writes every ``<name>_slow`` / ``<name>_fast`` directory."""
    import transformers
    from transformers.models.gpt2.tokenization_gpt2 import bytes_to_unicode
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    corpus = mixed_lines(400, 3)
    for name, lowercase in (("bert_cased", False), ("bert_uncased", True)):
        slow = os.path.join(root, f"{name}_slow")
        os.makedirs(slow)
        vocab = os.path.join(root, "vocab.txt")
        with open(vocab, "w", encoding="utf-8") as f:
            f.write("\n".join(_bert_vocab(corpus, lowercase, 5)) + "\n")
        transformers.BertTokenizer(
            vocab_file=vocab, do_lower_case=lowercase).save_pretrained(slow)
        os.remove(vocab)
    merges = _learn_bpe(corpus, BPE_MERGES)
    base = sorted(bytes_to_unicode().values())
    bpe_tokens = base + [a + b for a, b in merges]
    for name, specials in (("gpt2", ["<|endoftext|>"]),
                           ("roberta", ["<s>", "<pad>", "</s>", "<unk>",
                                        "<mask>"])):
        slow = os.path.join(root, f"{name}_slow")
        os.makedirs(slow)
        tokens = list(dict.fromkeys(
            (specials if name == "roberta" else []) + bpe_tokens
            + (specials if name == "gpt2" else [])))
        files = {k: os.path.join(root, k) for k in ("vocab.json",
                                                    "merges.txt")}
        with open(files["vocab.json"], "w", encoding="utf-8") as f:
            json.dump({t: i for i, t in enumerate(tokens)}, f,
                      ensure_ascii=False)
        with open(files["merges.txt"], "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n" + "".join(f"{a} {b}\n"
                                                for a, b in merges))
        if name == "gpt2":
            tok = transformers.GPT2Tokenizer(files["vocab.json"],
                                             files["merges.txt"])
        else:
            tok = transformers.RobertaTokenizer(
                files["vocab.json"], files["merges.txt"],
                add_prefix_space=True)
        tok.save_pretrained(slow)
        for path in files.values():
            os.remove(path)
    for name in ("bert_cased", "bert_uncased", "gpt2", "roberta"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fast = transformers.AutoTokenizer.from_pretrained(
                os.path.join(root, f"{name}_slow"))
        assert fast.is_fast, name
        fast.save_pretrained(os.path.join(root, f"{name}_fast"))


def hf_specials(name):
    return {"bert_cased": ["[MASK]", "[SEP]", "[CLS]"],
            "bert_uncased": ["[MASK]", "[SEP]", "[UNK]"],
            "gpt2": ["<|endoftext|>"],
            "roberta": ["<mask>", "</s>", "<s>"]}[name]


def hf_goldens(root=FIXTURES):
    import transformers
    out = {}
    for i, (part, name) in enumerate(PARTS.items()):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tok = transformers.AutoTokenizer.from_pretrained(
                os.path.join(root, f"{name}_fast"))
        lines = mixed_lines(HF_LINES, 40 + i, hf_specials(name))
        tokens = [tok.tokenize(s) for s in lines]
        out[part] = {"fixture": name, "lines": lines, "tokens": tokens,
                     "ids": [tok.convert_tokens_to_ids(t) for t in tokens],
                     "detokenized": [tok.convert_tokens_to_string(t)
                                     for t in tokens]}
    return out


def goldens(root=FIXTURES):
    return {"jieba": jieba_goldens(), "hf": hf_goldens(root)}


def main():
    build_fixtures()
    with open(OUT, "w", encoding="utf-8") as f:
        json.dump(goldens(), f, ensure_ascii=False)
        f.write("\n")
    print(f"wrote {FIXTURES} and {OUT}")


if __name__ == "__main__":
    main()
