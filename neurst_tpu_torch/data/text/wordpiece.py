"""BERT's WordPiece tokenizer as the HuggingFace fast tokenizer runs it
(``tokenizers``' ``BertNormalizer``, ``BertPreTokenizer``, ``WordPiece``
model and decoder), with no ``transformers`` or ``tokenizers`` package.
The character classes are ``tokenizers``' own (``hf_unicode_tables``),
not Python's ``unicodedata``, where the two differ.

* The normalizer: ``clean_text`` drops control characters and maps
  whitespace to a space; ``handle_chinese_chars`` puts spaces around CJK
  ideographs; ``strip_accents`` (by default as ``lowercase``) drops the
  nonspacing marks of the NFD; ``lowercase`` lowercases each character.
* The pre-tokenizer splits at whitespace (dropped) and around each
  punctuation character.
* The model cuts a word into the longest vocabulary pieces from the
  left, a piece after the first with the ``##`` prefix; a word with a
  piece the vocabulary lacks, or of more than 100 characters, is the
  unknown token.
* The decoder joins the tokens with spaces, glues ``##`` pieces to the
  one before, and cleans the spaces before punctuation and in
  contractions.
"""

import re
import unicodedata

from neurst_tpu_torch.data.text import hf_unicode_tables as tables

__all__ = ["BertNormalizer", "bert_pre_tokenize", "WordPiece",
           "wordpiece_decode"]

_CONTROL = re.compile(f"[{tables.char_class(tables.CONTROL)}]+")
_WHITESPACE = tables.char_class(tables.WHITESPACE)
_SPACE = re.compile(f"[{_WHITESPACE}]")
_MARKS = re.compile(f"[{tables.char_class(tables.NONSPACING_MARK)}]+")
_PUNCTUATION = tables.char_class(tables.PUNCTUATION)
_WORDS = re.compile(f"[{_PUNCTUATION}]|[^{_PUNCTUATION}{_WHITESPACE}]+")
# tokenizers' is_chinese_char
_CJK = re.compile("[\u4e00-\u9fff\u3400-\u4dbf\uf900-\ufaff"
                  "\U00020000-\U0002a6df\U0002a700-\U0002b73f"
                  "\U0002b740-\U0002b81f\U0002b920-\U0002ceaf"
                  "\U0002f800-\U0002fa1f]")
_STRIP_KEPT = re.compile("(" + "|".join(map(chr, tables.STRIP)) + ")") \
    if tables.STRIP else None


def _nfd(text):
    """NFD, but for the characters ``tokenizers`` decomposes otherwise
    (``STRIP``)."""
    if _STRIP_KEPT is None:
        return unicodedata.normalize("NFD", text)
    return "".join(tables.STRIP[ord(p)] if i % 2 else
                   unicodedata.normalize("NFD", p)
                   for i, p in enumerate(_STRIP_KEPT.split(text)))


class BertNormalizer(object):

    def __init__(self, clean_text=True, handle_chinese_chars=True,
                 strip_accents=None, lowercase=True):
        self.clean_text = clean_text
        self.handle_chinese_chars = handle_chinese_chars
        self.strip_accents = lowercase if strip_accents is None \
            else strip_accents
        self.lowercase = lowercase

    def __call__(self, text):
        if self.clean_text:
            text = _SPACE.sub(" ", _CONTROL.sub("", text))
        if self.handle_chinese_chars:
            text = _CJK.sub(lambda m: f" {m.group()} ", text)
        if self.strip_accents:
            text = _MARKS.sub("", _nfd(text))
        if self.lowercase:
            text = "".join(tables.LOWER.get(ord(c)) or c.lower()
                           for c in text)
        return text


def bert_pre_tokenize(text):
    """The words of ``text``: split at whitespace and around each
    punctuation character."""
    return _WORDS.findall(text)


class WordPiece(object):
    """Greedy longest-match-first WordPiece over ``vocab`` ({token:
    id})."""

    def __init__(self, vocab, unk_token="[UNK]",
                 continuing_subword_prefix="##",
                 max_input_chars_per_word=100):
        if unk_token not in vocab:
            raise ValueError(f"WordPiece: the unknown token {unk_token!r} "
                             "is not in the vocabulary")
        self.vocab = vocab
        self.unk_token = unk_token
        self.prefix = continuing_subword_prefix
        self.max_chars = max_input_chars_per_word

    def __call__(self, word):
        if len(word) > self.max_chars:
            return [self.unk_token]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = self.prefix + piece
                if piece in self.vocab:
                    break
                end -= 1
            else:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces


def _cleanup(token):
    for dirty, clean in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                         (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                         (" do not", " don't"), (" 's", "'s"),
                         (" 've", "'ve"), (" 're", "'re")):
        token = token.replace(dirty, clean)
    return token


def wordpiece_decode(tokens, prefix="##", cleanup=True):
    """The text of ``tokens`` (``tokenizers``' WordPiece decoder)."""
    out = []
    for i, token in enumerate(tokens):
        if i:
            token = token[len(prefix):] if token.startswith(prefix) \
                else " " + token
        out.append(_cleanup(token) if cleanup else token)
    return "".join(out)
