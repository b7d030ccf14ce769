"""Reads a local HuggingFace tokenizer directory into the port's own
WordPiece (``wordpiece``) or byte-level BPE (``byte_level_bpe``)
tokenizer, as ``AutoTokenizer.from_pretrained`` builds the fast
tokenizer there, with no ``transformers`` or ``tokenizers`` package.

* ``tokenizer.json``, where the directory has one: a ``WordPiece``
  model with ``BertNormalizer`` and ``BertPreTokenizer``, or a ``BPE``
  model with the ``ByteLevel`` pre-tokenizer and decoder, and its
  ``added_tokens``.
* Otherwise the slow files: ``vocab.txt`` (BERT), or ``vocab.json`` and
  ``merges.txt`` (GPT-2, RoBERTa), with the added and special tokens of
  ``tokenizer_config.json``'s ``added_tokens_decoder`` (transformers
  4.34 on), and the unknown token of ``special_tokens_map.json``.

The class is ``tokenizer_config.json``'s ``tokenizer_class``
(``BertTokenizer``, ``GPT2Tokenizer``, ``RobertaTokenizer``, each also
with ``Fast``), else the model type of ``tokenizer.json`` says what to
build; any other class, model or component raises
``NotImplementedError``.  As the fast classes do, the
config's ``do_lower_case`` (default true), ``strip_accents`` and
``tokenize_chinese_chars`` (default true) set a BERT normalizer, and its
``add_prefix_space`` (default false) the byte-level pre-tokenizer.  The
fast tokenizer ignores BERT's ``never_split``, and so does this one.

Added tokens are cut out before the rest is tokenized: those with
``normalized`` false from the raw text, then the others from the
normalized text, each the longest match at the leftmost place, with
their ``lstrip``, ``rstrip`` and ``single_word``.

Nothing is fetched: a ``codes`` that is not a local directory raises
``ValueError``.
"""

import json
import os
import re

from neurst_tpu_torch.data.text import hf_unicode_tables as tables
from neurst_tpu_torch.data.text.byte_level_bpe import (BPE,
                                                       ByteLevelPreTokenizer,
                                                       byte_level_decode)
from neurst_tpu_torch.data.text.wordpiece import (BertNormalizer, WordPiece,
                                                  bert_pre_tokenize,
                                                  wordpiece_decode)

__all__ = ["HFTokenizer", "load_tokenizer_dir", "SUPPORTED_CLASSES"]

# tokenizer class -> model family
SUPPORTED_CLASSES = {
    "BertTokenizer": "wordpiece", "BertTokenizerFast": "wordpiece",
    "GPT2Tokenizer": "bpe", "GPT2TokenizerFast": "bpe",
    "RobertaTokenizer": "bpe", "RobertaTokenizerFast": "bpe"}
# each class's unknown token where the config names none
_UNK_TOKENS = {"Bert": "[UNK]", "GPT2": "<|endoftext|>", "Roberta": "<unk>"}
# the whitespace an added token's lstrip / rstrip takes in
_WHITESPACE = "".join(chr(c) for lo, hi in tables.WHITESPACE
                      for c in range(lo, hi + 1))
_STARTS_WITH_WORD = re.compile(r"^\w")
_ENDS_WITH_WORD = re.compile(r"\w\Z")


class AddedToken(object):

    def __init__(self, content, id, single_word=False, lstrip=False,
                 rstrip=False, normalized=True, **kwargs):
        self.content = content
        self.id = id
        self.single_word = single_word
        self.lstrip = lstrip
        self.rstrip = rstrip
        self.normalized = normalized


class _AddedTokens(object):
    """Cuts the added tokens ``tokens`` ({text to match: AddedToken})
    out of a text, each the longest match at the leftmost place."""

    def __init__(self, tokens):
        self._tokens = tokens
        self._pattern = re.compile("|".join(
            re.escape(c) for c in sorted(tokens, key=len, reverse=True))) \
            if tokens else None

    def split(self, text):
        """[(text piece, None) or (matched text, AddedToken)] of ``text``
        (``tokenizers``' ``find_matches``: the matched text holds the
        whitespace ``lstrip`` and ``rstrip`` take in, and is the token
        ``tokenize`` gives)."""
        if self._pattern is None:
            return [(text, None)]
        out, start_offset = [], 0
        for m in self._pattern.finditer(text):
            start, stop = m.span()
            token = self._tokens[m.group()]
            if token.single_word and (
                    (start > 0 and _ENDS_WITH_WORD.search(text[:start]))
                    or (stop < len(text)
                        and _STARTS_WITH_WORD.search(text[stop:]))):
                continue
            if token.lstrip:
                start = max(len(text[:start].rstrip(_WHITESPACE)),
                            start_offset)
            if token.rstrip:
                stop = len(text) - len(text[stop:].lstrip(_WHITESPACE))
            if start_offset < start:
                out.append((text[start_offset:start], None))
            out.append((text[start:stop], token))
            start_offset = stop
        if start_offset < len(text):
            out.append((text[start_offset:], None))
        return out


class HFTokenizer(object):
    """A fast tokenizer's pipeline: added tokens, normalizer,
    pre-tokenizer, model and decoder."""

    def __init__(self, vocab, model, pre_tokenizer, decoder,
                 normalizer=None, added_tokens=(), unk_token=None):
        self._model = model
        self._pre_tokenizer = pre_tokenizer
        self._decoder = decoder
        self._normalizer = normalizer or (lambda text: text)
        self._raw = _AddedTokens({t.content: t for t in added_tokens
                                  if not t.normalized})
        self._normalized = _AddedTokens({
            self._normalizer(t.content): t for t in added_tokens
            if t.normalized})
        self._ids = dict(vocab)
        self._ids.update((t.content, t.id) for t in added_tokens)
        self._unk_id = self._ids.get(unk_token)

    def tokenize(self, text):
        """The tokens of ``text`` (``tokenize`` of the fast tokenizer,
        no special tokens added): the added tokens with ``normalized``
        false cut from the raw text, the others from the normalized
        rest."""
        out = []
        for piece, token in self._raw.split(text):
            if token is not None:
                out.append(piece)
                continue
            for part, token in self._normalized.split(
                    self._normalizer(piece)):
                if token is not None:
                    out.append(part)
                    continue
                for word in self._pre_tokenizer(part):
                    out.extend(self._model(word))
        return out

    def convert_tokens_to_ids(self, tokens):
        """Each token's id, the unknown token's for a token that is not
        in the vocabulary."""
        return [self._ids.get(t, self._unk_id) for t in tokens]

    def convert_tokens_to_string(self, tokens):
        return self._decoder(list(tokens))


def _read_json(root, name):
    path = os.path.join(root, name)
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _content(value):
    return value["content"] if isinstance(value, dict) else value


def _slow_added_tokens(root, config):
    """The added tokens of a directory without ``tokenizer.json``:
    ``tokenizer_config.json``'s ``added_tokens_decoder``, which holds the
    special tokens too."""
    decoder = config.get("added_tokens_decoder")
    if decoder is None:
        raise NotImplementedError(
            f"{root}: a tokenizer_config.json without added_tokens_decoder "
            "(written by transformers before 4.34)")
    return [AddedToken(id=int(i), **t) for i, t in decoder.items()]


def _tokenizer_class(root, config, fast):
    """The config's tokenizer class, else ``PreTrainedTokenizerFast``
    over a tokenizer.json WordPiece or BPE model."""
    cls = config.get("tokenizer_class")
    if cls is None and fast is not None:
        return "PreTrainedTokenizerFast"
    if cls is None:
        raise ValueError(f"{root} holds neither tokenizer_config.json's "
                         "tokenizer_class nor tokenizer.json")
    if cls not in SUPPORTED_CLASSES:
        raise NotImplementedError(
            f"tokenizer class {cls} (the port reads "
            f"{', '.join(sorted(SUPPORTED_CLASSES))})")
    return cls


def _check(component, kind, allowed):
    if component is not None and component.get("type") not in allowed:
        raise NotImplementedError(
            f"tokenizer.json {kind} {component.get('type')} (the port reads "
            f"{', '.join(allowed)})")


def _bert_normalizer(cls, config, state):
    """The BERT normalizer of ``state`` (tokenizer.json's, if any),
    with a BERT class's config flags over it."""
    state = dict(state or {"clean_text": True})
    state.pop("type", None)
    if cls.startswith("Bert"):
        state.update(lowercase=config.get("do_lower_case", True),
                     strip_accents=config.get("strip_accents"),
                     handle_chinese_chars=config.get(
                         "tokenize_chinese_chars", True))
    return BertNormalizer(**state)


def _from_fast(root, cls, config, fast, unk):
    model = fast["model"]
    _check(model, "model", ("WordPiece", "BPE"))
    _check(fast.get("normalizer"), "normalizer", ("BertNormalizer",))
    _check(fast.get("pre_tokenizer"), "pre_tokenizer",
           ("BertPreTokenizer", "ByteLevel"))
    _check(fast.get("decoder"), "decoder", ("WordPiece", "ByteLevel"))
    vocab = model["vocab"]
    added = [AddedToken(**t) for t in fast.get("added_tokens", [])]
    if model["type"] == "WordPiece":
        decoder = fast.get("decoder") or {"prefix": "##", "cleanup": True}
        return HFTokenizer(
            vocab, WordPiece(vocab, model["unk_token"],
                             model.get("continuing_subword_prefix", "##"),
                             model.get("max_input_chars_per_word", 100)),
            bert_pre_tokenize,
            lambda tokens: wordpiece_decode(tokens, decoder["prefix"],
                                            decoder["cleanup"]),
            normalizer=_bert_normalizer(cls, config,
                                        fast.get("normalizer")),
            added_tokens=added, unk_token=unk)
    for key in ("continuing_subword_prefix", "end_of_word_suffix"):
        if model.get(key):
            raise NotImplementedError(f"tokenizer.json BPE {key}")
    if model.get("dropout") or model.get("byte_fallback"):
        raise NotImplementedError("tokenizer.json BPE dropout or "
                                  "byte_fallback")
    pre = fast.get("pre_tokenizer") or {}
    if pre.get("type") != "ByteLevel" or not pre.get("use_regex", True):
        raise NotImplementedError(f"{root}: a BPE model without the "
                                  "ByteLevel pre-tokenizer's pattern")
    merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
              for m in model["merges"]]
    return HFTokenizer(
        vocab, BPE(vocab, merges, model.get("unk_token"),
                   model.get("ignore_merges", False)),
        ByteLevelPreTokenizer(config.get("add_prefix_space", False)),
        byte_level_decode, added_tokens=added, unk_token=unk)


def _from_slow(root, cls, config, unk):
    if SUPPORTED_CLASSES[cls] == "wordpiece":
        vocab = {}
        with open(os.path.join(root, "vocab.txt"), encoding="utf-8") as f:
            for index, token in enumerate(f.readlines()):
                vocab[token.rstrip("\n")] = index
        return HFTokenizer(
            vocab, WordPiece(vocab, unk), bert_pre_tokenize,
            wordpiece_decode, normalizer=_bert_normalizer(cls, config, None),
            added_tokens=_slow_added_tokens(root, config),
            unk_token=unk)
    vocab = _read_json(root, "vocab.json")
    with open(os.path.join(root, "merges.txt"), encoding="utf-8") as f:
        # GPT2Tokenizer drops the first line (#version) and the last
        lines = f.read().split("\n")[1:-1]
    merges = list(dict.fromkeys(tuple(line.split()) for line in lines))
    return HFTokenizer(
        vocab, BPE(vocab, merges),
        ByteLevelPreTokenizer(config.get("add_prefix_space", False)),
        byte_level_decode,
        added_tokens=_slow_added_tokens(root, config),
        unk_token=unk)


def load_tokenizer_dir(codes):
    """The tokenizer of the local directory ``codes``."""
    if not isinstance(codes, str) or not os.path.isdir(codes):
        raise ValueError(
            f"huggingface tokenizer: {codes!r} is not a local directory; "
            "give the path of a tokenizer directory (tokenizer.json, or "
            "vocab.txt / vocab.json + merges.txt with tokenizer_config."
            "json): nothing is fetched")
    config = _read_json(codes, "tokenizer_config.json") or {}
    fast = _read_json(codes, "tokenizer.json")
    cls = _tokenizer_class(codes, config, fast)
    special = _read_json(codes, "special_tokens_map.json") or {}
    unk = config.get("unk_token") or special.get("unk_token") or next(
        (v for k, v in _UNK_TOKENS.items() if cls.startswith(k)), None)
    unk = _content(unk)
    if fast is not None:
        return _from_fast(codes, cls, config, fast, unk)
    return _from_slow(codes, cls, config, unk)
