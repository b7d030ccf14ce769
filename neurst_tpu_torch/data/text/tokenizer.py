"""Tokenizer base and registry (the port's copy of
``neurst_tpu/data/text/tokenizer.py``)."""

from typing import List, Union

from neurst_tpu_torch.utils.registry import setup_registry

__all__ = ["Tokenizer", "build_tokenizer", "register_tokenizer",
           "build_tokenizer_by_name"]


class Tokenizer(object):
    """Base tokenizer; subclasses implement tokenize/detokenize."""

    def __init__(self, language="en", glossaries=None, **kwargs):
        self._language = language
        self._glossaries = glossaries or []

    @property
    def language(self):
        return self._language

    def init_subtokenizer(self, codes):
        """Initializes subword codes (BPE merges, ...)."""

    def tokenize(self, text, return_str=False):
        raise NotImplementedError

    def detokenize(self, text, return_str=True):
        raise NotImplementedError

    @staticmethod
    def _output_wrapper(tokens: Union[str, List[str]], return_str: bool):
        if isinstance(tokens, str):
            return tokens if return_str else tokens.split()
        return " ".join(tokens) if return_str else tokens

    @staticmethod
    def _convert_to_str(text: Union[str, List[str]]) -> str:
        return " ".join(text) if isinstance(text, list) else text

    @staticmethod
    def cjk_deseg(text: str) -> str:
        """Removes the spaces between two CJK characters (zh / ja
        detokenization)."""
        def is_cjk(ch):
            code = ord(ch)
            return (0x4E00 <= code <= 0x9FFF or 0x3400 <= code <= 0x4DBF
                    or 0xF900 <= code <= 0xFAFF or 0x3000 <= code <= 0x303F
                    or 0xFF00 <= code <= 0xFFEF or 0x30A0 <= code <= 0x30FF
                    or 0x3040 <= code <= 0x309F)
        return "".join(
            ch for i, ch in enumerate(text)
            if not (ch == " " and 0 < i < len(text) - 1
                    and is_cjk(text[i - 1]) and is_cjk(text[i + 1])))


build_tokenizer, register_tokenizer = setup_registry(
    "tokenizer", base_class=Tokenizer,
    create_fn=lambda cls, args, **kwargs: cls(**dict(args, **kwargs)))


def build_tokenizer_by_name(name, **kwargs):
    """Builds a tokenizer from a name (None passes through)."""
    if name is None or isinstance(name, Tokenizer):
        return name
    if isinstance(name, dict):
        return build_tokenizer(name, **kwargs)
    return build_tokenizer({"tokenizer.class": name}, **kwargs)
