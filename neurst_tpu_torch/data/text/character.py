"""Character tokenizer (the port's copy of
``neurst_tpu/data/text/character.py``): each character is a token; CJK
languages drop spaces, the others map a space to a visible token so it
round-trips."""

from neurst_tpu_torch.data.text.tokenizer import Tokenizer, register_tokenizer

__all__ = ["CharacterTokenizer"]

_SPACE_TOKEN = "<SPACE>"


@register_tokenizer("character", "char")
class CharacterTokenizer(Tokenizer):

    def __init__(self, language="en", glossaries=None, **kwargs):
        super().__init__(language=language, glossaries=glossaries)

    def tokenize(self, text, return_str=False):
        text = self._convert_to_str(text).strip()
        chars = []
        for ch in text:
            if ch == " ":
                if self._language in ("zh", "ja", "ko"):
                    continue
                chars.append(_SPACE_TOKEN)
            else:
                chars.append(ch)
        return self._output_wrapper(chars, return_str)

    def detokenize(self, text, return_str=True):
        text = self._convert_to_str(text)
        tokens = text.split()
        out = "".join(" " if t == _SPACE_TOKEN else t for t in tokens)
        return self._output_wrapper(out, return_str)
