"""Moses tokenizer through sacremoses (the port's copy of
``neurst_tpu/data/text/moses.py``): sacremoses is imported when the
module is, and a missing package raises ``ImportError`` when a
tokenizer is built."""

from neurst_tpu_torch.data.text.tokenizer import Tokenizer, register_tokenizer

__all__ = ["MosesTokenizer", "HAS_SACREMOSES"]

try:
    import sacremoses
    HAS_SACREMOSES = True
except ImportError:
    HAS_SACREMOSES = False


@register_tokenizer("moses")
class MosesTokenizer(Tokenizer):

    def __init__(self, language="en", glossaries=None,
                 aggressive_dash_splits=False, escape=False, **kwargs):
        super().__init__(language=language, glossaries=glossaries)
        if not HAS_SACREMOSES:
            raise ImportError("sacremoses is required for MosesTokenizer")
        self._tok = sacremoses.MosesTokenizer(lang=language)
        self._detok = sacremoses.MosesDetokenizer(lang=language)
        self._aggressive = aggressive_dash_splits
        self._escape = escape

    def tokenize(self, text, return_str=False):
        tokens = self._tok.tokenize(
            self._convert_to_str(text),
            aggressive_dash_splits=self._aggressive, return_str=False,
            escape=self._escape, protected_patterns=self._glossaries or None)
        return self._output_wrapper(tokens, return_str)

    def detokenize(self, text, return_str=True):
        out = self._detok.detokenize(self._convert_to_str(text).split(),
                                     return_str=True)
        return self._output_wrapper(out, return_str)
