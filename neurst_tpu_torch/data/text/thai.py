"""Thai word segmentation (``thai``; the port's copy of
``neurst_tpu/data/text/thai.py``) through pythainlp's ``word_tokenize``.
pythainlp and its word dictionary are not carried by the port: without
the package, building the tokenizer raises ``ImportError``."""

from neurst_tpu_torch.data.text.tokenizer import Tokenizer, register_tokenizer

__all__ = ["ThaiTokenizer"]


@register_tokenizer("thai")
class ThaiTokenizer(Tokenizer):

    def __init__(self, language="th", glossaries=None, **kwargs):
        super().__init__(language=language, glossaries=glossaries)
        try:
            from pythainlp.tokenize import word_tokenize
        except ImportError as e:
            raise ImportError("pythainlp is required for ThaiTokenizer "
                              "but is not installed") from e
        self._word_tokenize = word_tokenize

    def tokenize(self, text, return_str=False):
        tokens = [t for t in self._word_tokenize(self._convert_to_str(text))
                  if t.strip()]
        return self._output_wrapper(tokens, return_str)

    def detokenize(self, text, return_str=True):
        text = self._convert_to_str(text)
        return self._output_wrapper(text.replace(" ", ""), return_str)
