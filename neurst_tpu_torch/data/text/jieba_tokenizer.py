"""Jieba Chinese segmentation (the port's copy of
``neurst_tpu/data/text/jieba_tokenizer.py``) over the port's own jieba
(``jieba_segment``: jieba 0.42.1's default cut from the data it carries),
so it needs no ``jieba`` package.

Glossaries are added to this tokenizer's own dictionary, as jieba's
``add_word`` adds them.  The JAX tokenizer adds them to jieba's global
dictionary, so there a tokenizer built later, with or without
glossaries, cuts with them too; here it does not.
"""

from neurst_tpu_torch.data.text.jieba_segment import JiebaSegmenter
from neurst_tpu_torch.data.text.tokenizer import Tokenizer, register_tokenizer

__all__ = ["JiebaTokenizer"]


@register_tokenizer("jieba", "jieba_segment")
class JiebaTokenizer(Tokenizer):

    def __init__(self, language="zh", glossaries=None, **kwargs):
        super().__init__(language=language, glossaries=glossaries)
        self._segmenter = JiebaSegmenter(self._glossaries)

    def tokenize(self, text, return_str=False):
        text = self._convert_to_str(text)
        tokens = [t for t in self._segmenter.cut(text) if t.strip()]
        return self._output_wrapper(tokens, return_str)

    def detokenize(self, text, return_str=True):
        text = self._convert_to_str(text)
        return self._output_wrapper(self.cjk_deseg(text), return_str)
