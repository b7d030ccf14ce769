"""Jieba Chinese segmentation (the port's copy of
``neurst_tpu/data/text/jieba_tokenizer.py``); a missing ``jieba``
package raises ``ImportError`` when the tokenizer is built."""

from neurst_tpu_torch.data.text.tokenizer import Tokenizer, register_tokenizer

__all__ = ["JiebaTokenizer"]

try:
    import jieba
    _HAS_JIEBA = True
except ImportError:  # pragma: no cover
    _HAS_JIEBA = False


@register_tokenizer("jieba", "jieba_segment")
class JiebaTokenizer(Tokenizer):

    def __init__(self, language="zh", glossaries=None, **kwargs):
        super().__init__(language=language, glossaries=glossaries)
        if not _HAS_JIEBA:
            raise ImportError("jieba is required for JiebaTokenizer")
        for g in self._glossaries:
            jieba.add_word(g)

    def tokenize(self, text, return_str=False):
        text = self._convert_to_str(text)
        tokens = [t for t in jieba.cut(text) if t.strip()]
        return self._output_wrapper(tokens, return_str)

    def detokenize(self, text, return_str=True):
        text = self._convert_to_str(text)
        return self._output_wrapper(self.cjk_deseg(text), return_str)
