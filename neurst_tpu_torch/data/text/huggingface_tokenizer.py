"""The HuggingFace tokenizer (the port's copy of
``neurst_tpu/data/text/huggingface_tokenizer.py``) over the port's own
WordPiece and byte-level BPE (``hf_tokenizer_files``), so it needs no
``transformers`` or ``tokenizers`` package.  ``codes`` is a local
tokenizer directory (BERT, GPT-2 or RoBERTa, as ``tokenizer.json`` or as
the slow files), read as ``AutoTokenizer.from_pretrained`` reads it into
the fast tokenizer; a hub model name is not fetched, and raises
``ValueError``."""

from neurst_tpu_torch.data.text.hf_tokenizer_files import load_tokenizer_dir
from neurst_tpu_torch.data.text.tokenizer import Tokenizer, register_tokenizer

__all__ = ["HuggingFaceTokenizer"]


@register_tokenizer("huggingface", "hf")
class HuggingFaceTokenizer(Tokenizer):

    def __init__(self, language="en", glossaries=None, **kwargs):
        super().__init__(language=language, glossaries=glossaries)
        self._tok = None

    def init_subtokenizer(self, codes):
        """``codes`` is the path of a local tokenizer directory."""
        self._tok = load_tokenizer_dir(codes)

    def tokenize(self, text, return_str=False):
        if self._tok is None:
            raise ValueError("huggingface tokenizer not initialized")
        tokens = self._tok.tokenize(self._convert_to_str(text))
        return self._output_wrapper(tokens, return_str)

    def detokenize(self, text, return_str=True):
        if self._tok is None:
            raise ValueError("huggingface tokenizer not initialized")
        text = self._convert_to_str(text)
        out = self._tok.convert_tokens_to_string(text.split())
        return self._output_wrapper(out, return_str)
