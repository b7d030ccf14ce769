"""The HuggingFace tokenizer wrapper (the port's copy of
``neurst_tpu/data/text/huggingface_tokenizer.py``).  It needs the
``transformers`` package, which it imports when the tokenizer is
initialized, and raises ``ImportError`` without.  ``codes`` goes to
``AutoTokenizer.from_pretrained`` as it is, as in the JAX wrapper: a
local path is read from disk, a hub model name is fetched from the
HuggingFace hub (give a local path where there is no network)."""

from neurst_tpu_torch.data.text.tokenizer import Tokenizer, register_tokenizer

__all__ = ["HuggingFaceTokenizer"]


@register_tokenizer("huggingface", "hf")
class HuggingFaceTokenizer(Tokenizer):

    def __init__(self, language="en", glossaries=None, **kwargs):
        super().__init__(language=language, glossaries=glossaries)
        self._tok = None

    def init_subtokenizer(self, codes):
        """``codes`` is a HuggingFace model name or local path."""
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError("transformers is required for the "
                              "huggingface tokenizer") from e
        self._tok = AutoTokenizer.from_pretrained(codes)

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
