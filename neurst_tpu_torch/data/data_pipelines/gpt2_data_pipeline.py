"""The GPT-2 data pipeline (the port's copy of
``neurst_tpu/data/data_pipelines/gpt2_data_pipeline.py``): byte-level BPE
through the HuggingFace tokenizer (``tokenizer_name``: a local GPT-2
tokenizer directory, read by the port's own byte-level BPE, with no
``transformers``), the OpenAI ``encoder.json`` / ``vocab.json``
vocabulary, and ``<|endoftext|>`` as eos, pad and bos.
"""

from neurst_tpu_torch.data.data_pipelines.data_pipeline import (
    DataPipeline, register_data_pipeline)
from neurst_tpu_torch.data.text.huggingface_tokenizer import \
    HuggingFaceTokenizer
from neurst_tpu_torch.data.text.vocab import PaddingMode, Vocab

__all__ = ["GPT2DataPipeline"]

EOT = "<|endoftext|>"


@register_data_pipeline("gpt2")
class GPT2DataPipeline(DataPipeline):

    def __init__(self, language="en", tokens=None, vocab_path=None,
                 tokenizer_name="gpt2", **kwargs):
        super().__init__(language=language, vocab_path=vocab_path,
                         tokenizer_name=tokenizer_name, **kwargs)
        if tokens is None and vocab_path is None:
            raise ValueError(
                "GPT2DataPipeline requires `vocab_path` (OpenAI "
                "encoder.json) or `tokens` (no network download here).")
        self._vocab = Vocab(Vocab.load_tokens(vocab_path, tokens),
                            lowercase=False)
        self._language = language
        self._tokenizer = HuggingFaceTokenizer(language=language)
        self._tokenizer.init_subtokenizer(tokenizer_name)
        self._eos_id = self._vocab.map_token_to_id(EOT)
        if self._eos_id is None:
            raise ValueError(f"vocab is missing the {EOT} token")

    @property
    def vocab(self):
        return self._vocab

    @property
    def meta(self):
        return {
            "vocab_size": self._vocab.vocab_size,
            "eos_id": self._eos_id,
            "pad_id": self._eos_id,
            "bos_id": self._eos_id,
            "padding_mode": PaddingMode.EOS_AS_PADDING,
            "language": self._language,
        }

    def preprocess(self, input):
        input = self.text_pre_normalize(self._language, input,
                                        is_processed=False)
        return self._tokenizer.tokenize(input, return_str=True)

    def postprocess(self, input):
        return self._tokenizer.detokenize(input, return_str=True)

    def encode(self, input, is_processed=False):
        if not is_processed:
            input = self.preprocess(input)
        if isinstance(input, str):
            input = input.strip().split()
        ids = [x for x in self._vocab.map_token_to_id(input)
               if x is not None]
        return ids + [self._eos_id]

    def decode(self, input):
        input = [int(x) for x in input]
        if self._eos_id in input:
            input = input[:input.index(self._eos_id)]
        tokens = self._vocab.map_id_to_token(input)
        return self.postprocess(" ".join(tokens))
