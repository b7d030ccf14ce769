"""The multilingual text pipeline (the port's copy of
``neurst_tpu/data/data_pipelines/multilingual_text_data_pipeline.py``):
one tokenizer and vocabulary shared by every language, with a ``<lang>``
tag token a language (``Vocab.get_unique`` of it, appended to the
vocabulary unless present) exposed as ``meta["lang2id"]``.  ``encode``
appends EOS (which is also the pad); ``decode`` drops a leading BOS or
tag and stops at the first EOS.  The default tokenizer is ``spm`` (the
port's own SentencePiece, ``data/text/spm.py``) over ``spm_model``; pass
``tokenizer: null`` for text that is already split.
"""

import yaml

from neurst_tpu_torch.data.data_pipelines.data_pipeline import (
    DataPipeline, register_data_pipeline)
from neurst_tpu_torch.data.text.tokenizer import build_tokenizer_by_name
from neurst_tpu_torch.data.text.vocab import PaddingMode, Vocab

__all__ = ["MultilingualTextDataPipeline"]


@register_data_pipeline("multilingual_text")
class MultilingualTextDataPipeline(DataPipeline):

    def __init__(self, vocab_path, languages, spm_model=None,
                 tokenizer="spm", reverse_sequence=False, **kwargs):
        super().__init__(vocab_path=vocab_path, languages=languages,
                         spm_model=spm_model, tokenizer=tokenizer,
                         reverse_sequence=reverse_sequence, **kwargs)
        self._reverse_sequence = reverse_sequence
        self._tokenizer = build_tokenizer_by_name(tokenizer) \
            if tokenizer else None
        if self._tokenizer is not None and spm_model is not None:
            self._tokenizer.init_subtokenizer(spm_model)
        if isinstance(vocab_path, list):
            tokens = Vocab.load_tokens(tokens=vocab_path)
        else:
            tokens = Vocab.load_tokens(vocab_path=vocab_path)
        if isinstance(languages, str):
            languages = yaml.safe_load(languages)
        if not isinstance(languages, list):
            raise ValueError(f"`languages` must be a list, got {languages}")
        lang2tags = {lang: Vocab.get_unique(tokens, f"<{lang}>")
                     for lang in languages}
        unk_token = Vocab.get_unique(tokens, "<UNK>")
        bos_token = Vocab.get_unique(tokens, "<SEQ_BEG>")
        eos_token = Vocab.get_unique(tokens, "<SEQ_END>")
        self._vocab = Vocab(tokens, [unk_token, bos_token, eos_token]
                            + list(lang2tags.values()), lowercase=False)
        self._eos_id = self._vocab.map_token_to_id(eos_token)
        self._bos_id = self._vocab.map_token_to_id(bos_token)
        self._unk_id = self._vocab.map_token_to_id(unk_token)
        self._lang_ids = {lang: self._vocab.map_token_to_id(tag)
                          for lang, tag in lang2tags.items()}

    @property
    def vocab(self):
        return self._vocab

    @property
    def meta(self):
        return {
            "lang2id": self._lang_ids,
            "vocab_size": self._vocab.vocab_size,
            "eos_id": self._eos_id,
            "bos_id": self._bos_id,
            "unk_id": self._unk_id,
            "pad_id": self._eos_id,
            "padding_mode": PaddingMode.EOS_AS_PADDING,
        }

    def lang_id(self, lang: str) -> int:
        return self._lang_ids[lang]

    def preprocess(self, input):
        input = self.text_pre_normalize("en", input, is_processed=False)
        if self._tokenizer is not None:
            return self._tokenizer.tokenize(input, return_str=True)
        return input

    def postprocess(self, input):
        if self._tokenizer is not None:
            return self._tokenizer.detokenize(input, return_str=True)
        return input

    def encode(self, input, is_processed=False):
        """Text -> token ids, appending EOS."""
        if not is_processed:
            input = self.preprocess(input)
        if isinstance(input, str):
            input = input.strip().split()
        ids = self._vocab.map_token_to_id(input,
                                          unknown_default=self._unk_id)
        if self._reverse_sequence:
            ids = ids[::-1]
        return ids + [self._eos_id]

    def decode(self, input):
        """Token ids -> text (without a leading BOS or tag, up to EOS)."""
        input = [int(x) for x in input]
        if input and (input[0] == self._bos_id
                      or input[0] in self._lang_ids.values()):
            input = input[1:]
        if self._eos_id in input:
            input = input[:input.index(self._eos_id)]
        tokens = self._vocab.map_id_to_token(input)
        if self._reverse_sequence:
            tokens = tokens[::-1]
        return self.postprocess(" ".join(tokens))
