"""The BERT data pipeline (the port's copy of
``neurst_tpu/data/data_pipelines/bert_data_pipeline.py``): WordPiece
tokens through the HuggingFace tokenizer (``tokenizer_name``: a local
BERT tokenizer directory, read by the port's own WordPiece, with no
``transformers``; without it the text is taken as tokenized), the
[CLS]/[SEP]/[UNK]/[PAD]/[MASK] specials, and ``encode`` wrapping the
ids as [CLS] ... [SEP].
"""

from neurst_tpu_torch.data.data_pipelines.data_pipeline import (
    DataPipeline, register_data_pipeline)
from neurst_tpu_torch.data.text.huggingface_tokenizer import \
    HuggingFaceTokenizer
from neurst_tpu_torch.data.text.vocab import PaddingMode, Vocab

__all__ = ["BertDataPipeline"]


@register_data_pipeline("bert")
class BertDataPipeline(DataPipeline):

    def __init__(self, language="en", tokens=None, vocab_path=None,
                 tokenizer_name=None, **kwargs):
        super().__init__(language=language, vocab_path=vocab_path,
                         tokenizer_name=tokenizer_name, **kwargs)
        if tokens is None and vocab_path is None:
            raise ValueError("BertDataPipeline requires `vocab_path` or "
                             "`tokens`.")
        self._vocab = Vocab(Vocab.load_tokens(vocab_path, tokens),
                            lowercase=False)
        self._language = language
        self._tokenizer = None
        if tokenizer_name:
            self._tokenizer = HuggingFaceTokenizer(language=language)
            self._tokenizer.init_subtokenizer(tokenizer_name)
        self._cls_id = self._vocab.map_token_to_id("[CLS]")
        self._sep_id = self._vocab.map_token_to_id("[SEP]")
        self._unk_id = self._vocab.map_token_to_id("[UNK]")
        self._pad_id = self._vocab.map_token_to_id("[PAD]") or 0
        self._mask_id = self._vocab.map_token_to_id("[MASK]")

    @property
    def vocab(self):
        return self._vocab

    @property
    def meta(self):
        return {
            "vocab_size": self._vocab.vocab_size,
            "cls_id": self._cls_id,
            "sep_id": self._sep_id,
            "bos_id": self._cls_id,
            "eos_id": self._sep_id,
            "unk_id": self._unk_id,
            "pad_id": self._pad_id,
            "mask_id": self._mask_id,
            "padding_mode": PaddingMode.DEFAULT,
            "language": self._language,
        }

    def preprocess(self, input):
        input = self.text_pre_normalize(self._language, input,
                                        is_processed=False)
        if self._tokenizer is not None:
            return self._tokenizer.tokenize(input, return_str=True)
        return input

    def postprocess(self, input):
        if self._tokenizer is not None:
            return self._tokenizer.detokenize(input, return_str=True)
        return input

    def encode(self, input, is_processed=False):
        """text -> [CLS] ids [SEP]."""
        if not is_processed:
            input = self.preprocess(input)
        if isinstance(input, str):
            input = input.strip().split()
        ids = self._vocab.map_token_to_id(input,
                                          unknown_default=self._unk_id)
        return [self._cls_id] + ids + [self._sep_id]

    def decode(self, input):
        input = [int(x) for x in input]
        out = [i for i in input
               if i not in (self._cls_id, self._sep_id, self._pad_id)]
        tokens = self._vocab.map_id_to_token(out)
        return self.postprocess(" ".join(tokens))
