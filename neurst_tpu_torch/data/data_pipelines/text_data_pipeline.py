"""Text pipeline: tokenizer (+ subtokenizer) + vocabulary -> ids (the
port's copy of ``neurst_tpu/data/data_pipelines/text_data_pipeline.py``).

Conventions kept exactly: unseen control tokens (<UNK>/<SEQ_BEG>/
<SEQ_END>) are appended to the vocabulary (or bound to given indices);
``encode`` appends EOS; ``decode`` strips a leading BOS and stops at the
first EOS; pad defaults to EOS.
"""

from neurst_tpu_torch.data.data_pipelines.data_pipeline import (
    DataPipeline, register_data_pipeline)
from neurst_tpu_torch.data.text.tokenizer import build_tokenizer_by_name
from neurst_tpu_torch.data.text.vocab import PaddingMode, Vocab
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["TextDataPipeline"]


@register_data_pipeline("simple_text", "transcript_data_pipeline",
                        "TranscriptDataPipeline")
class TextDataPipeline(DataPipeline):

    @staticmethod
    def class_or_method_args():
        return [
            Flag("vocab_path", dtype=Flag.TYPE.STRING, default=None,
                 help="The path to the vocabulary file."),
            Flag("language", dtype=Flag.TYPE.STRING, default="en",
                 help="The language."),
            Flag("tokenizer", dtype=Flag.TYPE.STRING, default=None,
                 help="The tokenizer name."),
            Flag("subtokenizer", dtype=Flag.TYPE.STRING, default=None,
                 help="The subword tokenizer name (bpe/spm/...)."),
            Flag("subtokenizer_codes", dtype=Flag.TYPE.STRING, default=None,
                 help="The subword codes / model path."),
            Flag("glossaries", dtype=Flag.TYPE.STRING, default=None,
                 multiple=True, help="Terms never split by tokenizers."),
            Flag("lowercase", dtype=Flag.TYPE.BOOLEAN, default=False,
                 help="Lowercase text before tokenization (ASR "
                      "transcripts)."),
            Flag("remove_punctuation", dtype=Flag.TYPE.BOOLEAN,
                 default=False,
                 help="Strip punctuation before tokenization (ASR "
                      "transcripts)."),
            Flag("reverse_sequence", dtype=Flag.TYPE.BOOLEAN, default=False,
                 help="Whether to reverse the sequence."),
        ]

    def __init__(self,
                 vocab_path,
                 language="en",
                 tokenizer=None,
                 subtokenizer=None,
                 subtokenizer_codes=None,
                 glossaries=None,
                 reverse_sequence=False,
                 bos_id=None,
                 eos_id=None,
                 unk_id=None,
                 pad_id=None,
                 **kwargs):
        super().__init__(vocab_path=vocab_path, language=language,
                         tokenizer=tokenizer, subtokenizer=subtokenizer,
                         subtokenizer_codes=subtokenizer_codes,
                         glossaries=glossaries,
                         reverse_sequence=reverse_sequence, **kwargs)
        self._language = language
        self._reverse_sequence = reverse_sequence
        self._tokenizer = build_tokenizer_by_name(
            tokenizer, language=language, glossaries=glossaries)
        self._subtokenizer = build_tokenizer_by_name(
            subtokenizer, language=language, glossaries=glossaries,
            vocabulary=vocab_path)
        if self._subtokenizer is not None and subtokenizer_codes is not None:
            self._subtokenizer.init_subtokenizer(subtokenizer_codes)

        if isinstance(vocab_path, list):
            tokens = Vocab.load_tokens(tokens=vocab_path)
        else:
            tokens = Vocab.load_tokens(vocab_path=vocab_path)
        unk_token = Vocab.get_unique(tokens, "<UNK>") if unk_id is None \
            else tokens[unk_id]
        bos_token = Vocab.get_unique(tokens, "<SEQ_BEG>") if bos_id is None \
            else tokens[bos_id]
        eos_token = Vocab.get_unique(tokens, "<SEQ_END>") if eos_id is None \
            else tokens[eos_id]
        pad_token = eos_token if pad_id is None else tokens[pad_id]
        assert unk_token != bos_token != eos_token
        self._vocab = Vocab(tokens, [unk_token, bos_token, eos_token, pad_token],
                            lowercase=False)
        self._eos_id = self._vocab.map_token_to_id(eos_token)
        self._bos_id = self._vocab.map_token_to_id(bos_token)
        self._unk_id = self._vocab.map_token_to_id(unk_token)
        self._pad_id = self._vocab.map_token_to_id(pad_token)

    @property
    def vocab(self):
        return self._vocab

    @property
    def meta(self):
        return {
            "language": self._language,
            "vocab_size": self._vocab.vocab_size,
            "eos_id": self._eos_id,
            "bos_id": self._bos_id,
            "unk_id": self._unk_id,
            "pad_id": self._eos_id,
            "padding_mode": (PaddingMode.EOS_AS_PADDING
                             if self._eos_id == self._pad_id
                             else PaddingMode.DEFAULT),
        }

    def preprocess(self, input):
        input = self.text_pre_normalize(self._language, input,
                                        is_processed=False)
        if self._tokenizer:
            input = self._tokenizer.tokenize(input, return_str=True)
        if self._subtokenizer:
            input = self._subtokenizer.tokenize(input, return_str=True)
        return input

    def postprocess(self, input):
        output = input
        if self._subtokenizer is not None:
            output = self._subtokenizer.detokenize(output, return_str=True)
        if self._tokenizer is not None:
            output = self._tokenizer.detokenize(output, return_str=True)
        return output

    def encode(self, input, is_processed=False):
        """Text -> token ids, appending EOS."""
        if not is_processed:
            input = self.preprocess(input)
        if isinstance(input, str):
            input = input.split()
        token_ids = self._vocab.map_token_to_id(
            input, unknown_default=self._unk_id)
        if self._reverse_sequence:
            token_ids = token_ids[::-1]
        return token_ids + [self._eos_id]

    def decode(self, input):
        """Token ids -> recovered text (strip BOS, stop at EOS)."""
        input = [int(x) for x in input]
        if input and input[0] == self._bos_id:
            input = input[1:]
        if self._eos_id in input:
            input = input[:input.index(self._eos_id)]
        token_list = self._vocab.map_id_to_token(input)
        if self._reverse_sequence:
            token_list = token_list[::-1]
        return self.postprocess(" ".join(token_list))
