"""The joint ASR + ST speech transformer (counterpart of
``neurst_tpu/models/multi_task_speech_transformer.py``).

One conv-subsampled speech encoder is shared by the translation decoder
(``decoder`` over ``target_symbol_modality``, the primary head) and a
transcript decoder (``asr_decoder`` over ``asr_symbol_modality``, a tied
embedding and softmax over the transcript vocabulary).  The transcript
decoder is built from the ``asr_decoder.*`` flags, or from the
``decoder.*`` ones where none is given.  Training optimizes both heads
through ``joint_criterion`` (``output_key: st|asr``, ``input_prefix:
asr``).

Training inputs (``MultiTaskSpeechTranslation`` batches):
    src, src_length                                 audio
    trg_input, trg, trg_length, trg_padding         translation
    asr_trg_input, asr_trg, asr_trg_length, asr_trg_padding  transcript

``forward`` returns ``{"st": logits, "asr": logits}`` where the inputs
hold ``asr_trg_input``, else the translation logits alone.  Stepwise
generation decodes the translation, or the transcript with
``generation_output: asr`` (its cache, decoder, logits and eos / bos /
unk ids), over the one shared encoder pass.

The transcript decoder draws its dropout masks from its own side of the
key's streams (``utils.rng.SIDE_ASR_DECODER``), so its masks are not the
translation decoder's at the same layer and site.
"""

from neurst_tpu_torch.layers.common_layers import WordEmbedding
from neurst_tpu_torch.layers.decoders.transformer_decoder import \
    TransformerDecoder
from neurst_tpu_torch.models.encoder_decoder_model import _stack_kwargs
from neurst_tpu_torch.models.model import register_model
from neurst_tpu_torch.models.speech_transformer import SpeechTransformer
from neurst_tpu_torch.utils.flags_core import Flag
from neurst_tpu_torch.utils.rng import SIDE_ASR_DECODER

__all__ = ["MultiTaskSpeechTransformer"]

_DROPOUT_RATES = ("attention_dropout_rate", "ffn_dropout_rate",
                  "layer_postprocess_dropout_rate")


@register_model("multi_task_speech_transformer")
class MultiTaskSpeechTransformer(SpeechTransformer):

    def __init__(self, args, src_meta, trg_meta, asr_meta=None):
        super().__init__(args, src_meta, trg_meta)
        self.asr_meta = dict(asr_meta or trg_meta or {})
        self.asr_symbol_modality = WordEmbedding(
            self.asr_meta.get("vocab_size", self.trg_meta["vocab_size"]),
            args.get("modality.target.dim") or args["modality.dim"],
            share_softmax_weights=True,
            timing=(args.get("modality.target.timing")
                    or args.get("modality.timing")),
            max_positions=args.get("modality.max_positions") or 1024,
            dtype=self.dtype)
        prefix = "asr_decoder." if any(
            k.startswith("asr_decoder.") and v is not None
            for k, v in args.items()) else "decoder."
        self.asr_decoder = TransformerDecoder(
            **_stack_kwargs(TransformerDecoder, {
                k: v for k, v in args.items()
                if k != prefix + "attention_monotonic"}, prefix),
            dtype=self.dtype, side=SIDE_ASR_DECODER)
        self._has_dropout = self._has_dropout or any(
            float(args.get(f"{prefix}{rate}") or 0.0) > 0.0
            for rate in _DROPOUT_RATES)

    @staticmethod
    def class_or_method_args():
        return SpeechTransformer.class_or_method_args() + [
            Flag("generation_output", dtype=Flag.TYPE.STRING, default="st",
                 choices=["st", "asr"],
                 help="Which decoder drives stepwise generation: the "
                      "translation (st) or the transcript (asr) side."),
        ]

    @property
    def _generates_asr(self) -> bool:
        return (self.args.get("generation_output") or "st") == "asr"

    @property
    def generation_meta(self) -> dict:
        return self.asr_meta if self._generates_asr else self.trg_meta

    @property
    def generation_decoder(self) -> TransformerDecoder:
        return self.asr_decoder if self._generates_asr else self.decoder

    @property
    def generation_modality(self) -> WordEmbedding:
        return self.asr_symbol_modality if self._generates_asr \
            else self.trg_modality

    def generation_logits(self, dec_out):
        if self._generates_asr:
            return self.asr_symbol_modality.attend(dec_out)
        return self.output_logits(dec_out)

    def forward(self, inputs, is_training=False, return_prelogits=False,
                dropout_key=None):
        """Teacher forcing -> {"st": [B, T, V], "asr": [B, T', V']} float32
        logits, or the translation's alone without ``asr_trg_input``."""
        if return_prelogits:
            raise ValueError(
                "the fused projection + cross entropy serves one softmax "
                "and this model has two (supports_fused_softmax_ce is "
                "False)")
        enc, src_padding = self.encode(inputs, is_training, dropout_key)
        st = self.output_logits(self.teacher_force(
            self.decoder, self.trg_modality, inputs["trg_input"], enc,
            src_padding, is_training, dropout_key))
        if "asr_trg_input" not in inputs:
            return st
        asr = self.asr_symbol_modality.attend(self.teacher_force(
            self.asr_decoder, self.asr_symbol_modality,
            inputs["asr_trg_input"], enc, src_padding, is_training,
            dropout_key))
        return {"st": st, "asr": asr}

    def supports_fused_softmax_ce(self) -> bool:
        """Two softmaxes: the fused kernels serve one, so the train step
        takes the logits path (as in the JAX package)."""
        return False
