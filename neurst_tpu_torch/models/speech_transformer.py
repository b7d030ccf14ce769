"""The SpeechTransformer (counterpart of
``neurst_tpu/models/speech_transformer.py``): Conv2d-subsampling audio
modality, transformer encoder and decoder, tied softmax.

Inputs:
    src        float [B, T, feat_dim] or [B, T, feat_dim, channels]
    src_length int   [B]  (frames before subsampling)
    trg_input  int   [B, U]  (teacher forcing only)
"""

from neurst_tpu_torch.layers.layer_utils import input_length_to_padding
from neurst_tpu_torch.layers.modalities.audio_modalities import (
    AudioConv2dSubsampling, subsampled_length)
from neurst_tpu_torch.models.encoder_decoder_model import (
    EncoderDecoderModel, encdec_flags)
from neurst_tpu_torch.models.model import register_model
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["SpeechTransformer"]


@register_model
class SpeechTransformer(EncoderDecoderModel):

    def __init__(self, args, src_meta, trg_meta):
        super().__init__(args, src_meta, trg_meta)
        src_dim = args.get("modality.source.dim") or args["modality.dim"]
        self.input_audio_modality = AudioConv2dSubsampling(
            embedding_dim=src_dim,
            feature_dim=self.src_meta.get("audio_feature_dim", 80),
            feature_channels=self.src_meta.get("audio_feature_channels", 1),
            channels=args.get("modality.source.channels") or 256,
            kernel_size=args.get("modality.source.kernel_size") or 3,
            strides=args.get("modality.source.strides") or 2,
            layer_norm=bool(args.get("modality.source.layer_norm")),
            timing=(args.get("modality.source.timing")
                    or args.get("modality.timing") or "sinusoids"),
            dtype=self.dtype)

    @staticmethod
    def class_or_method_args():
        """The JAX model's flags, so a parsed config and a saved
        ``model_configs.yml`` carry the same keys in both packages."""
        return [
            Flag("modality.share_embedding_and_softmax_weights",
                 dtype=Flag.TYPE.BOOLEAN, default=False,
                 help="Whether to share the target embedding and softmax."),
            Flag("modality.dim", dtype=Flag.TYPE.INTEGER, default=None,
                 help="The default embedding dimension."),
            Flag("modality.source.dim", dtype=Flag.TYPE.INTEGER,
                 default=None, help="The source-side embedding dimension."),
            Flag("modality.target.dim", dtype=Flag.TYPE.INTEGER,
                 default=None, help="The target-side embedding dimension."),
            Flag("modality.timing", dtype=Flag.TYPE.STRING, default=None,
                 help="The position embedding type."),
            Flag("modality.source.timing", dtype=Flag.TYPE.STRING,
                 default=None, help="The source position embedding type."),
            Flag("modality.target.timing", dtype=Flag.TYPE.STRING,
                 default=None, help="The target position embedding type."),
            Flag("modality.source.kernel_size", dtype=Flag.TYPE.INTEGER,
                 default=3, help="The conv kernel size."),
            Flag("modality.source.strides", dtype=Flag.TYPE.INTEGER,
                 default=2, help="The conv stride."),
            Flag("modality.source.channels", dtype=Flag.TYPE.INTEGER,
                 default=256, help="The conv channels."),
            Flag("modality.source.layer_norm", dtype=Flag.TYPE.BOOLEAN,
                 default=False, help="LayerNorm inside conv blocks."),
            Flag("modality.max_positions", dtype=Flag.TYPE.INTEGER,
                 default=1024, help="Max positions for learned pos emb."),
            Flag("dtype", dtype=Flag.TYPE.STRING, default="bfloat16",
                 help="The computation dtype."),
        ] + encdec_flags("encoder") + encdec_flags("decoder")

    def embed_source(self, inputs):
        src = inputs["src"]
        if src.dim() == 3:
            src = src[..., None]
        mod = self.input_audio_modality
        emb = mod(src)
        sub_len = subsampled_length(inputs["src_length"], mod.num_layers,
                                    mod.strides)
        return emb, input_length_to_padding(sub_len, emb.shape[1])

    @classmethod
    def build_model_args_by_name(cls, name):
        if name not in ("speech_transformer_toy", "speech_transformer_s",
                        "speech_transformer_m"):
            return None
        if name == "speech_transformer_toy":
            dmodel, num_heads, dropout = 16, 2, 0.1
            enc_layers, dec_layers, filter_size, channels = 2, 2, 32, 8
        elif name == "speech_transformer_s":
            dmodel, num_heads, dropout = 256, 4, 0.1
            enc_layers, dec_layers, filter_size, channels = 12, 6, 2048, 256
        else:
            dmodel, num_heads, dropout = 512, 8, 0.1
            enc_layers, dec_layers, filter_size, channels = 12, 6, 2048, 256
        params = {
            "modality.share_embedding_and_softmax_weights": True,
            "modality.dim": dmodel,
            "modality.timing": "sinusoids",
            "modality.source.channels": channels,
            "modality.source.kernel_size": 3,
            "modality.source.strides": 2,
            "modality.source.layer_norm": True,
        }
        for side, layers in (("encoder", enc_layers),
                             ("decoder", dec_layers)):
            params.update({
                f"{side}.num_layers": layers,
                f"{side}.hidden_size": dmodel,
                f"{side}.num_attention_heads": num_heads,
                f"{side}.filter_size": filter_size,
                f"{side}.attention_dropout_rate": dropout,
                f"{side}.ffn_activation": "relu",
                f"{side}.ffn_dropout_rate": dropout,
                f"{side}.layer_postprocess_dropout_rate": dropout,
            })
        return {
            "model.class": cls.__name__, "model.params": params,
            "optimizer.class": "adam",
            "optimizer.params": {
                "epsilon": 1.e-9, "beta_1": 0.9, "beta_2": 0.98},
            "lr_schedule.class": "noam",
            "lr_schedule.params": {
                "initial_factor": 5.0 if dmodel > 256 else 3.5,
                "end_factor": 2.0 if dmodel > 256 else 1.5,
                "dmodel": dmodel,
                "warmup_steps": 25000,
                "start_decay_at": 50000,
                "decay_steps": 50000,
            },
        }
