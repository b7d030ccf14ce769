"""The LightConvolutionModel (Pay Less Attention, ICLR'19; counterpart
of ``neurst_tpu/models/light_convolution_model.py``): token embeddings,
a lightweight or dynamic convolution encoder, a decoder of causal
convolutions with cross-attention, and the softmax.

Hparams sets: ``lightconv_base``, ``lightconv_toy`` and (through
``build_model_args_by_name``) ``dynamicconv_base``.
"""

import inspect
import logging

import yaml

from neurst_tpu_torch.layers.decoders.light_convolution_decoder import \
    LightConvolutionDecoder
from neurst_tpu_torch.layers.encoders.light_convolution_encoder import \
    LightConvolutionEncoder
from neurst_tpu_torch.models.encoder_decoder_model import (
    EncoderDecoderModel, _stack_kwargs)
from neurst_tpu_torch.models.model import register_model
from neurst_tpu_torch.utils.flags_core import Flag
from neurst_tpu_torch.utils.hparams_sets import register_hparams_set

__all__ = ["LightConvolutionModel"]


def _side_flags(prefix):
    return [
        Flag(f"{prefix}.num_layers", dtype=Flag.TYPE.INTEGER, default=None,
             help=f"The number of {prefix} layers."),
        Flag(f"{prefix}.hidden_size", dtype=Flag.TYPE.INTEGER, default=None,
             help=f"The {prefix} hidden size."),
        Flag(f"{prefix}.num_heads", dtype=Flag.TYPE.INTEGER, default=None,
             help="The number of conv weight groups."),
        Flag(f"{prefix}.filter_size", dtype=Flag.TYPE.INTEGER, default=None,
             help=f"The {prefix} ffn filter size."),
        Flag(f"{prefix}.kernel_sizes", dtype=Flag.TYPE.STRING, default=None,
             help="Per-layer conv kernel sizes (YAML list)."),
        Flag(f"{prefix}.conv_type", dtype=Flag.TYPE.STRING,
             default="lightweight",
             help="The conv type: lightweight or dynamic."),
        Flag(f"{prefix}.use_glu", dtype=Flag.TYPE.BOOLEAN, default=True,
             help="Whether to use a GLU input projection."),
        Flag(f"{prefix}.ffn_activation", dtype=Flag.TYPE.STRING,
             default="relu", help="The ffn activation."),
        Flag(f"{prefix}.weight_dropout_rate", dtype=Flag.TYPE.FLOAT,
             default=0., help="The conv weight dropout rate."),
        Flag(f"{prefix}.attention_dropout_rate", dtype=Flag.TYPE.FLOAT,
             default=0., help="The cross-attention dropout rate."),
        Flag(f"{prefix}.ffn_dropout_rate", dtype=Flag.TYPE.FLOAT,
             default=0., help="The ffn dropout rate."),
        Flag(f"{prefix}.layer_postprocess_dropout_rate",
             dtype=Flag.TYPE.FLOAT, default=0.,
             help="The residual dropout rate."),
        Flag(f"{prefix}.post_normalize", dtype=Flag.TYPE.BOOLEAN,
             default=False, help="Post-norm instead of pre-norm."),
        Flag(f"{prefix}.layer_postprocess_epsilon", dtype=Flag.TYPE.FLOAT,
             default=1e-6, help="The layer-norm epsilon."),
    ]


def _conv_kwargs(stack_cls, args, prefix):
    """The stack's keyword arguments from the ``prefix`` flags; the
    kernel sizes may be a list or its YAML text.  Keys the stack does not
    take (a Transformer config's ``num_attention_heads``, say) are dropped
    with a warning, as the JAX module's ``filter_fields`` drops them."""
    accepted = set(inspect.signature(stack_cls.__init__).parameters)
    dropped = sorted(k[len(prefix):] for k, v in args.items()
                     if k.startswith(prefix) and v is not None
                     and k[len(prefix):] not in accepted)
    if dropped:
        logging.warning("%s ignoring config keys: %s", stack_cls.__name__,
                        dropped)
    kwargs = _stack_kwargs(stack_cls, {
        k: v for k, v in args.items()
        if not k.startswith(prefix) or k[len(prefix):] in accepted}, prefix)
    kernels = kwargs.get("kernel_sizes")
    if isinstance(kernels, str):
        kernels = yaml.safe_load(kernels)
    if kernels:
        kwargs["kernel_sizes"] = tuple(int(k) for k in kernels)
    else:
        kwargs.pop("kernel_sizes", None)
    return kwargs


@register_model("light_convolution_model", "lightconv")
class LightConvolutionModel(EncoderDecoderModel):

    @staticmethod
    def class_or_method_args():
        return (EncoderDecoderModel.class_or_method_args()
                + _side_flags("encoder") + _side_flags("decoder"))

    def build_encoder(self, args):
        return LightConvolutionEncoder(
            **_conv_kwargs(LightConvolutionEncoder, args, "encoder."),
            dtype=self.dtype)

    def build_decoder(self, args):
        return LightConvolutionDecoder(
            **_conv_kwargs(LightConvolutionDecoder, args, "decoder."),
            dtype=self.dtype)

    def beam_cache_indirection_ok(self) -> bool:
        """The convolution buffers have no self-attention state to read
        through an ancestor matrix: beam search reorders the cache."""
        return False

    @classmethod
    def build_model_args_by_name(cls, name):
        if name not in ("lightconv_base", "lightconv_toy",
                        "dynamicconv_base"):
            return None
        toy = name == "lightconv_toy"
        dmodel = 8 if toy else 512
        heads = 2 if toy else 8
        filter_size = 16 if toy else 2048
        layers = 2 if toy else 7
        dec_layers = 2 if toy else 6
        conv_type = "dynamic" if name.startswith("dynamic") \
            else "lightweight"
        kernels = [3, 7] if toy else [3, 7, 15, 31, 31, 31, 31]
        return {
            "model.class": cls.__name__,
            "model.params": {
                "modality.share_source_target_embedding": False,
                "modality.share_embedding_and_softmax_weights": True,
                "modality.dim": dmodel,
                "modality.timing": "sinusoids",
                "encoder.num_layers": layers,
                "encoder.hidden_size": dmodel,
                "encoder.num_heads": heads,
                "encoder.filter_size": filter_size,
                "encoder.kernel_sizes": kernels,
                "encoder.conv_type": conv_type,
                "decoder.num_layers": dec_layers,
                "decoder.hidden_size": dmodel,
                "decoder.num_heads": heads,
                "decoder.filter_size": filter_size,
                "decoder.kernel_sizes": kernels[:dec_layers],
                "decoder.conv_type": conv_type,
            },
            "optimizer.class": "adam",
            "optimizer.params": {
                "epsilon": 1.e-9, "beta_1": 0.9, "beta_2": 0.98},
            "lr_schedule.class": "noam",
            "lr_schedule.params": {
                "initial_factor": 1.0, "dmodel": dmodel,
                "warmup_steps": 4000},
        }


for _name in ("lightconv_base", "lightconv_toy"):
    register_hparams_set(_name)(
        lambda _n=_name: LightConvolutionModel.build_model_args_by_name(_n))
