"""The Transformer (counterpart of ``neurst_tpu/models/transformer.py``):
token source and target embeddings (separate, or one shared table),
transformer encoder and decoder, tied softmax.

Inputs:
    src         int [B, S]
    src_padding float [B, S] (1.0 at PAD; from ``src_length`` if absent)
    trg_input   int [B, T]  (teacher forcing only)

Hparams sets: ``transformer_toy``, ``transformer_base``, ``transformer_s``,
``transformer_big``, ``transformer_big_dp01`` and the parametric
``transformer_<d>_<e>e_<d>d[_<h>h][_dp<p>]`` names, with the JAX
package's optimizer and noam entries.
"""

import re

from neurst_tpu_torch.models.encoder_decoder_model import (
    EncoderDecoderModel, encdec_flags)
from neurst_tpu_torch.models.model import register_model
from neurst_tpu_torch.utils.hparams_sets import register_hparams_set

__all__ = ["Transformer"]

# name -> (dmodel, heads, dropout, layers a side, filter size)
_FIXED = {
    "transformer_toy": (8, 2, 0.1, 2, 10),
    "transformer_base": (512, 8, 0.1, 6, 2048),
    "transformer_s": (256, 4, 0.1, 6, 2048),
    "transformer_big": (1024, 16, 0.3, 6, 4096),
    "transformer_big_dp01": (1024, 16, 0.1, 6, 4096),
}
_PARAMETRIC = re.compile(r"^transformer_\d+_\d+e_\d+d(_\d+h)?(_dp0\.\d+)?$")


def _parametric(name):
    """(dmodel, heads, dropout, encoder layers, decoder layers) of a
    ``transformer_<d>_<e>e_<d>d[_<h>h][_dp<p>]`` name."""
    parts = name.split("_")
    dmodel, enc_layers, dec_layers = (int(parts[1]), int(parts[2][:-1]),
                                      int(parts[3][:-1]))
    heads, dropout, idx = 8, 0.1, 4
    if len(parts) > idx and parts[idx].endswith("h"):
        heads = int(parts[idx][:-1])
        idx += 1
    if dmodel % heads:
        raise ValueError(f"dimension({dmodel}) must be divisible by "
                         f"head({heads})")
    if len(parts) > idx and parts[idx].startswith("dp"):
        dropout = float(parts[idx][2:])
    return dmodel, heads, dropout, enc_layers, dec_layers


@register_model
class Transformer(EncoderDecoderModel):
    """The standard Transformer."""

    @staticmethod
    def class_or_method_args():
        return (EncoderDecoderModel.class_or_method_args()
                + encdec_flags("encoder") + encdec_flags("decoder"))

    @classmethod
    def build_model_args_by_name(cls, name):
        if name in _FIXED:
            dmodel, heads, dropout, layers, filter_size = _FIXED[name]
            enc_layers = dec_layers = layers
        elif _PARAMETRIC.match(name):
            dmodel, heads, dropout, enc_layers, dec_layers = _parametric(name)
            filter_size = 4 * dmodel
        else:
            return None
        params = {
            "modality.share_source_target_embedding": False,
            "modality.share_embedding_and_softmax_weights": True,
            "modality.dim": dmodel,
            "modality.timing": "sinusoids",
        }
        for side, layers in (("encoder", enc_layers),
                             ("decoder", dec_layers)):
            params.update({
                f"{side}.num_layers": layers,
                f"{side}.hidden_size": dmodel,
                f"{side}.num_attention_heads": heads,
                f"{side}.filter_size": filter_size,
                f"{side}.attention_dropout_rate": dropout,
                f"{side}.attention_type": "dot_product",
                f"{side}.ffn_activation": "relu",
                f"{side}.ffn_dropout_rate": dropout,
                f"{side}.post_normalize": False,
                f"{side}.layer_postprocess_dropout_rate": dropout,
            })
        return {
            "model.class": cls.__name__, "model.params": params,
            "optimizer.class": "adam",
            "optimizer.params": {
                "epsilon": 1.e-9, "beta_1": 0.9, "beta_2": 0.98},
            "lr_schedule.class": "noam",
            "lr_schedule.params": {
                "initial_factor": 1.0, "dmodel": dmodel,
                "warmup_steps": 4000},
        }


for _name in _FIXED:
    register_hparams_set(_name)(
        lambda _n=_name: Transformer.build_model_args_by_name(_n))
