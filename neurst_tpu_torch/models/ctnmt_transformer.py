"""CTNMT: BERT-fused NMT (Yang et al., AAAI'20; counterpart of
``neurst_tpu/models/ctnmt_transformer.py``).

A Transformer with a BERT trunk (``models/bert.BertModule``, the ``bert``
sub-module) over the source tokens; ``bert_mode`` picks how the two meet:

* ``dynamic_switch``: g = sigmoid(W bert + U enc) (``ds_gate_w`` with a
  bias, ``ds_gate_u`` without), fused = g bert + (1 - g) enc;
* ``bert_as_encoder``: the trunk is the encoder; the model has no MT
  encoder and no source embedding;
* ``bert_distillation``: the MT encoder alone feeds the decoder; a
  training forward returns {"logits", "kd_student_states",
  "kd_teacher_states" (detached), "kd_padding"} for
  ``label_smoothed_cross_entropy_with_kd``, and inference skips BERT.

The trunk's dropout rate is BertModule's default, 0.1, whatever the
model's flags, as in the JAX model.  The recipes freeze it
(``freeze_variables: bert``) or ramp its updates
(``rate_scheduled_pattern: bert``).  The module overrides the teacher
forcing forward, so, as in the JAX package
(``neurst_tpu/models/encoder_decoder_model.py:394-395``), it never takes
the fused projection + cross-entropy path.
"""

import torch

from neurst_tpu_torch.layers.common_layers import linear
from neurst_tpu_torch.layers.layer_utils import input_length_to_padding
from neurst_tpu_torch.models.bert import BertModule
from neurst_tpu_torch.models.model import register_model
from neurst_tpu_torch.models.transformer import Transformer
from neurst_tpu_torch.utils.flags_core import Flag
from neurst_tpu_torch.utils.hparams_sets import register_hparams_set

__all__ = ["CtnmtTransformer"]

_MODES = ("bert_as_encoder", "dynamic_switch", "bert_distillation")


@register_model("ctnmt")
class CtnmtTransformer(Transformer):

    def __init__(self, args, src_meta, trg_meta):
        mode = args.get("bert_mode") or "dynamic_switch"
        if mode not in _MODES:
            raise ValueError(f"bert_mode must be one of {_MODES}, got {mode}")
        # set before the base class builds the source side, which
        # ``token_source`` below decides
        self.bert_mode = mode
        super().__init__(args, src_meta, trg_meta)
        self.bert = BertModule(dtype=self.dtype, **self.bert_config())
        if mode == "dynamic_switch":
            dim = args.get("modality.source.dim") or args["modality.dim"]
            self.ds_gate_w = torch.nn.Linear(dim, dim)
            self.ds_gate_u = torch.nn.Linear(dim, dim, bias=False)
        self._has_dropout = self._has_dropout or self.bert.dropout_rate > 0

    @property
    def token_source(self):
        """bert_as_encoder embeds no source tokens of its own."""
        return self.bert_mode != "bert_as_encoder"

    @staticmethod
    def class_or_method_args():
        return Transformer.class_or_method_args() + [
            Flag("bert_mode", dtype=Flag.TYPE.STRING,
                 default="dynamic_switch", choices=list(_MODES),
                 help="How the BERT trunk integrates with the NMT "
                      "encoder."),
            Flag("bert.num_layers", dtype=Flag.TYPE.INTEGER, default=12,
                 help="The number of BERT layers."),
            Flag("bert.hidden_size", dtype=Flag.TYPE.INTEGER, default=None,
                 help="The BERT hidden size (defaults to modality.dim)."),
            Flag("bert.num_attention_heads", dtype=Flag.TYPE.INTEGER,
                 default=12, help="The number of BERT attention heads."),
            Flag("bert.filter_size", dtype=Flag.TYPE.INTEGER, default=3072,
                 help="The BERT ffn filter size."),
            Flag("bert.max_positions", dtype=Flag.TYPE.INTEGER, default=512,
                 help="The BERT maximum positions."),
        ]

    def bert_config(self) -> dict:
        """BertModule's arguments, as the JAX model's ``bert_cfg``."""
        a = self.args
        return {
            "vocab_size": self.src_meta["vocab_size"],
            "num_layers": a.get("bert.num_layers") or 12,
            "hidden_size": a.get("bert.hidden_size")
            or a.get("modality.source.dim") or a.get("modality.dim"),
            "num_attention_heads": a.get("bert.num_attention_heads") or 12,
            "filter_size": a.get("bert.filter_size") or 3072,
            "max_positions": a.get("bert.max_positions") or 512,
        }

    def build_encoder(self, args):
        if self.bert_mode == "bert_as_encoder":
            return None
        return super().build_encoder(args)

    def encode_states(self, inputs, is_training=False, dropout_key=None):
        """(fused encoder states, source padding, BERT states or None).
        In bert_distillation mode BERT runs only in training."""
        self._check_training(is_training, dropout_key)
        inputs = self._as_tensors(inputs)
        src = inputs["src"]
        if inputs.get("src_padding") is not None:
            padding = inputs["src_padding"].float()
        else:
            padding = input_length_to_padding(inputs["src_length"],
                                              src.shape[1])
        bert_out = None
        if self.bert_mode != "bert_distillation" or is_training:
            bert_out = self.bert({"src": src, "src_padding": padding},
                                 is_training, dropout_key)["encoder_outputs"]
        if self.bert_mode == "bert_as_encoder":
            return bert_out, padding, bert_out
        enc = self.encoder(self.src_modality(src), padding, is_training,
                           dropout_key)
        if self.bert_mode == "dynamic_switch":
            gate = torch.sigmoid(linear(self.ds_gate_w, bert_out, self.dtype)
                                 + linear(self.ds_gate_u, enc, self.dtype))
            enc = gate * bert_out + (1.0 - gate) * enc
        return enc, padding, bert_out

    def encode(self, inputs, is_training=False, dropout_key=None):
        enc, padding, _ = self.encode_states(inputs, is_training,
                                             dropout_key)
        return enc, padding

    def forward(self, inputs, is_training=False, return_prelogits=False,
                dropout_key=None):
        if return_prelogits:
            raise ValueError("CTNMT has no prelogits path: "
                             "supports_fused_softmax_ce is False")
        enc, padding, bert_out = self.encode_states(inputs, is_training,
                                                    dropout_key)
        dec_out = self.teacher_force(
            self.decoder, self.trg_modality, inputs["trg_input"], enc,
            padding, is_training, dropout_key)
        logits = self.output_logits(dec_out)
        if self.bert_mode == "bert_distillation" and is_training:
            return {"logits": logits, "kd_student_states": enc,
                    "kd_teacher_states": bert_out.detach(),
                    "kd_padding": padding}
        return logits

    def supports_fused_softmax_ce(self) -> bool:
        """False: the JAX package fuses only the stock teacher forcing
        forward, which this model overrides."""
        return False

    @classmethod
    def build_model_args_by_name(cls, name):
        """``ctnmt_toy`` / ``_base`` / ``_big`` / ``_big_dp01``: the JAX
        package's families (BERT base 12 x 768 / 12 heads, large 24 x
        1024 / 16 heads)."""
        # (dmodel, heads, enc, dec, filter, dropout, bert dims)
        families = {
            "ctnmt_toy": (8, 2, 2, 2, 10, 0.1, (2, 8, 2, 32)),
            "ctnmt_base": (768, 12, 12, 12, 3072, 0.2,
                           (12, 768, 12, 3072)),
            "ctnmt_big": (1024, 16, 12, 12, 4096, 0.3,
                          (24, 1024, 16, 4096)),
            "ctnmt_big_dp01": (1024, 16, 12, 12, 4096, 0.1,
                               (24, 1024, 16, 4096)),
        }
        if name not in families:
            return None
        (dmodel, heads, enc, dec, filt, dp,
         (b_l, b_d, b_h, b_f)) = families[name]
        params = {
            "bert_mode": "dynamic_switch",
            "modality.share_source_target_embedding": False,
            "modality.share_embedding_and_softmax_weights": True,
            "modality.dim": dmodel,
            "modality.timing": "sinusoids",
            "bert.num_layers": b_l,
            "bert.hidden_size": b_d,
            "bert.num_attention_heads": b_h,
            "bert.filter_size": b_f,
        }
        for side, n in (("encoder", enc), ("decoder", dec)):
            params.update({
                f"{side}.num_layers": n,
                f"{side}.hidden_size": dmodel,
                f"{side}.num_attention_heads": heads,
                f"{side}.filter_size": filt,
                f"{side}.attention_dropout_rate": dp,
                f"{side}.ffn_activation": "relu",
                f"{side}.ffn_dropout_rate": dp,
                f"{side}.layer_postprocess_dropout_rate": dp,
            })
        return {
            "model.class": cls.__name__,
            "model.params": params,
            "optimizer.class": "adam",
            "optimizer.params": {
                "epsilon": 1.e-9, "beta_1": 0.9, "beta_2": 0.98},
            "lr_schedule.class": "noam",
            "lr_schedule.params": {
                "initial_factor": 1.0, "dmodel": dmodel,
                "warmup_steps": 4000},
        }


for _name in ("ctnmt_toy", "ctnmt_base", "ctnmt_big", "ctnmt_big_dp01"):
    register_hparams_set(_name)(
        lambda _n=_name: CtnmtTransformer.build_model_args_by_name(_n))
