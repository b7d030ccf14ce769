"""The BERT encoder trunk (counterpart of ``neurst_tpu/models/bert.py``).

Word + learned position + token-type embeddings, a LayerNorm over their
sum (``emb_ln``, epsilon 1e-12), a post-norm ``TransformerEncoder`` with
the exact (erf) gelu whose every LayerNorm takes the same epsilon, and a
tanh pooler over position 0.  CTNMT (``models/ctnmt_transformer.py``)
runs it as its ``bert`` sub-module (``BertModule``); ``Bert`` is the
registry model, with the parameters at its root.

Parameter names are the JAX module's: ``word_embedding``,
``position_embedding``, ``token_type_embedding`` (tables, drawn from
normal(0.02)), ``emb_ln``, ``encoder/layer_<i>/...`` and ``pooler``.
The encoder draws its dropout masks from ``SIDE_BERT``'s streams.
"""

import torch
from torch import nn

from neurst_tpu_torch.layers.common_layers import LayerNorm, linear
from neurst_tpu_torch.layers.encoders.transformer_encoder import \
    TransformerEncoder
from neurst_tpu_torch.models.model import (BaseModel, dtype_by_name,
                                           register_model)
from neurst_tpu_torch.utils.flags_core import Flag
from neurst_tpu_torch.utils.rng import SIDE_BERT

__all__ = ["BertModule", "Bert"]


class _BertTrunk(object):
    """The trunk's layers and forward, on the module that owns them (the
    CTNMT's ``bert`` sub-module, or the ``Bert`` model itself, whose
    parameters sit at the root as in the JAX model)."""

    def _build_trunk(self, vocab_size: int, hidden_size: int = 768,
                     num_layers: int = 12, num_attention_heads: int = 12,
                     filter_size: int = 3072, max_positions: int = 512,
                     num_token_types: int = 2, dropout_rate: float = 0.1,
                     epsilon: float = 1e-12, dtype=torch.float32):
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.word_embedding = nn.Parameter(
            torch.empty(vocab_size, hidden_size))
        self.position_embedding = nn.Parameter(
            torch.empty(max_positions, hidden_size))
        self.token_type_embedding = nn.Parameter(
            torch.empty(num_token_types, hidden_size))
        self.emb_ln = LayerNorm(hidden_size, epsilon, dtype)
        self.encoder = TransformerEncoder(
            num_layers, hidden_size, num_attention_heads, filter_size,
            ffn_activation="gelu", post_normalize=True,
            layer_postprocess_epsilon=epsilon,
            attention_dropout_rate=dropout_rate,
            ffn_dropout_rate=dropout_rate,
            layer_postprocess_dropout_rate=dropout_rate, dtype=dtype,
            side=SIDE_BERT)
        self.pooler = nn.Linear(hidden_size, hidden_size)

    def init_own_params(self, generator):
        """flax's ``normal(0.02)`` for the three tables."""
        for table in (self.word_embedding, self.position_embedding,
                      self.token_type_embedding):
            table.copy_(torch.randn(table.shape, generator=generator) * 0.02)

    def run_trunk(self, inputs, is_training=False, dropout_key=None):
        """inputs: src [B, T] (+ src_padding [B, T], segment_ids [B, T]).
        Returns {"encoder_outputs" [B, T, D], "pooled_output" [B, D]}."""
        ids = inputs["src"]
        padding = inputs.get("src_padding")
        if padding is None:
            padding = torch.zeros(ids.shape, dtype=torch.float32,
                                  device=ids.device)
        segment = inputs.get("segment_ids")
        if segment is None:
            segment = torch.zeros_like(ids)
        emb = self.word_embedding[ids].to(self.dtype)
        emb = emb + self.position_embedding[:ids.shape[1]].to(
            self.dtype)[None]
        emb = emb + self.token_type_embedding[segment].to(self.dtype)
        emb = self.emb_ln(emb)
        enc = self.encoder(emb, padding.float(), is_training, dropout_key)
        pooled = torch.tanh(linear(self.pooler, enc[:, 0, :], self.dtype))
        return {"encoder_outputs": enc, "pooled_output": pooled}


class BertModule(_BertTrunk, nn.Module):
    """The trunk as a sub-module (CTNMT's ``bert``)."""

    def __init__(self, vocab_size: int, **kwargs):
        nn.Module.__init__(self)
        self._build_trunk(vocab_size, **kwargs)

    def forward(self, inputs, is_training=False, dropout_key=None):
        return self.run_trunk(inputs, is_training, dropout_key)


@register_model("bert")
class Bert(_BertTrunk, BaseModel):

    def __init__(self, args, src_meta, trg_meta):
        BaseModel.__init__(self, args)
        self.meta = dict(src_meta or trg_meta or {})
        a = self.args
        # ``or`` as in the JAX model: a dropout_rate of 0 takes 0.1
        self._build_trunk(
            vocab_size=self.meta["vocab_size"],
            hidden_size=a.get("hidden_size") or 768,
            num_layers=a.get("num_layers") or 12,
            num_attention_heads=a.get("num_attention_heads") or 12,
            filter_size=a.get("filter_size") or 3072,
            max_positions=a.get("max_positions") or 512,
            num_token_types=a.get("num_token_types") or 2,
            dropout_rate=a.get("dropout_rate") or 0.1,
            dtype=dtype_by_name(a.get("dtype")))

    @staticmethod
    def class_or_method_args():
        return [
            Flag("num_layers", dtype=Flag.TYPE.INTEGER, default=12,
                 help="The number of encoder blocks."),
            Flag("hidden_size", dtype=Flag.TYPE.INTEGER, default=768,
                 help="The model dimension."),
            Flag("num_attention_heads", dtype=Flag.TYPE.INTEGER, default=12,
                 help="The number of attention heads."),
            Flag("filter_size", dtype=Flag.TYPE.INTEGER, default=3072,
                 help="The FFN filter size."),
            Flag("max_positions", dtype=Flag.TYPE.INTEGER, default=512,
                 help="The maximum sequence positions."),
            Flag("num_token_types", dtype=Flag.TYPE.INTEGER, default=2,
                 help="The number of token (segment) types."),
            Flag("dropout_rate", dtype=Flag.TYPE.FLOAT, default=0.1,
                 help="The dropout rate."),
            Flag("dtype", dtype=Flag.TYPE.STRING, default="bfloat16",
                 help="The computation dtype."),
        ]

    def forward(self, inputs, is_training=False,
                dropout_key=None):
        """inputs: src [B, T] (+ src_padding, segment_ids) ->
        {"encoder_outputs", "pooled_output"}."""
        if is_training and dropout_key is None:
            raise ValueError("training BERT (dropout > 0) needs a dropout "
                             "key (utils.rng.DropoutKey)")
        tensors = {k: torch.as_tensor(v, device=self.device)
                   for k, v in inputs.items() if v is not None}
        return self.run_trunk(tensors, is_training, dropout_key)
