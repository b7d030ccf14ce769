"""Encoder-decoder sequence model (counterpart of
``neurst_tpu/models/encoder_decoder_model.py``: ``Seq2SeqModule`` and
``EncoderDecoderModel`` in one ``nn.Module``).

The source side is token ids through a word embedding, as in the JAX
module (``input_symbol_modality``, or one ``shared_symbol_modality`` for
both sides with ``modality.share_source_target_embedding``); a subclass
with another source (the speech model's audio) sets ``token_source`` to
False and overrides ``embed_source``; one with other stacks overrides
``build_encoder`` / ``build_decoder``.  This class also holds the target
modality with the tied softmax (or, with
``modality.share_embedding_and_softmax_weights: false``, the
``output_linear`` projection), the encoder and the decoder, the
generation interface the searches drive
(``prepare_generation`` -> (``decode_step``, generation initializer);
``prepare_speculative`` -> (``decode_steps``, the same initializer)),
and the training interface the train step drives (``call_train``,
``supports_fused_softmax_ce``).  Training with dropout > 0 takes a
dropout key (``utils/rng.DropoutKey``), as the JAX model takes its
'dropout' rng, and raises without one.
"""

import inspect
from typing import Any, Dict

import torch

from neurst_tpu_torch.layers.common_layers import WordEmbedding, linear
from neurst_tpu_torch.layers.decoders.transformer_decoder import \
    TransformerDecoder
from neurst_tpu_torch.layers.encoders.transformer_encoder import \
    TransformerEncoder
from neurst_tpu_torch.layers.layer_utils import input_length_to_padding
from neurst_tpu_torch.models.model import BaseModel, dtype_by_name
from neurst_tpu_torch.ops.fused_ce import fused_linear_ce_available
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["EncoderDecoderModel", "encdec_flags"]

# config keys that only matter to the JAX layouts: the port runs the
# per-layer stack (param_bridge unstacks scanned checkpoints); options
# whose switch is off need no support
_LAYOUT_IGNORED = {
    "scan_layers", "pipeline_stages", "pipeline_microbatches",
    "ring_attention_axis", "moe_layer_frequency", "moe_top_k",
    "moe_capacity_factor", "moe_aux_loss_coef", "moe_router_jitter"}


def encdec_flags(prefix):
    """The per-side transformer flags of the JAX package
    (``neurst_tpu/models/transformer.py:31``).  Options the port lacks
    default to off and raise ``NotImplementedError`` when switched on."""
    flags = [
        Flag(f"{prefix}.num_layers", dtype=Flag.TYPE.INTEGER, default=None,
             help=f"The number of stacking layers of the {prefix}."),
        Flag(f"{prefix}.hidden_size", dtype=Flag.TYPE.INTEGER, default=None,
             help=f"The number of hidden units of the {prefix}."),
        Flag(f"{prefix}.num_attention_heads", dtype=Flag.TYPE.INTEGER,
             default=None, help=f"The number of {prefix} attention heads."),
        Flag(f"{prefix}.filter_size", dtype=Flag.TYPE.INTEGER, default=None,
             help=f"The filter size of {prefix} ffn."),
        Flag(f"{prefix}.ffn_activation", dtype=Flag.TYPE.STRING,
             default="relu", help=f"The {prefix} ffn activation function."),
        Flag(f"{prefix}.attention_dropout_rate", dtype=Flag.TYPE.FLOAT,
             default=0., help=f"The {prefix} attention dropout rate."),
        Flag(f"{prefix}.attention_type", dtype=Flag.TYPE.STRING,
             default="dot_product", help=f"The {prefix} attention type."),
        Flag(f"{prefix}.ffn_dropout_rate", dtype=Flag.TYPE.FLOAT, default=0.,
             help=f"The {prefix} ffn dropout rate."),
        Flag(f"{prefix}.layer_postprocess_dropout_rate",
             dtype=Flag.TYPE.FLOAT, default=0.,
             help=f"The {prefix} layer postprocess dropout rate."),
        Flag(f"{prefix}.post_normalize", dtype=Flag.TYPE.BOOLEAN,
             default=False,
             help=f"Whether to apply layer norm after each {prefix} block."),
        Flag(f"{prefix}.layer_postprocess_epsilon", dtype=Flag.TYPE.FLOAT,
             default=1e-6, help=f"The {prefix} layer norm epsilon."),
    ]
    switches = ["attention_monotonic", "enable_flash_attention",
                "enable_ring_attention", "scan_layers"] \
        if prefix == "encoder" else ["scan_layers", "enable_flash_attention"]
    flags += [Flag(f"{prefix}.{name}", dtype=Flag.TYPE.BOOLEAN, default=None,
                   help=f"The JAX package's {prefix} {name} switch.")
              for name in switches]
    if prefix == "encoder":
        flags.append(Flag("encoder.ring_attention_axis",
                          dtype=Flag.TYPE.STRING, default="data",
                          help="The mesh axis of ring attention."))
    flags += [Flag(f"{prefix}.{name}", dtype=dtype, default=None,
                   help=f"The JAX package's {prefix} {name} setting.")
              for name, dtype in (
                  ("pipeline_stages", Flag.TYPE.INTEGER),
                  ("pipeline_microbatches", Flag.TYPE.INTEGER),
                  ("moe_num_experts", Flag.TYPE.INTEGER),
                  ("moe_layer_frequency", Flag.TYPE.INTEGER),
                  ("moe_top_k", Flag.TYPE.INTEGER),
                  ("moe_capacity_factor", Flag.TYPE.FLOAT),
                  ("moe_aux_loss_coef", Flag.TYPE.FLOAT),
                  ("moe_router_jitter", Flag.TYPE.FLOAT))]
    return flags


def _stack_kwargs(stack_cls, args: Dict[str, Any], prefix: str) -> dict:
    accepted = set(inspect.signature(stack_cls.__init__).parameters)
    out = {}
    for key, value in args.items():
        if not key.startswith(prefix) or value is None:
            continue
        sub = key[len(prefix):]
        if sub == "attention_type":
            if value != "dot_product":
                raise NotImplementedError(f"{key}={value} is not ported")
        elif sub in accepted:
            out[sub] = value
        elif sub in _LAYOUT_IGNORED or not value:
            continue
        else:
            raise NotImplementedError(f"{key}={value} is not ported")
    return out


class EncoderDecoderModel(BaseModel):

    # whether the source is token ids (a word embedding); the speech
    # model's is audio
    token_source = True

    @staticmethod
    def class_or_method_args():
        """The JAX model's flags
        (``neurst_tpu/models/encoder_decoder_model.py:279-305``)."""
        return [
            Flag("modality.share_source_target_embedding",
                 dtype=Flag.TYPE.BOOLEAN, default=False,
                 help="Whether to share source and target embedding "
                      "table."),
            Flag("modality.share_embedding_and_softmax_weights",
                 dtype=Flag.TYPE.BOOLEAN, default=False,
                 help="Whether to share the embedding table and softmax "
                      "weights."),
            Flag("modality.dim", dtype=Flag.TYPE.INTEGER, default=None,
                 help="The default embedding dimension."),
            Flag("modality.source.dim", dtype=Flag.TYPE.INTEGER,
                 default=None, help="The source-side embedding dimension."),
            Flag("modality.target.dim", dtype=Flag.TYPE.INTEGER,
                 default=None, help="The target-side embedding dimension."),
            Flag("modality.timing", dtype=Flag.TYPE.STRING, default=None,
                 help="The position embedding type (sinusoids/emb)."),
            Flag("modality.source.timing", dtype=Flag.TYPE.STRING,
                 default=None, help="The source-side position embedding "
                                    "type."),
            Flag("modality.target.timing", dtype=Flag.TYPE.STRING,
                 default=None, help="The target-side position embedding "
                                    "type."),
            Flag("modality.max_positions", dtype=Flag.TYPE.INTEGER,
                 default=1024,
                 help="The maximum positions for learned position "
                      "embedding."),
            Flag("dtype", dtype=Flag.TYPE.STRING, default="bfloat16",
                 help="The computation dtype (params stay float32)."),
        ]

    def __init__(self, args, src_meta, trg_meta):
        super().__init__(args)
        self.src_meta = dict(src_meta or {})
        self.trg_meta = dict(trg_meta or {})
        self.dtype = dtype_by_name(args.get("dtype"))
        self.tied_softmax = bool(
            args.get("modality.share_embedding_and_softmax_weights"))
        timing = args.get("modality.timing")
        max_positions = args.get("modality.max_positions") or 1024
        trg_dim = args.get("modality.target.dim") or args["modality.dim"]
        target = WordEmbedding(
            self.trg_meta["vocab_size"], trg_dim,
            share_softmax_weights=self.tied_softmax,
            timing=args.get("modality.target.timing") or timing,
            max_positions=max_positions, dtype=self.dtype)
        shared = self.token_source and bool(
            args.get("modality.share_source_target_embedding"))
        if shared:
            if self.src_meta.get("vocab_size") != self.trg_meta["vocab_size"]:
                raise ValueError(
                    "modality.share_source_target_embedding needs one "
                    f"vocabulary, got {self.src_meta.get('vocab_size')} "
                    f"and {self.trg_meta['vocab_size']}")
            self.shared_symbol_modality = target
        else:
            self.target_symbol_modality = target
        self.encoder = self.build_encoder(args)
        self.decoder = self.build_decoder(args)
        if self.token_source and not shared:
            self.input_symbol_modality = WordEmbedding(
                self.src_meta["vocab_size"],
                args.get("modality.source.dim") or args["modality.dim"],
                timing=args.get("modality.source.timing") or timing,
                max_positions=max_positions, dtype=self.dtype)
        if not self.tied_softmax:
            # the JAX module's ``output_linear``: a dense without bias
            self.output_linear = torch.nn.Linear(
                trg_dim, self.trg_meta["vocab_size"], bias=False)
        self._has_dropout = any(
            float(args.get(f"{side}.{rate}") or 0.0) > 0.0
            for side in ("encoder", "decoder")
            for rate in ("attention_dropout_rate", "ffn_dropout_rate",
                         "layer_postprocess_dropout_rate",
                         "weight_dropout_rate"))

    def build_encoder(self, args):
        """The encoder stack from the ``encoder.*`` flags (a subclass with
        another stack overrides this)."""
        return TransformerEncoder(
            **_stack_kwargs(TransformerEncoder, args, "encoder."),
            dtype=self.dtype)

    def build_decoder(self, args):
        """The decoder stack from the ``decoder.*`` flags."""
        decoder_args = {k: v for k, v in args.items()
                        if k != "decoder.attention_monotonic"}
        return TransformerDecoder(
            **_stack_kwargs(TransformerDecoder, decoder_args, "decoder."),
            dtype=self.dtype)

    def _check_training(self, is_training, dropout_key):
        if is_training and self._has_dropout and dropout_key is None:
            raise ValueError(
                "training with dropout > 0 needs a dropout key "
                "(utils.rng.DropoutKey; the train step's rng)")

    def _as_tensors(self, inputs):
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in inputs.items()}

    @property
    def trg_modality(self) -> WordEmbedding:
        """The target embedding and tied softmax."""
        return self._modules.get("shared_symbol_modality") \
            or self.target_symbol_modality

    @property
    def src_modality(self) -> WordEmbedding:
        """The source word embedding (a token-source model's)."""
        return self._modules.get("shared_symbol_modality") \
            or self.input_symbol_modality

    def embed_source(self, inputs):
        """-> (source embeddings [B, S, D], source padding [B, S]): src
        [B, S] token ids; the padding is ``src_padding`` where given, else
        from ``src_length``."""
        src = inputs["src"]
        if inputs.get("src_padding") is not None:
            padding = inputs["src_padding"].float()
        else:
            padding = input_length_to_padding(inputs["src_length"],
                                              src.shape[1])
        return self.src_modality(src), padding

    def encode(self, inputs, is_training=False, dropout_key=None):
        """Returns (encoder_outputs [B, S, D], memory_padding [B, S])."""
        self._check_training(is_training, dropout_key)
        emb, src_padding = self.embed_source(self._as_tensors(inputs))
        return self.encoder(emb, src_padding, is_training,
                            dropout_key), src_padding

    def forward(self, inputs, is_training=False, return_prelogits=False,
                dropout_key=None):
        """Teacher forcing -> float32 logits [B, T, trg_vocab].

        With ``return_prelogits`` (the fused projection + cross-entropy
        training path) it returns {"prelogits": decoder output [B, T, D],
        "softmax_w": [V, D], "softmax_bias": [V]} instead, and the
        [B, T, V] logits are never formed."""
        if return_prelogits and not self.tied_softmax:
            raise ValueError("prelogits (the fused projection + "
                             "cross-entropy path) need the tied softmax; "
                             "supports_fused_softmax_ce is False here")
        enc, src_padding = self.encode(inputs, is_training, dropout_key)
        modality = self.trg_modality
        dec_out = self.teacher_force(
            self.decoder, modality, inputs["trg_input"], enc, src_padding,
            is_training, dropout_key,
            decode_lagging=self.decode_lagging_of(inputs))
        if return_prelogits:
            return {"prelogits": dec_out, "softmax_w": modality.weights,
                    "softmax_bias": modality.bias}
        return self.output_logits(dec_out)

    def decode_lagging_of(self, inputs):
        """The wait-k lagging teacher forcing masks the cross-attention
        with: none here (``models/waitk_transformer.py`` has one)."""
        return None

    def output_logits(self, dec_out):
        """[..., D] -> float32 logits [..., V]: the tied table's
        ``attend``, else ``output_linear`` in the compute dtype, as the
        JAX module's ``output_logits``."""
        if self.tied_softmax:
            return self.trg_modality.attend(dec_out)
        return linear(self.output_linear, dec_out, self.dtype).float()

    def teacher_force(self, decoder, modality, trg_input, enc, src_padding,
                      is_training=False, dropout_key=None,
                      decode_lagging=None):
        """``decoder`` over ``modality``'s embeddings of ``trg_input``
        [B, T] under a causal mask, cross-attending to ``enc`` -> decoder
        output [B, T, D]."""
        trg = torch.as_tensor(trg_input, device=self.device)
        dec_out, _ = decoder(modality(trg), memory=enc,
                             memory_padding=src_padding,
                             decode_lagging=decode_lagging,
                             is_training=is_training,
                             dropout_key=dropout_key)
        return dec_out

    def call_train(self, inputs, want_prelogits=False, dropout_key=None):
        """Training forward -> (model_out, aux_loss).  The auxiliary loss
        (model-internal losses such as MoE load balancing) is a float32
        zero here: the ported models sow none.  ``dropout_key`` seeds
        every dropout site; a model with dropout > 0 raises without
        one."""
        out = self(inputs, is_training=True, return_prelogits=want_prelogits,
                   dropout_key=dropout_key)
        return out, torch.zeros((), dtype=torch.float32, device=self.device)

    def supports_fused_softmax_ce(self) -> bool:
        """Whether the train step may ask for prelogits and fuse the
        vocabulary projection into the cross-entropy kernels: the JAX
        package's conditions (tied softmax, V and D multiples of 128, a
        [V, D] float32 accumulator of at most 80 MiB), so both packages
        take the same path, and a dim the CUDA kernels are built for.  An
        untied model trains through its logits and the composite
        label-smoothed cross-entropy."""
        v = self.trg_meta["vocab_size"]
        d = self.trg_modality.embedding_dim
        return (self.tied_softmax and v % 128 == 0 and d % 128 == 0
                and v * d * 4 <= 80 * 2 ** 20
                and fused_linear_ce_available(v, d))

    @property
    def generation_meta(self) -> dict:
        """The eos / bos / unk ids of the side generation decodes (a
        model with several decoders selects one)."""
        return self.trg_meta

    @property
    def generation_decoder(self) -> TransformerDecoder:
        """The decoder stepwise generation runs."""
        return self.decoder

    @property
    def generation_modality(self) -> WordEmbedding:
        """The embedding of the generated side."""
        return self.trg_modality

    def generation_logits(self, dec_out):
        """The generated side's logits of decoder outputs."""
        return self.output_logits(dec_out)

    def init_cache(self, encoder_outputs, memory_padding,
                   decode_padded_length: int):
        """Static-shape decoding cache, memory padding included."""
        return {"layers":
                self.generation_decoder.create_decoding_internal_cache(
                    encoder_outputs, decode_padded_length),
                "memory_padding": memory_padding}

    def beam_cache_indirection_ok(self) -> bool:
        """The transformer decoder reads its self cache through a
        ``beam_anc`` ancestor matrix."""
        return True

    def decode_step(self, ids, cache, step: int, decode_lagging=None):
        """One decode step: ids [N] at position ``step`` -> (float32
        logits [N, V], cache).  A ``beam_anc`` entry in the cache is
        passed to the decoder's self-attention; ``decode_lagging`` (wait-k)
        masks source positions from step + lagging on."""
        emb = self.generation_modality(ids, time=step)
        dec_out, layers = self.generation_decoder(
            emb[:, None, :], memory=None,
            memory_padding=cache["memory_padding"], cache=cache["layers"],
            decode_step=step, decode_lagging=decode_lagging,
            beam_anc=cache.get("beam_anc"))
        new_cache = dict(cache)
        new_cache["layers"] = layers
        return self.generation_logits(dec_out[:, 0, :]), new_cache

    def decode_steps(self, ids, cache, times):
        """Multi-token decode at per-row times (speculative decode's
        verification): row b's tokens ids [B, k] at cache positions
        times[b] + [0, k) -> (float32 logits [B, k, V], cache).  Only the
        transformer decoder has this path."""
        if not isinstance(self.generation_decoder, TransformerDecoder):
            raise NotImplementedError(
                "speculative decode_steps needs the transformer decoder's "
                "multi-token per-row-time path; "
                f"{type(self.generation_decoder).__name__} (e.g. the "
                "LightConv ring buffer) does not support it")
        emb = self.generation_modality(ids, time=times)
        dec_out, layers = self.generation_decoder(
            emb, memory=None, memory_padding=cache["memory_padding"],
            cache=cache["layers"], decode_step=times)
        new_cache = dict(cache)
        new_cache["layers"] = layers
        return self.generation_logits(dec_out), new_cache

    @property
    def bos_id(self) -> int:
        meta = self.generation_meta
        return meta.get("bos_id", meta["eos_id"])

    def _generation_initializer(self, inputs, decode_padded_length: int):
        """Encodes the source; the initializer keys decoder_input,
        decoder_internal_cache, encoder_inputs_maxlen, eos_id, unk_id."""
        enc, src_padding = self.encode(inputs)
        cache = self.init_cache(enc, src_padding, decode_padded_length)
        batch = enc.shape[0]
        src_len = (1.0 - src_padding).sum(dim=1)
        return {
            "decoder_input": torch.full((batch,), self.bos_id,
                                        dtype=torch.long, device=enc.device),
            "decoder_internal_cache": cache,
            "encoder_inputs_maxlen": int(src_len.max().item()),
            "eos_id": self.generation_meta["eos_id"],
            "unk_id": self.generation_meta.get("unk_id"),
        }

    def prepare_generation(self, inputs, decode_padded_length: int):
        """Encodes the source and builds the decode closure.

        Returns (symbols_to_logits_fn, generation_initializer) with
        symbols_to_logits_fn(ids [N], cache, t) -> (logits [N, V], cache)
        and the initializer keys decoder_input, decoder_internal_cache,
        encoder_inputs_maxlen, eos_id, unk_id, beam_cache_indirection_ok.
        """
        init = self._generation_initializer(inputs, decode_padded_length)
        init["beam_cache_indirection_ok"] = self.beam_cache_indirection_ok()
        return self.decode_step, init

    def prepare_speculative(self, inputs, decode_padded_length: int):
        """Like ``prepare_generation``, with the multi-token closure
        ``decode_steps(ids [B, k], cache, times [B]) -> (logits [B, k, V],
        cache)``."""
        return self.decode_steps, self._generation_initializer(
            inputs, decode_padded_length)
