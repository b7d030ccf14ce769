"""GPT-2, a decoder-only language model (counterpart of
``neurst_tpu/models/gpt2.py``).

Learned position embeddings (``timing: emb`` on the target modality,
no softmax bias), pre-norm blocks of the transformer decoder without
cross-attention and with the tanh-approximated gelu, a final LayerNorm,
and the tied softmax.

Generation prefills the cache with the prompt (``trg_input`` [B, L]):
positions 0 .. L - 2 are decoded into the cache, the last prompt token
is the first decoder input, and a generation step t runs at cache
position t + L - 1, so the cache holds prompt + continuation.  As in the
JAX model, a batch of prompts of different lengths is right-padded: a
shorter prompt's padding is prefilled and its last column (a pad id) is
its first decoder input.  The beam search reads the prompt shift from the
initializer's ``decode_time_offset``; speculative decode's multi-token
steps (``decode_steps`` through ``prepare_speculative``) run at cache
positions times + L - 1 in the same way.
"""

import torch

from neurst_tpu_torch.layers.common_layers import WordEmbedding
from neurst_tpu_torch.layers.decoders.transformer_decoder import \
    TransformerDecoder
from neurst_tpu_torch.models.model import (BaseModel, dtype_by_name,
                                           register_model)
from neurst_tpu_torch.utils.flags_core import Flag
from neurst_tpu_torch.utils.hparams_sets import register_hparams_set

__all__ = ["GPT2"]


@register_model("gpt2")
class GPT2(BaseModel):

    def __init__(self, args, src_meta, trg_meta):
        super().__init__(args)
        self.trg_meta = dict(trg_meta or src_meta or {})
        a = self.args
        self.dtype = dtype_by_name(a.get("dtype"))
        hidden = a.get("hidden_size") or 768
        # ``or`` as in the JAX model: a dropout_rate of 0 takes 0.1
        self.dropout_rate = a.get("dropout_rate") or 0.1
        self.target_symbol_modality = WordEmbedding(
            self.trg_meta["vocab_size"], hidden, share_softmax_weights=True,
            use_bias=False, timing=a.get("timing") or "emb",
            max_positions=a.get("max_positions") or 1024, dtype=self.dtype)
        self.decoder = TransformerDecoder(
            a.get("num_layers") or 12, hidden,
            a.get("num_attention_heads") or 12,
            a.get("filter_size") or 3072, ffn_activation="gelu_approx",
            post_normalize=False,
            layer_postprocess_epsilon=a.get("epsilon") or 1e-5,
            attention_dropout_rate=self.dropout_rate,
            ffn_dropout_rate=self.dropout_rate,
            layer_postprocess_dropout_rate=self.dropout_rate,
            with_cross_attention=False, dtype=self.dtype)

    @staticmethod
    def class_or_method_args():
        return [
            Flag("num_layers", dtype=Flag.TYPE.INTEGER, default=12,
                 help="The number of decoder blocks."),
            Flag("hidden_size", dtype=Flag.TYPE.INTEGER, default=768,
                 help="The model dimension."),
            Flag("num_attention_heads", dtype=Flag.TYPE.INTEGER, default=12,
                 help="The number of attention heads."),
            Flag("filter_size", dtype=Flag.TYPE.INTEGER, default=3072,
                 help="The FFN filter size."),
            Flag("max_positions", dtype=Flag.TYPE.INTEGER, default=1024,
                 help="The maximum sequence positions."),
            Flag("dropout_rate", dtype=Flag.TYPE.FLOAT, default=0.1,
                 help="The dropout rate."),
            Flag("timing", dtype=Flag.TYPE.STRING, default="emb",
                 help="The position embedding type."),
            Flag("epsilon", dtype=Flag.TYPE.FLOAT, default=1e-5,
                 help="The layer-norm epsilon."),
            Flag("scan_layers", dtype=Flag.TYPE.BOOLEAN, default=None,
                 help="The JAX package's scan switch; the port runs the "
                      "per-layer stack (checkpoints of either layout "
                      "load)."),
            Flag("dtype", dtype=Flag.TYPE.STRING, default="bfloat16",
                 help="The computation dtype."),
        ]

    @classmethod
    def build_model_args_by_name(cls, name):
        sizes = {"gpt2_117m": (12, 768, 12), "gpt2_small": (12, 768, 12),
                 "gpt2_medium": (24, 1024, 16), "gpt2_large": (36, 1280, 20),
                 "gpt2_toy": (2, 16, 2)}
        if name not in sizes:
            return None
        layers, dim, heads = sizes[name]
        return {
            "model.class": cls.__name__,
            "model.params": {
                "num_layers": layers, "hidden_size": dim,
                "num_attention_heads": heads, "filter_size": dim * 4,
                "max_positions": 1024, "dropout_rate": 0.1,
            },
        }

    @property
    def trg_modality(self) -> WordEmbedding:
        return self.target_symbol_modality

    def forward(self, inputs, is_training=False, return_prelogits=False,
                dropout_key=None):
        """inputs["trg_input"] [B, T] -> float32 logits [B, T, V]."""
        if return_prelogits:
            raise ValueError("GPT-2 has no prelogits path: "
                             "supports_fused_softmax_ce is False")
        if is_training and dropout_key is None:
            raise ValueError(
                "training with dropout > 0 needs a dropout key "
                "(utils.rng.DropoutKey; the train step's rng)")
        trg = torch.as_tensor(inputs["trg_input"], device=self.device)
        out, _ = self.decoder(self.trg_modality(trg),
                              is_training=is_training,
                              dropout_key=dropout_key)
        return self.trg_modality.attend(out)

    def call_train(self, inputs, want_prelogits=False, dropout_key=None):
        """(logits, a float32 zero auxiliary loss)."""
        del want_prelogits
        out = self(inputs, is_training=True, dropout_key=dropout_key)
        return out, torch.zeros((), dtype=torch.float32, device=self.device)

    def supports_fused_softmax_ce(self) -> bool:
        """False: the JAX package fuses the projection only into a
        sequence-to-sequence module's cross-entropy."""
        return False

    def init_cache(self, batch_size: int, decode_padded_length: int):
        return {"layers": self.decoder.create_decoding_internal_cache(
            None, decode_padded_length, batch_size=batch_size,
            device=self.device)}

    def decode_step(self, ids, cache, step: int):
        """ids [N] at cache position ``step`` -> (float32 logits [N, V],
        cache).  A ``beam_anc`` entry is passed to the self-attention."""
        emb = self.trg_modality(ids, time=step)
        out, layers = self.decoder(emb[:, None, :], cache=cache["layers"],
                                   decode_step=step,
                                   beam_anc=cache.get("beam_anc"))
        new_cache = dict(cache)
        new_cache["layers"] = layers
        return self.trg_modality.attend(out[:, 0, :]), new_cache

    def decode_steps(self, ids, cache, times):
        """ids [B, k] at cache positions times[b] + [0, k) -> (float32
        logits [B, k, V], cache): speculative decode's verification."""
        emb = self.trg_modality(ids, time=times)
        out, layers = self.decoder(emb, cache=cache["layers"],
                                   decode_step=times)
        return self.trg_modality.attend(out), {"layers": layers}

    def _prefill(self, inputs, decode_padded_length: int):
        """Prefills the cache with the prompt but its last token.
        Returns (cache, prefill, generation initializer)."""
        prompt = torch.as_tensor(inputs["trg_input"], device=self.device)
        if prompt.dim() == 1:
            prompt = prompt[:, None]
        batch, prompt_len = prompt.shape
        prefill = prompt_len - 1
        # the cache holds the prompt AND the generated continuation
        cache = self.init_cache(batch, decode_padded_length + prefill)
        for t in range(prefill):
            _, cache = self.decode_step(prompt[:, t], cache, t)
        return cache, prefill, {
            "decoder_input": prompt[:, -1],
            "decoder_internal_cache": cache,
            "decode_time_offset": prefill,
            "encoder_inputs_maxlen": None,
            "eos_id": self.trg_meta["eos_id"],
            "unk_id": self.trg_meta.get("unk_id"),
            # beams share the prefill, so its ancestor columns stay the
            # identity
            "beam_cache_indirection_ok": True,
        }

    def prepare_generation(self, inputs, decode_padded_length: int):
        """The prompt-prefilled stepwise closure, shifted by the
        prefill."""
        with torch.no_grad():
            _, prefill, init = self._prefill(inputs, decode_padded_length)

        def symbols_to_logits_fn(ids, cache, time):
            return self.decode_step(ids, cache, time + prefill)

        return symbols_to_logits_fn, init

    def prepare_speculative(self, inputs, decode_padded_length: int):
        """The prompt-prefilled multi-token closure, its times shifted by
        the prefill."""
        with torch.no_grad():
            _, prefill, init = self._prefill(inputs, decode_padded_length)

        def steps_fn(ids, cache, times):
            return self.decode_steps(ids, cache, times + prefill)

        return steps_fn, init


register_hparams_set("gpt2_117m")(
    lambda: GPT2.build_model_args_by_name("gpt2_117m"))
register_hparams_set("gpt2_toy")(
    lambda: GPT2.build_model_args_by_name("gpt2_toy"))
