"""fairseq Transformer checkpoint -> the JAX package's flat names (the
port's copy of ``neurst_tpu/utils/converters/fairseq_transformer.py``).

Parity: the original NeurST's utils/converters/fairseq_transformer.py.

Name scheme mapped (fairseq -> ours):
    encoder.embed_tokens.weight        -> input_symbol_modality/weights
    decoder.embed_tokens.weight        -> target_symbol_modality/weights
    encoder.layers.N.self_attn.{q,k,v}_proj
        -> encoder/layer_N/self_attention/qkv_transform (fused)
    decoder.layers.N.encoder_attn.q_proj
        -> decoder/layer_N/cross_attention/q_transform
    decoder.layers.N.encoder_attn.{k,v}_proj
        -> decoder/layer_N/cross_attention/kv_transform (fused)
    *_layer_norm -> *_ln  (weight->scale)
    fc1/fc2 -> ffn/dense1,dense2

torch linear weights are [out, in] and are transposed; fused q/k/v are
stacked on the projection axis and reshaped to
``[in, n_proj, heads, head_dim]`` matching our DenseGeneral kernels.
Note: fairseq uses eos-as-BOS (``target_begin_of_sentence: eos``).
"""

from typing import Dict

import numpy as np

from neurst_tpu_torch.utils.converters.converter import (Converter,
                                                         register_converter)
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["FairseqTransformer", "FairseqTransformer2"]


@register_converter("fairseq_transformer")
class FairseqTransformer(Converter):

    def __init__(self, args=None):
        super().__init__(args)
        self._num_heads = int(self._args.get("num_heads") or 8)

    @staticmethod
    def class_or_method_args():
        return [Flag("num_heads", dtype=Flag.TYPE.INTEGER, default=8,
                     help="The number of attention heads (for reshaping "
                          "fused projections).")]

    def _fuse(self, mats, biases):
        """[ [out,in] x n ] -> kernel [in, n, H, hd], bias [n, H, hd]."""
        n = len(mats)
        h = self._num_heads
        din = mats[0].shape[1]
        dout = mats[0].shape[0]
        hd = dout // h
        kernel = np.stack([m.T.reshape(din, h, hd) for m in mats], axis=1)
        bias = np.stack([b.reshape(h, hd) for b in biases], axis=0)
        return kernel.astype(np.float32), bias.astype(np.float32)

    @staticmethod
    def _split_in_proj(sd):
        """Normalizes the OLD fairseq attention layout (fused
        ``in_proj_weight``/``in_proj_bias``, reference converter
        fairseq_transformer.py:140-181) into the new separate
        q/k/v_proj keys so one mapping below covers both layouts
        (the reference splits them across two converter classes,
        fairseq_transformer vs fairseq_transformer2)."""
        out = dict(sd)
        for key in list(sd):
            if not key.endswith(".in_proj_weight"):
                continue
            base = key[:-len(".in_proj_weight")]
            w = sd[key]
            b = sd.get(base + ".in_proj_bias")
            d = w.shape[0] // 3
            for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
                out[f"{base}.{name}.weight"] = w[i * d:(i + 1) * d]
                if b is not None:
                    out[f"{base}.{name}.bias"] = b[i * d:(i + 1) * d]
            del out[key]
            out.pop(base + ".in_proj_bias", None)
        return out

    def convert_to_flat(self, from_path: str) -> Dict[str, np.ndarray]:
        sd = self._split_in_proj(self.load_torch_state_dict(from_path))
        out: Dict[str, np.ndarray] = {}
        h = self._num_heads

        def t(x):
            return x.T.astype(np.float32)

        for side in ("encoder", "decoder"):
            emb_key = f"{side}.embed_tokens.weight"
            if emb_key in sd:
                name = ("input_symbol_modality/weights" if side == "encoder"
                        else "target_symbol_modality/weights")
                out[name] = sd[emb_key].astype(np.float32)
            # final layer norm (pre-norm models)
            for fs, ours in ((f"{side}.layer_norm.weight",
                              f"{side}/output_ln/scale"),
                             (f"{side}.layer_norm.bias",
                              f"{side}/output_ln/bias")):
                if fs in sd:
                    out[ours] = sd[fs].astype(np.float32)
            i = 0
            while f"{side}.layers.{i}.self_attn.q_proj.weight" in sd:
                p = f"{side}.layers.{i}"
                o = f"{side}/layer_{i}"
                # fused self-attention qkv
                kernel, bias = self._fuse(
                    [sd[f"{p}.self_attn.q_proj.weight"],
                     sd[f"{p}.self_attn.k_proj.weight"],
                     sd[f"{p}.self_attn.v_proj.weight"]],
                    [sd[f"{p}.self_attn.q_proj.bias"],
                     sd[f"{p}.self_attn.k_proj.bias"],
                     sd[f"{p}.self_attn.v_proj.bias"]])
                out[f"{o}/self_attention/qkv_transform/kernel"] = kernel
                out[f"{o}/self_attention/qkv_transform/bias"] = bias
                w = sd[f"{p}.self_attn.out_proj.weight"]
                dout, din = w.shape
                out[f"{o}/self_attention/output_transform/kernel"] = \
                    w.T.reshape(h, din // h, dout).astype(np.float32)
                out[f"{o}/self_attention/output_transform/bias"] = \
                    sd[f"{p}.self_attn.out_proj.bias"].astype(np.float32)
                out[f"{o}/self_attention_ln/scale"] = \
                    sd[f"{p}.self_attn_layer_norm.weight"].astype(np.float32)
                out[f"{o}/self_attention_ln/bias"] = \
                    sd[f"{p}.self_attn_layer_norm.bias"].astype(np.float32)
                # cross attention (decoder)
                if f"{p}.encoder_attn.q_proj.weight" in sd:
                    qk, qb = self._fuse(
                        [sd[f"{p}.encoder_attn.q_proj.weight"]],
                        [sd[f"{p}.encoder_attn.q_proj.bias"]])
                    out[f"{o}/cross_attention/q_transform/kernel"] = qk
                    out[f"{o}/cross_attention/q_transform/bias"] = qb
                    kvk, kvb = self._fuse(
                        [sd[f"{p}.encoder_attn.k_proj.weight"],
                         sd[f"{p}.encoder_attn.v_proj.weight"]],
                        [sd[f"{p}.encoder_attn.k_proj.bias"],
                         sd[f"{p}.encoder_attn.v_proj.bias"]])
                    out[f"{o}/cross_attention/kv_transform/kernel"] = kvk
                    out[f"{o}/cross_attention/kv_transform/bias"] = kvb
                    w = sd[f"{p}.encoder_attn.out_proj.weight"]
                    dout, din = w.shape
                    out[f"{o}/cross_attention/output_transform/kernel"] = \
                        w.T.reshape(h, din // h, dout).astype(np.float32)
                    out[f"{o}/cross_attention/output_transform/bias"] = \
                        sd[f"{p}.encoder_attn.out_proj.bias"].astype(
                            np.float32)
                    out[f"{o}/cross_attention_ln/scale"] = \
                        sd[f"{p}.encoder_attn_layer_norm.weight"].astype(
                            np.float32)
                    out[f"{o}/cross_attention_ln/bias"] = \
                        sd[f"{p}.encoder_attn_layer_norm.bias"].astype(
                            np.float32)
                # ffn
                out[f"{o}/ffn/dense1/kernel"] = t(sd[f"{p}.fc1.weight"])
                out[f"{o}/ffn/dense1/bias"] = \
                    sd[f"{p}.fc1.bias"].astype(np.float32)
                out[f"{o}/ffn/dense2/kernel"] = t(sd[f"{p}.fc2.weight"])
                out[f"{o}/ffn/dense2/bias"] = \
                    sd[f"{p}.fc2.bias"].astype(np.float32)
                out[f"{o}/ffn_ln/scale"] = \
                    sd[f"{p}.final_layer_norm.weight"].astype(np.float32)
                out[f"{o}/ffn_ln/bias"] = \
                    sd[f"{p}.final_layer_norm.bias"].astype(np.float32)
                i += 1
        return out


@register_converter("fairseq_transformer2")
class FairseqTransformer2(FairseqTransformer):
    """The reference's second fairseq naming variant
    (the original NeurST's fairseq_transformer2.py):
    newer fairseq checkpoints with separate q/k/v projections and the
    ``cfg`` (not ``args``) config block.  Our base converter already
    auto-detects both attention layouts, so this class exists for
    registry-name parity — recipes written against either reference
    converter name work unchanged."""
