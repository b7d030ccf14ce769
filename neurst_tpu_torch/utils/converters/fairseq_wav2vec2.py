"""wav2vec 2.0 checkpoint (HuggingFace torch layout) -> the JAX package's
flat names (the port's copy of
``neurst_tpu/utils/converters/fairseq_wav2vec2.py``).

Parity: the original NeurST's utils/converters/fairseq_wav2vec2.py.
The weight-normed positional conv (weight_g/weight_v) is folded into a
plain kernel: w = g * v / ||v||.
"""

from typing import Dict

import numpy as np

from neurst_tpu_torch.utils.converters.converter import (Converter,
                                                         register_converter)
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["FairseqWav2vec2"]


@register_converter("fairseq_wav2vec2", "wav2vec2_converter")
class FairseqWav2vec2(Converter):

    def __init__(self, args=None):
        super().__init__(args)
        self._num_heads = int(self._args.get("num_heads") or 12)

    @staticmethod
    def class_or_method_args():
        return [Flag("num_heads", dtype=Flag.TYPE.INTEGER, default=12,
                     help="The number of attention heads.")]

    def convert_to_flat(self, from_path: str) -> Dict[str, np.ndarray]:
        sd = self.load_torch_state_dict(from_path)
        sd = {k[len("wav2vec2."):] if k.startswith("wav2vec2.") else k: v
              for k, v in sd.items()}
        out: Dict[str, np.ndarray] = {}
        h = self._num_heads

        # conv feature encoder: torch conv1d [out, in, k] -> flax [k, in, out]
        i = 0
        while f"feature_extractor.conv_layers.{i}.conv.weight" in sd:
            w = sd[f"feature_extractor.conv_layers.{i}.conv.weight"]
            out[f"feature_conv_{i}/kernel"] = \
                w.transpose(2, 1, 0).astype(np.float32)
            i += 1
        gn_w = sd.get("feature_extractor.conv_layers.0.layer_norm.weight")
        if gn_w is not None:
            out["feature_gn/scale"] = gn_w.astype(np.float32)
            out["feature_gn/bias"] = sd[
                "feature_extractor.conv_layers.0.layer_norm.bias"].astype(
                np.float32)
        out["feature_proj_ln/scale"] = \
            sd["feature_projection.layer_norm.weight"].astype(np.float32)
        out["feature_proj_ln/bias"] = \
            sd["feature_projection.layer_norm.bias"].astype(np.float32)
        out["feature_proj/kernel"] = \
            sd["feature_projection.projection.weight"].T.astype(np.float32)
        out["feature_proj/bias"] = \
            sd["feature_projection.projection.bias"].astype(np.float32)

        # weight-normed positional conv: fold g * v / ||v||
        pc = "encoder.pos_conv_embed.conv"
        if f"{pc}.weight_g" in sd \
                or f"{pc}.parametrizations.weight.original0" in sd:
            if f"{pc}.weight_g" in sd:
                g = sd[f"{pc}.weight_g"]
                v = sd[f"{pc}.weight_v"]
            else:  # torch >= 2.1 parametrization naming
                g = sd[f"{pc}.parametrizations.weight.original0"]
                v = sd[f"{pc}.parametrizations.weight.original1"]
            norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
            w = g * v / np.maximum(norm, 1e-12)
        else:
            w = sd[f"{pc}.weight"]
        # torch grouped conv1d [out, in/groups, k] -> flax [k, in/groups, out]
        out["pos_conv/kernel"] = w.transpose(2, 1, 0).astype(np.float32)
        out["pos_conv/bias"] = sd[f"{pc}.bias"].astype(np.float32)

        out["post_extract_ln/scale"] = \
            sd["encoder.layer_norm.weight"].astype(np.float32)
        out["post_extract_ln/bias"] = \
            sd["encoder.layer_norm.bias"].astype(np.float32)

        i = 0
        while f"encoder.layers.{i}.attention.q_proj.weight" in sd:
            p, o = f"encoder.layers.{i}", f"encoder/layer_{i}"
            q = sd[f"{p}.attention.q_proj.weight"]
            k = sd[f"{p}.attention.k_proj.weight"]
            v = sd[f"{p}.attention.v_proj.weight"]
            d = q.shape[1]
            hd = d // h
            out[f"{o}/self_attention/qkv_transform/kernel"] = np.stack(
                [m.T.reshape(d, h, hd) for m in (q, k, v)],
                axis=1).astype(np.float32)
            out[f"{o}/self_attention/qkv_transform/bias"] = np.stack(
                [sd[f"{p}.attention.{n}_proj.bias"].reshape(h, hd)
                 for n in ("q", "k", "v")], axis=0).astype(np.float32)
            w = sd[f"{p}.attention.out_proj.weight"]
            out[f"{o}/self_attention/output_transform/kernel"] = \
                w.T.reshape(h, hd, d).astype(np.float32)
            out[f"{o}/self_attention/output_transform/bias"] = \
                sd[f"{p}.attention.out_proj.bias"].astype(np.float32)
            out[f"{o}/self_attention_ln/scale"] = \
                sd[f"{p}.layer_norm.weight"].astype(np.float32)
            out[f"{o}/self_attention_ln/bias"] = \
                sd[f"{p}.layer_norm.bias"].astype(np.float32)
            out[f"{o}/ffn/dense1/kernel"] = \
                sd[f"{p}.feed_forward.intermediate_dense.weight"].T.astype(
                    np.float32)
            out[f"{o}/ffn/dense1/bias"] = \
                sd[f"{p}.feed_forward.intermediate_dense.bias"].astype(
                    np.float32)
            out[f"{o}/ffn/dense2/kernel"] = \
                sd[f"{p}.feed_forward.output_dense.weight"].T.astype(
                    np.float32)
            out[f"{o}/ffn/dense2/bias"] = \
                sd[f"{p}.feed_forward.output_dense.bias"].astype(np.float32)
            out[f"{o}/ffn_ln/scale"] = \
                sd[f"{p}.final_layer_norm.weight"].astype(np.float32)
            out[f"{o}/ffn_ln/bias"] = \
                sd[f"{p}.final_layer_norm.bias"].astype(np.float32)
            i += 1
        return out
