"""BERT checkpoint (HuggingFace torch layout) -> the JAX package's flat
names (the port's copy of ``neurst_tpu/utils/converters/google_bert.py``).

Parity: the original NeurST's utils/converters/google_bert.py.
HF separate query/key/value linears fuse into our qkv kernel.
"""

from typing import Dict

import numpy as np

from neurst_tpu_torch.utils.converters.converter import (Converter,
                                                         register_converter)
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["GoogleBert"]


@register_converter("google_bert", "GoogleBert")
class GoogleBert(Converter):

    def __init__(self, args=None):
        super().__init__(args)
        self._num_heads = int(self._args.get("num_heads") or 12)

    @staticmethod
    def class_or_method_args():
        return [Flag("num_heads", dtype=Flag.TYPE.INTEGER, default=12,
                     help="The number of attention heads.")]

    def convert_to_flat(self, from_path: str) -> Dict[str, np.ndarray]:
        sd = self.load_torch_state_dict(from_path)
        sd = {k[len("bert."):] if k.startswith("bert.") else k: v
              for k, v in sd.items()}
        out: Dict[str, np.ndarray] = {}
        h = self._num_heads
        out["word_embedding"] = \
            sd["embeddings.word_embeddings.weight"].astype(np.float32)
        out["position_embedding"] = \
            sd["embeddings.position_embeddings.weight"].astype(np.float32)
        out["token_type_embedding"] = \
            sd["embeddings.token_type_embeddings.weight"].astype(np.float32)
        out["emb_ln/scale"] = \
            sd["embeddings.LayerNorm.weight"].astype(np.float32)
        out["emb_ln/bias"] = \
            sd["embeddings.LayerNorm.bias"].astype(np.float32)
        if "pooler.dense.weight" in sd:
            out["pooler/kernel"] = \
                sd["pooler.dense.weight"].T.astype(np.float32)
            out["pooler/bias"] = sd["pooler.dense.bias"].astype(np.float32)
        i = 0
        while f"encoder.layer.{i}.attention.self.query.weight" in sd:
            p, o = f"encoder.layer.{i}", f"encoder/layer_{i}"
            q = sd[f"{p}.attention.self.query.weight"]
            k = sd[f"{p}.attention.self.key.weight"]
            v = sd[f"{p}.attention.self.value.weight"]
            d = q.shape[1]
            hd = d // h
            out[f"{o}/self_attention/qkv_transform/kernel"] = np.stack(
                [m.T.reshape(d, h, hd) for m in (q, k, v)],
                axis=1).astype(np.float32)
            out[f"{o}/self_attention/qkv_transform/bias"] = np.stack(
                [sd[f"{p}.attention.self.{n}.bias"].reshape(h, hd)
                 for n in ("query", "key", "value")],
                axis=0).astype(np.float32)
            w = sd[f"{p}.attention.output.dense.weight"]
            out[f"{o}/self_attention/output_transform/kernel"] = \
                w.T.reshape(h, hd, d).astype(np.float32)
            out[f"{o}/self_attention/output_transform/bias"] = \
                sd[f"{p}.attention.output.dense.bias"].astype(np.float32)
            out[f"{o}/self_attention_ln/scale"] = \
                sd[f"{p}.attention.output.LayerNorm.weight"].astype(
                    np.float32)
            out[f"{o}/self_attention_ln/bias"] = \
                sd[f"{p}.attention.output.LayerNorm.bias"].astype(
                    np.float32)
            out[f"{o}/ffn/dense1/kernel"] = \
                sd[f"{p}.intermediate.dense.weight"].T.astype(np.float32)
            out[f"{o}/ffn/dense1/bias"] = \
                sd[f"{p}.intermediate.dense.bias"].astype(np.float32)
            out[f"{o}/ffn/dense2/kernel"] = \
                sd[f"{p}.output.dense.weight"].T.astype(np.float32)
            out[f"{o}/ffn/dense2/bias"] = \
                sd[f"{p}.output.dense.bias"].astype(np.float32)
            out[f"{o}/ffn_ln/scale"] = \
                sd[f"{p}.output.LayerNorm.weight"].astype(np.float32)
            out[f"{o}/ffn_ln/bias"] = \
                sd[f"{p}.output.LayerNorm.bias"].astype(np.float32)
            i += 1
        return out
