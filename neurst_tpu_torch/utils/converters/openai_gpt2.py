"""GPT-2 checkpoint (HuggingFace torch layout) -> the JAX package's flat
names (the port's copy of ``neurst_tpu/utils/converters/openai_gpt2.py``).

Parity: the original NeurST's utils/converters/openai_gpt2.py (which
consumed the OpenAI TF checkpoints; the HF layout carries identical
weights).  GPT-2's Conv1D stores weights as [in, out], so ``c_attn``
[d, 3d] reshapes directly to our fused qkv kernel [d, 3, H, hd].
"""

from typing import Dict

import numpy as np

from neurst_tpu_torch.utils.converters.converter import (Converter,
                                                         register_converter)
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["OpenAIGPT2"]


@register_converter("openai_gpt2", "OpenAIGPT2")
class OpenAIGPT2(Converter):

    def __init__(self, args=None):
        super().__init__(args)
        self._num_heads = int(self._args.get("num_heads") or 12)

    @staticmethod
    def class_or_method_args():
        return [Flag("num_heads", dtype=Flag.TYPE.INTEGER, default=12,
                     help="The number of attention heads.")]

    def convert_to_flat(self, from_path: str) -> Dict[str, np.ndarray]:
        sd = self.load_torch_state_dict(from_path)
        sd = {k[len("transformer."):] if k.startswith("transformer.")
              else k: v for k, v in sd.items()}
        out: Dict[str, np.ndarray] = {}
        h = self._num_heads
        out["target_symbol_modality/weights"] = \
            sd["wte.weight"].astype(np.float32)
        out["target_symbol_modality/position_weights"] = \
            sd["wpe.weight"].astype(np.float32)
        out["decoder/output_ln/scale"] = sd["ln_f.weight"].astype(np.float32)
        out["decoder/output_ln/bias"] = sd["ln_f.bias"].astype(np.float32)
        i = 0
        while f"h.{i}.ln_1.weight" in sd:
            p, o = f"h.{i}", f"decoder/layer_{i}"
            d = sd[f"{p}.attn.c_attn.weight"].shape[0]
            hd = d // h
            out[f"{o}/self_attention_ln/scale"] = \
                sd[f"{p}.ln_1.weight"].astype(np.float32)
            out[f"{o}/self_attention_ln/bias"] = \
                sd[f"{p}.ln_1.bias"].astype(np.float32)
            out[f"{o}/self_attention/qkv_transform/kernel"] = \
                sd[f"{p}.attn.c_attn.weight"].reshape(
                    d, 3, h, hd).astype(np.float32)
            out[f"{o}/self_attention/qkv_transform/bias"] = \
                sd[f"{p}.attn.c_attn.bias"].reshape(
                    3, h, hd).astype(np.float32)
            out[f"{o}/self_attention/output_transform/kernel"] = \
                sd[f"{p}.attn.c_proj.weight"].reshape(
                    h, hd, d).astype(np.float32)
            out[f"{o}/self_attention/output_transform/bias"] = \
                sd[f"{p}.attn.c_proj.bias"].astype(np.float32)
            out[f"{o}/ffn_ln/scale"] = \
                sd[f"{p}.ln_2.weight"].astype(np.float32)
            out[f"{o}/ffn_ln/bias"] = sd[f"{p}.ln_2.bias"].astype(np.float32)
            out[f"{o}/ffn/dense1/kernel"] = \
                sd[f"{p}.mlp.c_fc.weight"].astype(np.float32)
            out[f"{o}/ffn/dense1/bias"] = \
                sd[f"{p}.mlp.c_fc.bias"].astype(np.float32)
            out[f"{o}/ffn/dense2/kernel"] = \
                sd[f"{p}.mlp.c_proj.weight"].astype(np.float32)
            out[f"{o}/ffn/dense2/bias"] = \
                sd[f"{p}.mlp.c_proj.bias"].astype(np.float32)
            i += 1
        return out
