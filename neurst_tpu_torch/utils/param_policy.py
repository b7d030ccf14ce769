"""Parameter storage dtype for inference (counterpart of
``neurst_tpu/utils/param_policy.py``).

A bf16-compute model casts every dense kernel, bias and embedding table
to bf16 where it is used, so storing them in bf16 once, after loading,
gives the same outputs and halves the weight reads of every decode
step.  LayerNorm ``scale`` / ``bias`` (read in float32) stay float32.
"""

import torch

from neurst_tpu_torch.utils.param_bridge import load_flat_params

__all__ = ["cast_params_for_inference", "restore_inference_params"]

_BF16_NAMES = ("bfloat16", "bf16")


def cast_params_for_inference(model: torch.nn.Module, model_dtype):
    """Stores ``model``'s float32 weights in bf16 when it computes in
    bf16 (no-op otherwise).  Modifies ``model`` in place; returns it."""
    name = model_dtype if isinstance(model_dtype, str) or model_dtype is None \
        else str(model_dtype).replace("torch.", "")
    if (name or "").lower() not in _BF16_NAMES:
        return model
    for module in model.modules():
        own = dict(module.named_parameters(recurse=False))
        is_norm = "scale" in own
        for pname, p in own.items():
            if p.dtype != torch.float32 or (is_norm
                                            and pname in ("scale", "bias")):
                continue
            p.data = p.data.to(torch.bfloat16)
    return model


def restore_inference_params(model: torch.nn.Module, flat):
    """Checkpoint -> serving weights (counterpart of
    ``neurst_tpu/utils/param_policy.py:42``): loads the JAX package's
    flat parameters through ``param_bridge`` (which raises on a missing
    or unknown name, where the JAX restore warns), then stores bf16 at
    rest for a bf16-compute model.  Returns ``model``."""
    load_flat_params(model, flat)
    return cast_params_for_inference(model, model.args.get("dtype"))
