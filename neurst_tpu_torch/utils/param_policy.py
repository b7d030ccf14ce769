"""Parameter storage dtype for inference (counterpart of
``neurst_tpu/utils/param_policy.py``).

A bf16-compute model casts every dense kernel, bias and embedding table
to bf16 where it is used, so storing them in bf16 once, after loading,
gives the same outputs and halves the weight reads of every decode
step.  LayerNorm ``scale`` / ``bias`` (read in float32), QAT's
``*_clip_max`` and int8 serving's ``*_scale`` stay float32 (the int8
tables stay int8), and a QAT model is not cast at all (fake quantization
reads float32 kernels), as in the JAX package.
"""

import numpy as np
import torch

from neurst_tpu_torch.layers.quantization.quant_layers import (
    Int8Dense, int8_serving_enabled, int8ify_flat_params, qat_act_scale_names,
    quant_enabled)
from neurst_tpu_torch.utils.param_bridge import (load_flat_params,
                                                 state_dict_to_flat,
                                                 to_jax_name,
                                                 unstack_scan_layers)

__all__ = ["cast_params_for_inference", "restore_inference_params"]

_BF16_NAMES = ("bfloat16", "bf16")


def cast_params_for_inference(model: torch.nn.Module, model_dtype):
    """Stores ``model``'s float32 weights in bf16 when it computes in
    bf16 (no-op otherwise).  Modifies ``model`` in place; returns it."""
    name = model_dtype if isinstance(model_dtype, str) or model_dtype is None \
        else str(model_dtype).replace("torch.", "")
    if (name or "").lower() not in _BF16_NAMES or quant_enabled():
        return model
    for module in model.modules():
        own = dict(module.named_parameters(recurse=False))
        is_norm = "scale" in own
        for pname, p in own.items():
            if p.dtype != torch.float32 or (is_norm
                                            and pname in ("scale", "bias")) \
                    or pname.endswith(("_clip_max", "_scale")):
                continue
            p.data = p.data.to(torch.bfloat16)
    return model


def restore_inference_params(model: torch.nn.Module, flat):
    """Checkpoint -> serving weights (counterpart of
    ``neurst_tpu/utils/param_policy.py:42``): under int8 serving first
    quantizes the float32 checkpoint for the int8 model
    (``int8ify_flat_params``); then loads the flat parameters through
    ``param_bridge`` (which raises on a missing or unknown name, where the
    JAX restore warns; under int8 serving a QAT checkpoint's activation
    clips, which the int8 model has no place for, are left out, and a
    static ``act_scale`` the checkpoint does not give keeps 1.0 until
    calibration; one it gives from a QAT clip is marked
    ``act_scale_from_clip``), then stores bf16 at rest for a bf16-compute
    model.  Returns ``model``."""
    from_clip = set()
    if int8_serving_enabled():
        template = state_dict_to_flat(model)
        flat = unstack_scan_layers(flat)
        from_clip = qat_act_scale_names(flat, template)
        flat = int8ify_flat_params(flat, template)
        flat = {k: v for k, v in flat.items()
                if k in template or not k.endswith("_clip_max")}
        for name, value in template.items():
            if name.endswith("/act_scale") and name not in flat:
                flat[name] = np.ones_like(value)
    load_flat_params(model, flat)
    for name, module in model.named_modules():
        if isinstance(module, Int8Dense):
            module.act_scale_from_clip = \
                to_jax_name(f"{name}.act_scale") in from_clip
    return cast_params_for_inference(model, model.args.get("dtype"))
