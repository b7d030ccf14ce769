"""bf16 stored parameters with a float32 master copy in the optimizer
(counterpart of ``neurst_tpu/optimizers/master_weights.py``).

``cast_params_bf16`` stores EVERY float parameter of a model in bf16,
LayerNorm scale and bias included, as the JAX function casts every float
leaf.  That is the training policy; the inference policy
(``utils/param_policy.cast_params_for_inference``) keeps LayerNorm in
float32, and the two stay apart.  ``with_bf16_params`` wraps a gradient
transformation so that it runs on float32 gradients against an f32
master kept in its state, and moves each live bf16 parameter to
bf16(master') through the update it emits.
"""

import torch

from neurst_tpu_torch.optimizers.optimizers import (GradientTransformation,
                                                     apply_updates)

__all__ = ["with_bf16_params", "cast_params_bf16"]


def cast_params_bf16(model: torch.nn.Module) -> torch.nn.Module:
    """Stores every float parameter of ``model`` in bf16, in place."""
    for p in model.parameters():
        if p.is_floating_point():
            p.data = p.data.to(torch.bfloat16)
    return model


def with_bf16_params(tx: GradientTransformation) -> GradientTransformation:
    """init() takes the bf16 params and keeps (f32 master, tx's state on
    the master); update() runs ``tx`` on the float32 gradients and the
    master, advances the master in place, and emits the float32 delta
    master' - params, which ``apply_updates`` adds in float32 and rounds
    once, so the live param lands on bf16(master')."""

    def init(params):
        master = {n: p.detach().float().clone() for n, p in params.items()}
        return {"master": master, "inner": tx.init(master)}

    def update(updates, state, params=None):
        grads32 = {n: g.float() for n, g in updates.items()}
        inner_updates, state["inner"] = tx.update(grads32, state["inner"],
                                                  state["master"])
        master = apply_updates(state["master"], inner_updates)
        emitted = {n: m - params[n].detach().float()
                   for n, m in master.items()}
        return emitted, state

    return GradientTransformation(init, update)
