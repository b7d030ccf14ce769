"""The train and eval steps (counterpart of
``neurst_tpu/parallel/train_step.py``), on one device.

``TrainState.params`` holds the model's own parameters
(``dict(model.named_parameters())``): the step computes their gradients
with autograd and updates them in place, so the model always holds the
live weights.  With ``update_cycle > 1`` every tensor of the batch has a
leading [update_cycle] axis; the micro-batches' raw loss sums and their
gradients accumulate in float32 and are normalized once by the total
token count, as the JAX step does, so ragged micro-batches match one big
batch.  Clipping happens inside the optimizer chain.
"""

import dataclasses
import os
from typing import Any, Callable, Dict, Optional

import torch

from neurst_tpu_torch.optimizers.optimizers import (GradientTransformation,
                                                     apply_updates,
                                                     global_norm)

__all__ = ["TrainState", "make_train_step", "make_eval_step"]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Any

    @classmethod
    def create(cls, params, tx: GradientTransformation):
        return cls(step=0, params=params, opt_state=tx.init(params))


def make_train_step(model, criterion, tx: GradientTransformation,
                    update_cycle: int = 1,
                    lr_schedule: Optional[Callable] = None):
    """Builds ``train_step(state, batch) -> (state, metrics)`` with the
    metrics loss, aux_loss, grad_norm (of the gradients before clipping)
    and, with a schedule, lr (at the step's count).  The returned
    function carries ``compute_grads(params, batch) -> (loss, aux,
    grads)``, the step's forward and backward without the update."""

    # the fused projection + cross-entropy path: the model hands back
    # prelogits and the [B, T, V] logits are never formed
    # (NEURST_FUSED_CE=0 opts out, as in the JAX package)
    want_prelogits = (
        os.environ.get("NEURST_FUSED_CE", "1") != "0"
        and getattr(criterion, "supports_prelogits", False)
        and model.supports_fused_softmax_ce())

    def compute_grads(params, batch):
        names = list(params)
        leaves = [params[n] for n in names]
        if update_cycle == 1:
            out, aux = model.call_train(batch, want_prelogits)
            loss = criterion.reduce_loss(batch, out) + aux
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), aux.detach(), dict(zip(names, grads))

        # accumulate in float32 even when the params (hence the grads)
        # are bf16, so small micro-batch contributions are not rounded
        # away before the f32 master sees them
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        loss_sum = denom = aux_sum = 0.0
        for i in range(update_cycle):
            micro = {k: v[i] for k, v in batch.items()}
            out, aux = model.call_train(micro, want_prelogits)
            micro_loss, micro_denom = criterion.reduce_loss_terms(micro, out)
            # the auxiliary loss weighs by the micro-batch's token count
            micro_aux = aux * micro_denom.detach()
            grads = torch.autograd.grad(micro_loss + micro_aux, leaves)
            torch._foreach_add_(acc, [g.float() for g in grads])
            loss_sum = loss_sum + micro_loss.detach()
            denom = denom + micro_denom.detach()
            aux_sum = aux_sum + micro_aux.detach()
        inv = 1.0 / denom.clamp_min(1e-8)
        return (loss_sum * inv, aux_sum * inv,
                dict(zip(names, torch._foreach_mul(acc, inv))))

    def train_step(state: TrainState, batch):
        loss, aux, grads = compute_grads(state.params, batch)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        apply_updates(state.params, updates)
        metrics = {"loss": loss, "aux_loss": aux,
                   "grad_norm": global_norm(grads)}
        if lr_schedule is not None:
            metrics["lr"] = lr_schedule(state.step)
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=opt_state), metrics

    train_step.compute_grads = compute_grads
    return train_step


def make_eval_step(model, criterion):
    """``eval_step(batch) -> statistics tuple`` of the model's inference
    forward, for ``criterion.reduce_metrics``."""

    def eval_step(batch):
        with torch.no_grad():
            return criterion(batch, model(batch))

    return eval_step
