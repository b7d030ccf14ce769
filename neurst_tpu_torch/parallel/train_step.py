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

Dropout: ``train_step(state, batch, rng)`` takes a
``utils.rng.DropoutKey``, folds it with ``state.step`` and, with
``update_cycle > 1``, splits it per micro-batch, as the JAX step folds and
splits its ``jax.random`` key.  The same (rng, step) gives the same masks.
``rng=None`` is accepted only by a model without dropout (the model
raises otherwise).

``remat=True`` (the trainer's ``gradient_remat``) runs the whole forward
(the model's ``call_train`` and the criterion's reduction, one
micro-batch at a time) under ``torch.utils.checkpoint`` (non-reentrant),
as the JAX step wraps its forward in ``jax.checkpoint``: only the inputs
are kept, and the backward recomputes the forward, kernels included.  As
one segment, the recompute holds every activation again before the
backward starts, so a step's peak memory does not drop.
Dropout masks are a function of (key, site, element), so the recompute
draws the same ones.
"""

import dataclasses
import os
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from neurst_tpu_torch.optimizers.optimizers import (GradientTransformation,
                                                     apply_updates,
                                                     global_norm)
from neurst_tpu_torch.utils.rng import fold_in, split

__all__ = ["TrainState", "make_train_step", "make_eval_step"]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Any

    @classmethod
    def create(cls, params, tx: GradientTransformation):
        return cls(step=0, params=params, opt_state=tx.init(params))


def _grad(loss, leaves):
    """d loss / d leaves, zeros for a parameter the loss does not reach
    (BERT's pooler in CTNMT, the detached teacher trunk of its
    distillation mode), as JAX's gradient gives them."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def make_train_step(model, criterion, tx: GradientTransformation,
                    update_cycle: int = 1,
                    lr_schedule: Optional[Callable] = None,
                    extra_loss_fn: Optional[Callable] = None,
                    remat: bool = False):
    """Builds ``train_step(state, batch, rng=None) -> (state, metrics)``
    with the metrics loss, aux_loss, grad_norm (of the gradients before
    clipping) and, with a schedule, lr (at the step's count).  The
    returned function carries ``compute_grads(params, batch, rng=None) ->
    (loss, aux, grads)``, the step's forward and backward without the
    update, with ``rng`` as the step's (already folded) dropout key.
    ``extra_loss_fn(params)`` adds a regularizer of the parameters (QAT's
    ``clip_l2_penalty``) to the loss, once a step, also under
    accumulation.  ``remat`` recomputes the forward in the backward."""

    # the fused projection + cross-entropy path: the model hands back
    # prelogits and the [B, T, V] logits are never formed
    # (NEURST_FUSED_CE=0 opts out, as in the JAX package)
    want_prelogits = (
        os.environ.get("NEURST_FUSED_CE", "1") != "0"
        and getattr(criterion, "supports_prelogits", False)
        and model.supports_fused_softmax_ce())

    def plain_forward(batch, rng):
        out, aux = model.call_train(batch, want_prelogits, rng)
        return criterion.reduce_loss(batch, out) + aux, aux

    def plain_forward_terms(batch, rng):
        out, aux = model.call_train(batch, want_prelogits, rng)
        loss_sum, denom = criterion.reduce_loss_terms(batch, out)
        return loss_sum, denom, aux

    def forward(batch, rng):
        if remat:  # keep the inputs only; the backward recomputes
            return checkpoint(plain_forward, batch, rng, use_reentrant=False)
        return plain_forward(batch, rng)

    def forward_terms(batch, rng):
        if remat:
            return checkpoint(plain_forward_terms, batch, rng,
                              use_reentrant=False)
        return plain_forward_terms(batch, rng)

    def compute_grads(params, batch, rng=None):
        names = list(params)
        leaves = [params[n] for n in names]
        if update_cycle == 1:
            loss, aux = forward(batch, rng)
            if extra_loss_fn is not None:
                loss = loss + extra_loss_fn(params)
            grads = _grad(loss, leaves)
            return loss.detach(), aux.detach(), dict(zip(names, grads))

        # accumulate in float32 even when the params (hence the grads)
        # are bf16, so small micro-batch contributions are not rounded
        # away before the f32 master sees them
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        loss_sum = denom = aux_sum = 0.0
        keys = [None] * update_cycle if rng is None else split(rng,
                                                                update_cycle)
        for i in range(update_cycle):
            micro = {k: v[i] for k, v in batch.items()}
            micro_loss, micro_denom, aux = forward_terms(micro, keys[i])
            # the auxiliary loss weighs by the micro-batch's token count
            micro_aux = aux * micro_denom.detach()
            grads = _grad(micro_loss + micro_aux, leaves)
            torch._foreach_add_(acc, [g.float() for g in grads])
            # the loss reported includes the auxiliary term, as in JAX
            loss_sum = loss_sum + (micro_loss + micro_aux).detach()
            denom = denom + micro_denom.detach()
            aux_sum = aux_sum + micro_aux.detach()
        inv = 1.0 / denom.clamp_min(1e-8)
        loss = loss_sum * inv
        grads = torch._foreach_mul(acc, inv)
        if extra_loss_fn is not None:
            # a regularizer of the parameters alone: once, not per micro,
            # into the gradients of the parameters it reads
            extra = extra_loss_fn(params)
            loss = loss + extra.detach()
            pairs = [(g, e) for g, e in zip(grads, torch.autograd.grad(
                extra, leaves, allow_unused=True)) if e is not None]
            if pairs:
                torch._foreach_add_([g for g, _ in pairs],
                                    [e.float() for _, e in pairs])
        return loss, aux_sum * inv, dict(zip(names, grads))

    def train_step(state: TrainState, batch, rng=None):
        if rng is not None:
            rng = fold_in(rng, state.step)
        loss, aux, grads = compute_grads(state.params, batch, rng)
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
