"""The train and eval steps (counterpart of
``neurst_tpu/parallel/train_step.py``), on one rank or over a mesh.

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

Over a mesh (``mesh`` with more than one rank on "data" or "stage") every
micro-batch's raw loss sum and token count are kept apart, as under
accumulation: the gradients of the sums are summed over the "stage" axis
and then over "data", and divided by the token count summed the same
way, so the loss and gradients are those of one rank on the global
batch.  Under pipelining only the last stage runs the criterion (the
others hold zeros in place of the model's output, whose backward still
reaches their pipeline sends), and only the parameters that every stage
holds are summed over "stage": a pipeline layer (``stage_local``, the
names ``parallel.apply_mesh`` gives one stage) has its whole gradient on
its own stage.  The experts that a rank holds alone over "data"
(the MoE layers with an ``ep_group``) are not summed over "data": the all-to-all's backward
has already summed every rank's tokens into them.  A rank's dropout key carries its rows' offset in the
global micro-batch (``at_row``), so its masks are those of the
single-rank step.  Tensor-parallel ranks compute the same loss and need
no reduction of it; ``norm_fn`` is the gradient norm over their shards
and stages.
"""

import dataclasses
import os
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from neurst_tpu_torch.optimizers.optimizers import (GradientTransformation,
                                                     apply_updates,
                                                     global_norm)
from neurst_tpu_torch.parallel import collectives
from neurst_tpu_torch.utils.rng import at_row, fold_in, split

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


def _zero_through(out):
    """A zero that depends on every tensor of a model output that needs a
    gradient, so the backward runs through them."""
    tensors = out.values() if isinstance(out, dict) else [out]
    return sum(t.sum() * 0 for t in tensors
               if torch.is_tensor(t) and t.requires_grad)


def make_train_step(model, criterion, tx: GradientTransformation,
                    update_cycle: int = 1,
                    lr_schedule: Optional[Callable] = None,
                    extra_loss_fn: Optional[Callable] = None,
                    remat: bool = False, mesh=None,
                    norm_fn: Optional[Callable] = None,
                    stage_local=frozenset()):
    """Builds ``train_step(state, batch, rng=None) -> (state, metrics)``
    with the metrics loss, aux_loss, grad_norm (of the gradients before
    clipping) and, with a schedule, lr (at the step's count).  The
    returned function carries ``compute_grads(params, batch, rng=None) ->
    (loss, aux, grads)``, the step's forward and backward without the
    update, with ``rng`` as the step's (already folded) dropout key.
    ``extra_loss_fn(params)`` adds a regularizer of the parameters (QAT's
    ``clip_l2_penalty``) to the loss, once a step, also under
    accumulation.  ``remat`` recomputes the forward in the backward.
    ``mesh`` (``parallel.mesh.Mesh``) reduces the step over its "data" and
    "stage" axes; ``norm_fn`` replaces ``global_norm`` for the metric;
    ``stage_local`` names the parameters that one pipeline stage holds."""
    norm_fn = norm_fn or global_norm
    distributed = mesh is not None and (mesh.shape["data"] > 1
                                        or mesh.shape["stage"] > 1)
    if not distributed:
        mesh = None
    # the experts a rank holds alone over "data" (parallel.apply_mesh)
    data_local = frozenset(
        f"{prefix}.{leaf}" for prefix, m in model.named_modules()
        if getattr(m, "ep_group", None) is not None
        for leaf, _ in m.named_parameters() if leaf.startswith("expert_"))
    # only the last pipeline stage holds the model's output
    last_stage = mesh is None \
        or mesh.coords["stage"] == mesh.shape["stage"] - 1

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
        if not last_stage:
            return _zero_through(out), aux * 0, aux * 0
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

    def accumulate(params, batch, rng):
        """The raw loss sums, token counts and gradients of every
        micro-batch (one without accumulation), summed over the mesh's
        "stage" and "data" axes, then normalized once by the token count.
        Sums run in float32 even when the params (hence the grads) are
        bf16, so small micro-batch contributions are not rounded away
        before the f32 master sees them."""
        names = list(params)
        leaves = [params[n] for n in names]
        data, data_coord = 1, 0
        if mesh is not None:
            data, data_coord = mesh.shape["data"], mesh.coords["data"]
        if update_cycle == 1:
            micros, keys = [batch], [rng]
        else:
            micros = [{k: v[i] for k, v in batch.items()}
                      for i in range(update_cycle)]
            keys = [None] * update_cycle if rng is None \
                else split(rng, update_cycle)
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        stats = torch.zeros(3, dtype=torch.float32,
                            device=leaves[0].device)
        for micro, key in zip(micros, keys):
            rows = next(v.shape[0] for v in micro.values() if len(v.shape))
            micro_loss, micro_denom, aux = forward_terms(
                micro, at_row(key, data_coord * rows, rows, data))
            # the auxiliary loss weighs by the micro-batch's token count,
            # and the loss reported includes it, as in JAX
            micro_aux = aux * micro_denom.detach()
            total = micro_loss + micro_aux
            grads = _grad(total, leaves)
            torch._foreach_add_(acc, [g.float() for g in grads])
            stats += torch.stack([total.detach(), micro_denom.detach(),
                                  micro_aux.detach()])
        if mesh is not None:
            collectives.wait_pending()
            shared = [a for n, a in zip(names, acc) if n not in stage_local]
            collectives.all_reduce_tensors(shared + [stats],
                                           mesh.group("stage"))
            over_data = [a for n, a in zip(names, acc) if n not in data_local]
            collectives.all_reduce_tensors(over_data + [stats],
                                           mesh.group("data"))
        inv = 1.0 / stats[1].clamp_min(1e-8)
        grads = torch._foreach_mul(acc, inv)
        loss = stats[0] * inv
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
        return loss, stats[2] * inv, dict(zip(names, grads))

    def compute_grads(params, batch, rng=None):
        if update_cycle > 1 or distributed:
            return accumulate(params, batch, rng)
        names = list(params)
        leaves = [params[n] for n in names]
        loss, aux = forward(batch, rng)
        if extra_loss_fn is not None:
            loss = loss + extra_loss_fn(params)
        grads = _grad(loss, leaves)
        return loss.detach(), aux.detach(), dict(zip(names, grads))

    def train_step(state: TrainState, batch, rng=None):
        if rng is not None:
            rng = fold_in(rng, state.step)
        loss, aux, grads = compute_grads(state.params, batch, rng)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        apply_updates(state.params, updates)
        metrics = {"loss": loss, "aux_loss": aux,
                   "grad_norm": norm_fn(grads)}
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
