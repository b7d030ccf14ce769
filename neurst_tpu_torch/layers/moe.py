"""Mixture-of-experts feed-forward (counterpart of
``neurst_tpu/layers/moe.py``).

``MoeFFN`` takes the place of ``TransformerFFN`` in every
``moe_layer_frequency``-th layer.  Its parameters keep the JAX layouts
and names: ``router_kernel`` [H, E], ``expert_dense1_kernel`` [E, H, F],
``expert_dense1_bias`` [E, F], ``expert_dense2_kernel`` [E, F, O] and
``expert_dense2_bias`` [E, O], so ``utils/param_bridge`` carries them as
they are.

Routing is the JAX layer's, written with the same one-hot tensors: a
float32 router, top-k choices with a per-expert capacity of
``ceil(T * K * capacity_factor / E)`` tokens of a row (at most T; earlier
tokens win, overflow falls through the residual), the GShard
renormalisation of the gates for K > 1, routing without drops for
evaluation windows of T <= 16 (decode steps and speculative windows), and
the Switch load-balancing loss in training (``E * coef * sum(frac *
mean_prob)`` over first choices).  The dispatch and combine are einsums
against the [B, T, E, C] one-hot tensors, as in JAX (no Pallas kernel
runs there; the expert FFN's dropout is the mask kernel's site).  Ties in
``argmax`` take the first index in both packages.

Over a mesh (``parallel.apply_mesh`` sets the groups): the balance loss
sums the first-choice counts and the router probabilities over the
"data" group (``data_group``) before dividing by the global token count,
so every rank computes the JAX package's loss of the global batch; the
sum's backward sums the ranks' gradients (``collectives.sum_over``).
With the experts sharded over "data" (``ep_group``, E / dp experts a
rank, as the JAX package maps "expert" to "data") the dispatched tokens
``[B, E, C, H]`` are laid out as ``[E, B x C, H]`` (in evaluation padded
to the group's largest B x C) and sent by an all-to-all to their experts' ranks
(``[E / dp, dp x N, H]``); the rank's experts run there and the reverse
all-to-all brings their outputs back before the combine.  Capacity stays
per row, as in JAX.  The expert dropout site of a sharded layer draws
the rank's own masks (its key's row offset dropped and the data
coordinate folded in, ``utils.rng.at_shard``): masks at the site's rate,
independent across ranks, not the one-rank step's.  Decode loops end on
each rank on its own, so a rank whose search has ended calls
``drain_experts`` to serve its experts to the others until every rank of
the group has ended.

The auxiliary loss reaches the train step through ``collect_aux_losses``,
the port's stand-in for flax's sown "losses" collection.  Router jitter
(``router_jitter`` > 0, training only) multiplies the logits by uniform
noise in [1 - eps, 1 + eps] drawn from the port's Philox stream (see
``utils/rng.py``, ``SIDE_ROUTER``), not from JAX's key: a kept
difference; a data-parallel rank draws its rows' noise of the one-rank
batch.
"""

import contextlib
import math

import torch
from torch import nn
from torch.nn import functional as F

from neurst_tpu_torch.layers.common_layers import (activation_by_name,
                                                   apply_dropout)
from neurst_tpu_torch.ops.fused_dropout import dropout_words
from neurst_tpu_torch.parallel import collectives
from neurst_tpu_torch.utils.rng import SIDE_ROUTER, at_shard, at_site

__all__ = ["MoeFFN", "collect_aux_losses", "router_jitter_noise",
           "drain_experts", "expert_rank_key"]


def _lecun_normal(shape, fan_in, generator):
    """flax's ``lecun_normal`` with the fan-in flax computes for a flax
    layout (the input axis times every axis but the last two)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    draw = torch.empty(shape)
    return nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def router_jitter_noise(shape, eps: float, key, device=None):
    """Uniform noise in [1 - eps, 1 + eps) of ``shape``: element i takes
    the top 24 bits of the i-th Philox word of ``key`` (``ops/
    fused_dropout.dropout_words``), moved on by the key's batch-row
    offset, so a data-parallel rank draws its rows' noise of the one-rank
    batch."""
    n = math.prod(shape)
    offset = int(key.row) * (n // int(key.rows)) if key.row else 0
    words = dropout_words(n + offset % 4, key, device,
                          offset // 4)[offset % 4:]
    u = (words >> 8).to(torch.float32) * 2.0 ** -24
    lo, hi = 1.0 - eps, 1.0 + eps
    return (u * (hi - lo) + lo).reshape(shape)


class _AuxSink(object):
    def __init__(self):
        self.losses = []

    def total(self, device):
        out = torch.zeros((), dtype=torch.float32, device=device)
        for loss in self.losses:
            out = out + loss.float()
        return out


@contextlib.contextmanager
def collect_aux_losses(model):
    """Inside, every ``MoeFFN`` of ``model`` that runs in training adds
    its auxiliary loss to the yielded sink (``sink.total(device)`` sums
    them)."""
    sink = _AuxSink()
    layers = [m for m in model.modules() if isinstance(m, MoeFFN)]
    for m in layers:
        m.aux_sink = sink
    try:
        yield sink
    finally:
        for m in layers:
            m.aux_sink = None


class MoeFFN(nn.Module):
    """E expert FFNs behind a router; top_k 1 is a Switch layer, 2 the
    GShard top-2 router."""

    def __init__(self, input_size: int, num_experts: int, filter_size: int,
                 output_size: int, top_k: int = 1,
                 capacity_factor: float = 1.25,
                 eval_capacity_factor: float = 2.0,
                 aux_loss_coef: float = 0.01, router_jitter: float = 0.01,
                 activation: str = "relu", dropout_rate: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        if not (num_experts >= 1 and 1 <= top_k <= num_experts):
            raise ValueError(f"MoeFFN: top_k {top_k} of {num_experts} "
                             f"experts")
        self.num_experts, self.top_k = int(num_experts), int(top_k)
        self.capacity_factor = float(capacity_factor)
        self.eval_capacity_factor = float(eval_capacity_factor)
        self.aux_loss_coef = float(aux_loss_coef)
        self.router_jitter = float(router_jitter)
        self.activation = activation
        self._activate = activation_by_name(activation)
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        e = self.num_experts
        self.router_kernel = nn.Parameter(torch.empty(input_size, e))
        self.expert_dense1_kernel = nn.Parameter(
            torch.empty(e, input_size, filter_size))
        self.expert_dense1_bias = nn.Parameter(torch.empty(e, filter_size))
        self.expert_dense2_kernel = nn.Parameter(
            torch.empty(e, filter_size, output_size))
        self.expert_dense2_bias = nn.Parameter(torch.empty(e, output_size))
        self.aux_sink = None
        # parallel.apply_mesh: the "data" group of the balance loss, and
        # the experts' group with this rank's coordinate when they are
        # sharded over it
        self.data_group = None
        self.ep_group = None
        self.ep_rank = 0

    def init_own_params(self, generator=None):
        h, e = self.router_kernel.shape
        f = self.expert_dense1_kernel.shape[-1]
        with torch.no_grad():
            self.router_kernel.copy_(_lecun_normal((h, e), h, generator))
            self.expert_dense1_kernel.copy_(_lecun_normal(
                self.expert_dense1_kernel.shape, h * e, generator))
            self.expert_dense2_kernel.copy_(_lecun_normal(
                self.expert_dense2_kernel.shape, f * e, generator))
            self.expert_dense1_bias.zero_()
            self.expert_dense2_bias.zero_()

    def capacity(self, tokens: int, is_training: bool) -> int:
        cf = self.capacity_factor if is_training \
            else self.eval_capacity_factor
        capacity = max(1, int(math.ceil(
            tokens * self.top_k * cf / self.num_experts)))
        capacity = min(capacity, tokens)
        if not is_training and tokens <= 16:
            # decode steps and speculative windows route without drops,
            # so a multi-token verification equals stepwise decode
            capacity = tokens
        return capacity

    def forward(self, x, is_training: bool = False, dropout_key=None):
        b, t, _ = x.shape
        e, k = self.num_experts, self.top_k
        dtype = self.dtype
        logits = torch.einsum("bth,he->bte", x.float(),
                              self.router_kernel.float())
        if is_training and self.router_jitter > 0.0:
            if dropout_key is None:
                raise ValueError("MoE router jitter in training needs a "
                                 "dropout key (utils.rng.DropoutKey)")
            logits = logits * router_jitter_noise(
                logits.shape, self.router_jitter,
                at_site(dropout_key, SIDE_ROUTER << 24), logits.device)
        probs = torch.softmax(logits, dim=-1)               # [B, T, E]
        capacity = self.capacity(t, is_training)

        combine = torch.zeros((b, t, e, capacity), dtype=torch.float32,
                              device=x.device)
        remaining = probs
        fill = torch.zeros((b, e), dtype=torch.float32, device=x.device)
        first = None
        for _ in range(k):
            with torch.no_grad():
                idx = torch.argmax(remaining, dim=-1)        # [B, T]
                onehot = F.one_hot(idx, e).float()
                if first is None:
                    first = onehot
                # a token's place in its expert's buffer: earlier tokens
                # of the row win
                pos = torch.cumsum(onehot, dim=1) - 1.0 + fill[:, None, :]
                pos = (pos * onehot).sum(dim=-1)             # [B, T]
                keep = (pos < capacity).float()
                # a dropped token's place is past the buffer: no slot
                slot = F.one_hot(pos.long().clamp(max=capacity),
                                 capacity + 1)[..., :capacity].float()
                fill = fill + (onehot * keep[:, :, None]).sum(dim=1)
            gate = (probs * onehot).sum(dim=-1)              # [B, T]
            combine = combine + (gate * keep)[:, :, None, None] \
                * onehot[:, :, :, None] * slot[:, :, None, :]
            remaining = remaining * (1.0 - onehot)
        if k > 1:
            denom = combine.sum(dim=(2, 3), keepdim=True)
            combine = torch.where(denom > 0.0,
                                  combine / denom.clamp_min(1e-9), 0.0)
        dispatch = (combine > 0.0).to(dtype)

        if is_training:
            aux = self._balance_loss(first, probs)
            if self.aux_sink is not None:
                self.aux_sink.losses.append(aux)

        expert_in = torch.einsum("btec,bth->bech", dispatch, x.to(dtype))
        if self.ep_group is None:
            h = torch.einsum("bech,ehf->becf", expert_in,
                             self.expert_dense1_kernel.to(dtype)) \
                + self.expert_dense1_bias.to(dtype)[None, :, None, :]
            h = self._activate(h)
            h = apply_dropout(h, self.dropout_rate, is_training, dropout_key)
            out = torch.einsum("becf,efh->bech", h,
                               self.expert_dense2_kernel.to(dtype)) \
                + self.expert_dense2_bias.to(dtype)[None, :, None, :]
        else:
            tokens = expert_in.permute(1, 0, 2, 3).reshape(e, b * capacity,
                                                           -1)
            out = self._sharded_experts(tokens, is_training, dropout_key)
            out = out.reshape(e, b, capacity, -1).permute(1, 0, 2, 3)
        y = torch.einsum("btec,bech->bth", combine.to(dtype), out)
        return y.to(dtype)

    def _balance_loss(self, first, probs):
        """``E x coef x sum(frac x mean_prob)`` over first choices, of the
        global batch: counts and probabilities summed over the data
        group, divided by its token count."""
        e = self.num_experts
        counts = first.sum(dim=(0, 1))
        tokens = torch.full((1,), float(first.shape[0] * first.shape[1]),
                            device=first.device)
        prob_sum = probs.sum(dim=(0, 1))
        if self.data_group is not None:
            counts = collectives.all_reduce(torch.cat([counts, tokens]),
                                            self.data_group)
            counts, tokens = counts[:e], counts[e:]
            prob_sum = collectives.sum_over(prob_sum, self.data_group)
        frac, mean_prob = counts / tokens, prob_sum / tokens
        return (frac * mean_prob).sum() * (e * self.aux_loss_coef)

    def _sharded_experts(self, tokens, is_training, dropout_key, done=False):
        """The expert outputs [E, N, O] of this rank's tokens [E, N, H],
        each computed on its expert's rank; None when every rank of the
        group is ``done`` (``drain_experts``).  In training every rank's N
        is B x C of its equal share of the batch, so only evaluation
        exchanges the sizes and pads to the largest."""
        group = self.ep_group
        n = tokens.shape[1]
        if not is_training:
            # decode: the ranks' batches and ends differ
            sizes = collectives.all_gather(
                torch.tensor([[n, int(done)]], device=tokens.device), 0,
                group).tolist()
            if all(d for _, d in sizes):
                return None
            n_max = max(s for s, _ in sizes)
            if n_max > n:
                tokens = F.pad(tokens, (0, 0, 0, n_max - n))
        dtype = self.dtype
        mine = collectives.all_to_all(tokens, 0, 1, group)   # [E/dp, dp N, H]
        h = torch.einsum("enh,ehf->enf", mine,
                         self.expert_dense1_kernel.to(dtype)) \
            + self.expert_dense1_bias.to(dtype)[:, None, :]
        h = self._activate(h)
        h = apply_dropout(h, self.dropout_rate, is_training,
                          expert_rank_key(dropout_key, self.ep_rank))
        out = torch.einsum("enf,efo->eno", h,
                           self.expert_dense2_kernel.to(dtype)) \
            + self.expert_dense2_bias.to(dtype)[:, None, :]
        out = collectives.all_to_all(out, 1, 0, group)       # [E, N_max, O]
        return out[:, :n]


def expert_rank_key(key, rank: int):
    """The key of a split expert site on data rank ``rank``: the row
    offset dropped (the site's tensor leads by expert, its rows come from
    every rank) and the rank folded in, so the ranks draw independent
    masks (None stays None)."""
    if key is None:
        return None
    return at_shard(key._replace(row=0, shards=1, rows=0), rank, field=1)


def drain_experts(model):
    """After this rank's decode has ended: serve this rank's experts to
    the decode steps of the other ranks of the group, one pass over the
    decoder's sharded MoE layers a step, until every rank has ended (all
    of them call this)."""
    layers = [m for name, m in model.named_modules()
              if isinstance(m, MoeFFN) and m.ep_group is not None
              and "decoder" in name.split(".")]
    if not layers:
        return
    with torch.no_grad():
        while True:
            for m in layers:
                device = m.expert_dense1_kernel.device
                idle = torch.zeros(
                    (m.num_experts, 0, m.expert_dense1_kernel.shape[1]),
                    dtype=m.dtype, device=device)
                if m._sharded_experts(idle, False, None, done=True) is None:
                    return
