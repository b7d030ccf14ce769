"""Ring attention: sequence-parallel self-attention over a process group
(counterpart of ``neurst_tpu/ops/ring_attention.py``).

The time axis is sharded over the group: rank r holds positions
[r T_l, (r + 1) T_l) of q, k and v.  The k/v shards rotate around the
ring (``collectives.batch_rotate``: each rank sends to the next and
receives from the previous) p - 1 times, and the last block is used in
place; each block is folded in with the JAX package's float32 online
softmax and its masks (global key positions < ``lengths``, and key <=
query when ``causal``).  The JAX body is ``jnp`` (no Pallas kernel), and
so is this one: plain torch.

Torch cannot differentiate a send or a receive, so the op is an autograd
``Function``: the forward keeps q, k, v, the output and the row
log-sum-exp, and the backward runs the reverse ring: the k/v blocks
rotate again with their dk/dv accumulators, each rank adds its q's
share to the block it holds (the flash-attention backward of one block),
and one last rotation hands every dk/dv to its block's owner.
"""

import torch

from neurst_tpu_torch.parallel import collectives

__all__ = ["ring_self_attention"]

NEG_INF = -1.0e30


def _block_scores(q32, k_blk, q_pos, kv_pos, lengths, causal):
    """(s [B, N, Tq, Tk] with NEG_INF where masked, mask)."""
    s = torch.einsum("bqnh,bknh->bnqk", q32, k_blk.float())
    mask = (kv_pos[None, :] < lengths[:, None])[:, None, None, :]
    if causal:
        mask = mask & (kv_pos[None, :] <= q_pos[:, None])[None, None]
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask


def _forward(q, k, v, group, lengths, causal):
    p = collectives.group_size(group)
    my = collectives.group_rank(group)
    b, t_local, n, h = q.shape
    q32 = q.float() * (h ** -0.5)
    q_pos = my * t_local + torch.arange(t_local, device=q.device)
    acc = torch.zeros((b, n, t_local, h), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, n, t_local), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l_sum = torch.zeros_like(m)
    k_blk, v_blk = k, v
    for i in range(p):
        src = (my - i) % p
        kv_pos = src * t_local + torch.arange(t_local, device=q.device)
        s, mask = _block_scores(q32, k_blk, q_pos, kv_pos, lengths, causal)
        m_new = torch.maximum(m, s.amax(dim=-1))
        pexp = torch.where(mask, torch.exp(s - m_new[..., None]),
                           torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l_sum = l_sum * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bnqk,bknh->bnqh", pexp, v_blk.float())
        m = m_new
        if i < p - 1:
            k_blk, v_blk = collectives.batch_rotate([k_blk, v_blk], group)
    out = acc / l_sum.clamp_min(1e-20)[..., None]
    lse = m + torch.log(l_sum.clamp_min(1e-37))
    return out.transpose(1, 2).to(q.dtype), lse


def _backward(q, k, v, o, lse, do, group, lengths, causal):
    p = collectives.group_size(group)
    my = collectives.group_rank(group)
    b, t_local, n, h = q.shape
    scale = h ** -0.5
    q32 = q.float() * scale
    do32 = do.float()
    delta = (do32 * o.float()).sum(dim=-1).transpose(1, 2)   # [B, N, Tq]
    q_pos = my * t_local + torch.arange(t_local, device=q.device)
    dq = torch.zeros((b, t_local, n, h), dtype=torch.float32,
                     device=q.device)
    k_blk, v_blk = k, v
    dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv_blk = torch.zeros_like(dk_blk)
    for i in range(p):
        src = (my - i) % p
        kv_pos = src * t_local + torch.arange(t_local, device=q.device)
        s, mask = _block_scores(q32, k_blk, q_pos, kv_pos, lengths, causal)
        prob = torch.where(mask, torch.exp(s - lse[..., None]),
                           torch.zeros_like(s))
        dv_blk = dv_blk + torch.einsum("bnqk,bqnh->bknh", prob, do32)
        dp = torch.einsum("bqnh,bknh->bnqk", do32, v_blk.float())
        ds = prob * (dp - delta[..., None])
        dq = dq + torch.einsum("bnqk,bknh->bqnh", ds, k_blk.float()) * scale
        dk_blk = dk_blk + torch.einsum("bnqk,bqnh->bknh", ds, q32)
        if i < p - 1:
            k_blk, v_blk, dk_blk, dv_blk = collectives.batch_rotate(
                [k_blk, v_blk, dk_blk, dv_blk], group)
    if p > 1:
        # rank my holds block my + 1's sums: one more step takes them home
        dk_blk, dv_blk = collectives.batch_rotate([dk_blk, dv_blk], group)
    return dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype)


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, lengths, group, causal):
        o, lse = _forward(q, k, v, group, lengths, causal)
        ctx.args = (group, causal)
        ctx.save_for_backward(q, k, v, lengths, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lengths, o, lse = ctx.saved_tensors
        group, causal = ctx.args
        dq, dk, dv = _backward(q, k, v, o, lse, do.contiguous(), group,
                               lengths, causal)
        return dq, dk, dv, None, None, None


def ring_self_attention(q, k, v, group=None, lengths=None,
                        causal: bool = False):
    """Attention with the time axis sharded over ``group``.

    q/k/v: [B, T_local, N, H], rank r holding positions [r T_local,
    (r + 1) T_local); ``lengths`` [B] valid key counts (global).  Returns
    [B, T_local, N, H] in q's dtype; differentiable in q, k and v."""
    if lengths is None:
        lengths = torch.full((q.shape[0],),
                             q.shape[1] * collectives.group_size(group),
                             dtype=torch.int32, device=q.device)
    return _RingAttention.apply(q, k, v, lengths.to(q.device).long(), group,
                                bool(causal))
