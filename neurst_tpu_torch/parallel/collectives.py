"""Every collective and point-to-point call of the port, in one place.

The parallel code never calls ``torch.distributed`` directly: it calls
the functions here, which take a ``ProcessGroup`` (``None``, a mesh axis
of one rank, makes each of them the identity; any group, one rank's
included, goes through its backend) and choose how the bytes move.

Backend.  ``choose_backend(device, local_ranks)`` is a rule, never a
caught error: ``nccl`` where every local rank has a CUDA device of its
own, ``gloo`` where ranks share a device or run on the CPU.  Gloo takes
CUDA tensors in its all-reduce, broadcast and all-gather
(``GLOO_CUDA_OPS``); every other gloo op on a CUDA tensor (send, recv,
reduce-scatter) is staged through host memory here, and only for gloo.

Autograd.  Where a gradient crosses a rank the op is a
``torch.autograd.Function``:

* ``reduce_from`` all-reduces in the forward and is the identity in the
  backward (the sum of a row-parallel layer's partial outputs);
* ``copy_to`` is the identity in the forward and all-reduces in the
  backward (the input of column-parallel layers);
* ``gather_from`` all-gathers along a dim and, in the backward, keeps the
  rank's own slice: every rank computes the same function of the whole
  (the tied softmax's gathered table, vocabulary-sharded logits);
* ``gather_sum_from`` all-gathers and, in the backward, sums the ranks'
  gradients of the rank's own slice (a reduce-scatter): each rank computes
  something else from the whole (the ring encoder's batch and time
  gathers);
* ``scatter_to`` keeps the rank's slice and all-gathers in the backward;
* ``broadcast_from`` copies a tensor from ``src`` and, in the backward,
  sums every rank's gradient into ``src`` (the pipeline's encoder output
  feeds every stage's cross-attention);
* ``sum_over`` all-reduces in the forward and in the backward: every
  rank computes the same function of the sum and the step sums the
  ranks' gradients (the MoE balance loss over the data group);
* ``all_to_all`` splits a dim into one block a rank, sends block j to
  rank j and concatenates the blocks it receives along another dim; its
  backward is the reverse all-to-all (the MoE dispatch and combine over
  the experts' ranks).  NCCL runs ``all_to_all_single``; gloo, which has
  no all-to-all on CUDA tensors, runs an all-gather (``GLOO_CUDA_OPS``)
  and keeps the blocks addressed to the rank;
* ``send_to`` / ``recv_from`` move an activation to the next pipeline
  stage; the backward of a receive sends the gradient back and the
  backward of a send receives it.  Sends never block (``isend``, waited
  by ``wait_pending``); tags keep the pairs apart.
"""

import logging
from typing import List, Optional

import torch
import torch.distributed as dist

__all__ = ["choose_backend", "GLOO_CUDA_OPS", "group_size", "group_rank",
           "all_reduce", "all_gather", "broadcast", "reduce_from", "copy_to",
           "gather_from", "gather_sum_from", "scatter_to", "broadcast_from",
           "send_to", "recv_from", "isend", "recv", "wait_pending",
           "all_gather_object", "batch_rotate", "all_reduce_tensors",
           "broadcast_object", "sum_over", "all_to_all"]

# the gloo ops that take CUDA tensors (ProcessGroupGloo's CUDA works);
# the others are staged through host memory
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather"})

_PENDING: List = []


def choose_backend(device: torch.device, local_ranks: int,
                   cuda_devices: int) -> str:
    """nccl where every local rank has a CUDA device of its own, else
    gloo (ranks sharing one card, or the CPU)."""
    if torch.device(device).type == "cuda" and local_ranks <= cuda_devices:
        backend = "nccl"
    else:
        backend = "gloo"
    logging.info("process group backend %s (%s, %d local ranks, %d CUDA "
                 "devices)", backend, torch.device(device).type, local_ranks,
                 cuda_devices)
    return backend


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(op: str, t: torch.Tensor, group) -> bool:
    """Whether ``op`` on ``t`` goes through host memory: a CUDA tensor
    under gloo for an op gloo runs on the host only."""
    return (t.is_cuda and dist.get_backend(group) == "gloo"
            and op not in GLOO_CUDA_OPS)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """Sum (or ``op``) over the group, in place; returns ``t``."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' tensors concatenated along ``dim`` in rank order."""
    if group is None:
        return t
    n = group_size(group)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` from group rank ``src`` (in place); returns ``t``."""
    if group is not None:
        dist.broadcast(t, dist.get_global_rank(group, src), group=group)
    return t


def _reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of each rank's ``t``, sliced to this rank's
    part along ``dim`` (an all-reduce and a slice: gloo has no
    reduce-scatter)."""
    if group is None:
        return t
    n = group_size(group)
    total = all_reduce(t.contiguous().clone(), group)
    return total.chunk(n, dim=dim)[group_rank(group)].contiguous()


def all_reduce_tensors(tensors, group):
    """Sums a list of tensors over the group in one collective a dtype
    (flattened, reduced, copied back); returns them."""
    if group is None or not tensors:
        return tensors
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return tensors


def broadcast_object(obj, src: int, group):
    """``obj`` from group rank ``src`` (a host object)."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, dist.get_global_rank(group, src),
                               group=group)
    return box[0]


def all_gather_object(obj, group=None) -> list:
    """Every rank's ``obj`` in rank order (host objects)."""
    if group is None:
        return [obj]
    out = [None] * group_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


class _ReduceFrom(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _GatherFrom(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, group, sum_grads):
        ctx.args = (dim, group, sum_grads)
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, group, sum_grads = ctx.args
        if sum_grads:
            return _reduce_scatter(g, dim, group), None, None, None
        own = g.chunk(group_size(group), dim=dim)[group_rank(group)]
        return own.contiguous(), None, None, None


class _ScatterTo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.args = (dim, group)
        n = group_size(group)
        return x.chunk(n, dim=dim)[group_rank(group)].contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.args
        return all_gather(g, dim, group), None, None


class _BroadcastFrom(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, src, group):
        ctx.args = (src, group)
        return broadcast(x.contiguous().clone(), src, group)

    @staticmethod
    def backward(ctx, g):
        src, group = ctx.args
        total = all_reduce(g.contiguous().clone(), group)
        if group_rank(group) != src:
            total = torch.zeros_like(total)
        return total, None, None


class _SumOver(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group
                ) -> torch.Tensor:
    n = group_size(group)
    blocks = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    if dist.get_backend(group) == "nccl":
        got = torch.empty_like(blocks)
        dist.all_to_all_single(got, blocks, group=group)
    else:
        # gloo: every rank's blocks, of which this rank keeps its own (a
        # copy of bytes: bf16 travels as float16 words)
        wire = blocks.view(torch.float16) \
            if blocks.dtype == torch.bfloat16 else blocks
        parts = [torch.empty_like(wire) for _ in range(n)]
        dist.all_gather(parts, wire, group=group)
        rank = group_rank(group)
        got = torch.stack([p[rank] for p in parts]).view(blocks.dtype)
    # got[i]: rank i's block for this rank
    return torch.cat(got.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.args = (split_dim, concat_dim, group)
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim, group = ctx.args
        return _all_to_all(g, concat_dim, split_dim, group), None, None, None


def sum_over(x, group):
    """All-reduce (sum) forward and backward."""
    return x if group is None else _SumOver.apply(x, group)


def all_to_all(x, split_dim: int, concat_dim: int, group):
    """``x`` split along ``split_dim`` into one block a rank, block j sent
    to group rank j; the blocks received from ranks 0..n-1 concatenated
    along ``concat_dim``.  Every rank's ``x`` has one shape.  The backward
    is the reverse all-to-all."""
    return x if group is None else _AllToAll.apply(x, split_dim, concat_dim,
                                                   group)


def reduce_from(x, group):
    """All-reduce (sum) forward, identity backward."""
    return x if group is None else _ReduceFrom.apply(x, group)


def copy_to(x, group):
    """Identity forward, all-reduce backward."""
    return x if group is None else _CopyTo.apply(x, group)


def gather_from(x, dim: int, group):
    """All-gather forward; the backward keeps this rank's slice."""
    return x if group is None else _GatherFrom.apply(x, dim, group, False)


def gather_sum_from(x, dim: int, group):
    """All-gather forward; the backward sums the ranks' gradients of this
    rank's slice."""
    return x if group is None else _GatherFrom.apply(x, dim, group, True)


def scatter_to(x, dim: int, group):
    """This rank's slice along ``dim`` forward, all-gather backward."""
    return x if group is None else _ScatterTo.apply(x, dim, group)


def broadcast_from(x, src: int, group):
    """Broadcast from group rank ``src``; the backward sums every rank's
    gradient into ``src`` (zero elsewhere)."""
    return x if group is None else _BroadcastFrom.apply(x, src, group)


def isend(t: torch.Tensor, dst: int, group, tag: int):
    """Non-blocking send to group rank ``dst`` (waited by
    ``wait_pending``)."""
    t = t.detach().contiguous()
    if _staged("send", t, group):
        t = t.cpu()
    work = dist.isend(t, dist.get_global_rank(group, dst), group=group,
                      tag=tag)
    _PENDING.append((work, t))


def recv(shape, dtype, device, src: int, group, tag: int) -> torch.Tensor:
    """A blocking receive from group rank ``src``."""
    probe = torch.empty(0, device=device)
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if _staged("recv", probe, group)
                      else device)
    dist.recv(buf, dist.get_global_rank(group, src), group=group, tag=tag)
    return buf.to(device)


def wait_pending():
    """Waits for every send issued so far."""
    while _PENDING:
        work, _ = _PENDING.pop(0)
        work.wait()


class _SendTo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dst, group, tag):
        ctx.args = (x.shape, x.dtype, x.device, dst, group, tag)
        isend(x, dst, group, tag)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device, dst, group, tag = ctx.args
        return recv(shape, dtype, device, dst, group, tag), None, None, None


class _RecvFrom(torch.autograd.Function):

    @staticmethod
    def forward(ctx, anchor, shape, dtype, src, group, tag):
        ctx.args = (src, group, tag)
        return recv(shape, dtype, anchor.device, src, group, tag)

    @staticmethod
    def backward(ctx, g):
        src, group, tag = ctx.args
        isend(g, src, group, tag)
        return None, None, None, None, None, None


def send_to(x, dst: int, group, tag: int):
    """Sends ``x`` to group rank ``dst``; returns a 0-d zero that the
    caller adds into its result, so the backward receives x's gradient
    from ``dst``."""
    return _SendTo.apply(x, dst, group, tag)


def recv_from(anchor, shape, dtype, src: int, group, tag: int):
    """Receives a tensor from group rank ``src``; ``anchor`` (a tensor
    that requires grad) makes the backward run, which sends the
    gradient back to ``src``."""
    return _RecvFrom.apply(anchor, tuple(shape), dtype, src, group, tag)


def batch_rotate(tensors, group) -> list:
    """Each tensor sent to the next rank of the ring and replaced by the
    previous rank's (``batch_isend_irecv``; staged through host memory
    for CUDA tensors under gloo)."""
    if group is None:
        return list(tensors)
    n = group_size(group)
    rank = group_rank(group)
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prv = dist.get_global_rank(group, (rank - 1) % n)
    device = tensors[0].device
    staged = _staged("send", tensors[0], group)
    sends = [t.detach().contiguous().cpu() if staged
             else t.detach().contiguous() for t in tensors]
    bufs = [torch.empty_like(t) for t in sends]
    ops = []
    for s, b in zip(sends, bufs):
        ops.append(dist.P2POp(dist.isend, s, nxt, group))
        ops.append(dist.P2POp(dist.irecv, b, prv, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [b.to(device) for b in bufs]
