"""Pipeline parallelism over the mesh's "stage" axis, GPipe schedule
(counterpart of ``neurst_tpu/layers/pipeline.py``).

A stack with ``pipeline_stages`` S > 1 runs its L layers as S stages of
L / S layers, over M = ``pipeline_microbatches`` (S by default)
micro-batches of its batch.  The layers keep their per-layer modules and
names (``layer_<i>``), which the JAX package's checkpoint bridge reads;
the JAX package's own ``[S, L / S, ...]`` layout is unstacked by
``utils/param_bridge``.

The "stage" axis has G ranks (G divides S); rank g runs stages
[g S / G, (g + 1) S / G), i.e. layers [g L / G, (g + 1) L / G).  Each rank
takes the micro-batches in order: rank 0 feeds micro-batch m from the
stack's input, the others receive it from rank g - 1 (``recv_from``),
and every rank but the last sends its output on (``send_to``).  A
receive waits for its send, so rank g works on micro-batch m while rank
g + 1 works on m - 1: the M + G - 1 ticks of the GPipe fill, steady and
drain.  The backward is autograd's: the backward of a receive sends the
gradient to rank g - 1 and the backward of a send receives it from
rank g + 1, so the gradients flow back through the same schedule.  The
last rank holds the stack's output; the others return zeros of its shape
(the train step runs the criterion on the last stage only).  Over G > 1
ranks each rank holds the parameters of its own layers alone
(``parallel.apply_mesh``), so only those layers' gradients are its own;
the others' are summed over the stage axis.  With G = 1 the stages run
in turn on one rank, as on the JAX package's single device.

Micro-batch m's dropout masks are those of its rows in the whole batch
(``utils.rng.at_row``), so a pipelined step draws the masks of the
per-layer stack.
"""

import torch

from neurst_tpu_torch.parallel import collectives
from neurst_tpu_torch.utils.rng import at_row

__all__ = ["gpipe", "check_pipeline", "ENCODER_TAG", "DECODER_TAG"]

# message tags of the two stacks' micro-batches (the tag is base + m)
ENCODER_TAG, DECODER_TAG = 1 << 20, 2 << 20


def check_pipeline(num_stages, moe_num_experts=0, flash=False, ring=False,
                   encoder=True):
    """The JAX package's errors of a pipelined stack."""
    if int(num_stages or 1) <= 1:
        return
    if int(moe_num_experts or 0) > 1:
        raise ValueError("moe_num_experts>1 requires scan_layers or the "
                         "per-layer stack (pipeline_stages=1)")
    if encoder and (flash or ring):
        raise ValueError(
            "pipeline_stages>1 composes with the dense attention path "
            "only (flash/ring attention operate within a single stage's "
            "devices)")
    if flash:
        raise ValueError("pipeline_stages>1 composes with the dense "
                         "attention path only")


def _rows(t, m, mb, batch):
    """Micro-batch m's rows of a per-row tensor (a tensor whose leading
    dim is 1 is shared by every row)."""
    if t is None or t.shape[0] != batch:
        return t
    return t[m * mb:(m + 1) * mb]


def gpipe(stack, run_layers, x, row_args, num_layers, num_stages,
          num_microbatches, group, tag, dropout_key=None):
    """The layers ``layer_<i>`` of ``stack``, run by ``run_layers(h, lo,
    hi, args, key) -> h`` (layers lo..hi - 1 over ``h`` with the per-row
    tensors ``args``), over ``x`` [B, ...] as a GPipe pipeline.  Returns
    [B, ...]: the output on the stage axis's last rank, zeros
    elsewhere."""
    S, M = int(num_stages), int(num_microbatches or num_stages)
    if num_layers % S:
        raise ValueError(f"num_layers={num_layers} not divisible by "
                         f"pipeline_stages={S}")
    b = x.shape[0]
    if b % M:
        raise ValueError(f"batch {b} not divisible by "
                         f"pipeline_microbatches={M}")
    G, g = collectives.group_size(group), collectives.group_rank(group)
    if S % G:
        raise ValueError(f"pipeline_stages={S} not divisible by the stage "
                         f"axis ({G})")
    lo, hi = g * num_layers // G, (g + 1) * num_layers // G
    mb = b // M
    anchor = None
    if G > 1 and g > 0 and torch.is_grad_enabled():
        # a receive's backward must run: autograd runs only what leads to
        # the tensors it differentiates, so the receive hangs off a
        # parameter of the layers it feeds (whose gradient it leaves be)
        anchor = next(getattr(stack, f"layer_{lo}").parameters())
    outs, sent = [], []
    for m in range(M):
        args = {k: _rows(v, m, mb, b) for k, v in row_args.items()}
        if g == 0:
            h = x[m * mb:(m + 1) * mb]
        elif anchor is not None:
            h = collectives.recv_from(anchor, (mb,) + x.shape[1:], x.dtype,
                                      g - 1, group, tag + m)
        else:
            h = collectives.recv((mb,) + x.shape[1:], x.dtype, x.device,
                                 g - 1, group, tag + m)
        h = run_layers(h, lo, hi, args, at_row(dropout_key, m * mb, mb, M))
        if g < G - 1:
            sent.append(collectives.send_to(h, g + 1, group, tag + m))
        else:
            outs.append(h)
    if g < G - 1:
        out = torch.zeros_like(x)
        return out + torch.stack(sent).sum().to(out.dtype) if sent else out
    return torch.cat(outs, dim=0)
