"""Magnitude pruning as a gradient transformation (counterpart of
``neurst_tpu/sparsity/pruning_optimizer.py``).

``prune_gradients(inner, schedule, filter)`` keeps a binary mask for
every participating parameter and a step count of its own (from 0 on a
fresh optimizer, whatever the trainer's initial step).  Each update runs
``inner``, refreshes the masks from ``params + update`` by magnitude
when ``schedule.should_prune(step)``, and emits
``mask * (params + update) - params``, so pruned weights land on exactly
zero and stay there between refreshes.  The state (inner, masks, step)
saves by name in the trainer's optimizer sidecar.  Over a mesh the
threshold is the whole variable's: ``gather`` rebuilds it from the
rank's part (a tensor-parallel shard, or a pipeline layer held by another
stage), and each rank masks its own part.

The threshold is the JAX package's ``jnp.quantile(|w|, sparsity)``
(linear interpolation), computed here from one sort:
``torch.quantile`` refuses tensors of more than 2^24 elements, which
``transformer_base``'s shared [32768, 512] embedding reaches.  The
index arithmetic keeps JAX's float32 rounding (the element count is a
float32 number, so above 2^24 it rounds), and the interpolation is the
fused multiply-add ``fma(v[high], hw, v[low] * lw)`` that XLA's CPU
backend makes of ``v[low] * lw + v[high] * hw`` (computed in float64 and
rounded once to float32: exact but where the two roundings meet a tie).
"""

import re
from typing import Callable, Optional

import numpy as np
import torch

from neurst_tpu_torch.optimizers.optimizers import GradientTransformation
from neurst_tpu_torch.sparsity.pruning_schedule import PruningSchedule

__all__ = ["prune_gradients", "make_variable_filter", "magnitude_threshold",
           "magnitude_mask"]


def make_variable_filter(include: Optional[str] = None,
                         exclude: Optional[str] = None):
    """name -> bool: whether a variable participates in pruning."""
    inc = re.compile(include) if include else None
    exc = re.compile(exclude) if exclude else None

    def f(name: str) -> bool:
        if inc is not None and not inc.search(name):
            return False
        if exc is not None and exc.search(name):
            return False
        return True
    return f


def magnitude_threshold(weight: torch.Tensor, sparsity) -> torch.Tensor:
    """The ``sparsity`` quantile of |weight| in float32 (a 0-d tensor on
    the weight's device), as ``jnp.quantile``'s linear method gives it;
    NaN where the weight holds a NaN."""
    f32 = np.float32
    flat = weight.detach().reshape(-1).abs().float()
    values = torch.sort(flat).values
    n = f32(flat.numel())
    q = f32(sparsity) * (n - f32(1.0))
    low, high = np.floor(q), np.ceil(q)
    high_weight = q - low
    low_weight = f32(1.0) - high_weight
    low = int(min(max(low, f32(0.0)), n - f32(1.0)))
    high = int(min(max(high, f32(0.0)), n - f32(1.0)))
    device = weight.device
    lw = torch.tensor(low_weight, dtype=torch.float32, device=device)
    hw = torch.tensor(float(high_weight), dtype=torch.float64,
                      device=device)
    threshold = (values[high].double() * hw
                 + (values[low] * lw).double()).float()
    return torch.where(torch.isnan(flat).any(),
                       torch.full_like(threshold, float("nan")), threshold)


def magnitude_mask(weight: torch.Tensor, sparsity, whole=None
                   ) -> torch.Tensor:
    """Keep-mask (weight's dtype) pruning the smallest-|w| ``sparsity``
    fraction: |w| > threshold, the threshold of ``whole`` (the variable
    of which ``weight`` is a part; ``weight`` itself by default)."""
    threshold = magnitude_threshold(weight if whole is None else whole,
                                    sparsity)
    return (weight.detach().abs() > threshold).to(weight.dtype)


def prune_gradients(inner: GradientTransformation,
                    schedule: PruningSchedule,
                    variable_filter: Optional[Callable[[str], bool]] = None,
                    name_of: Optional[Callable[[str], str]] = None,
                    gather: Optional[Callable] = None
                    ) -> GradientTransformation:
    """Wraps ``inner``; ``variable_filter(name_of(name))`` selects the
    parameters that are pruned (all by default; ``name_of`` maps a port
    name to the JAX package's flat name in the trainer); ``gather(name,
    part)`` gives the whole variable of this rank's part (every rank calls
    it for every pruned name; the part itself by default)."""
    variable_filter = variable_filter or (lambda name: True)
    name_of = name_of or (lambda name: name)
    gather = gather or (lambda name, part: part)

    def init(params):
        masks = {n: torch.ones_like(p, dtype=torch.float32
                                    if p.is_floating_point() else p.dtype)
                 for n, p in params.items() if variable_filter(name_of(n))}
        return {"inner": inner.init(params), "masks": masks, "step": 0}

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("prune_gradients needs params")
        updates, state["inner"] = inner.update(updates, state["inner"],
                                               params)
        step = state["step"]
        refresh = schedule.should_prune(step)
        sparsity = schedule.target_sparsity(step) if refresh else None
        out = dict(updates)
        with torch.no_grad():
            for name, mask in state["masks"].items():
                p = params[name].detach()
                new = p + updates[name].to(p.dtype)
                if refresh:
                    mask.copy_(magnitude_mask(new, sparsity,
                                              gather(name, new)))
                out[name] = new * mask.to(p.dtype) - p
        state["step"] = step + 1
        return out, state

    return GradientTransformation(init, update)
