"""Rate-scheduled variable updates, the CTNMT controller (the port's copy
of ``neurst_tpu/optimizers/rate_schedule_optimizer.py``): the gradients
of the parameters whose names match ``pattern`` are scaled by a factor of
the step, 0 before ``freeze_until``, then rising linearly to 1 over
``ramp_steps``, before the inner transformation sees them."""

import re
from typing import Callable, Optional

from neurst_tpu_torch.optimizers.optimizers import GradientTransformation

__all__ = ["rate_scheduled_updates"]


def rate_scheduled_updates(inner: GradientTransformation, pattern: str,
                           freeze_until: int = 0, ramp_steps: int = 1,
                           name_of: Optional[Callable[[str], str]] = None
                           ) -> GradientTransformation:
    """Wraps ``inner``; the state keeps the step count.  ``pattern`` is
    searched in ``name_of(name)`` (the JAX package's flat name of a port
    parameter, ``param_bridge.to_jax_name``, in the trainer)."""
    regex = re.compile(pattern)
    name_of = name_of or (lambda n: n)

    def init(params):
        return {"inner": inner.init(params), "step": 0}

    def update(grads, state, params=None):
        factor = min(max((state["step"] - freeze_until)
                         / max(float(ramp_steps), 1.0), 0.0), 1.0)
        scaled = {n: g * factor if regex.search(name_of(n)) else g
                  for n, g in grads.items()}
        updates, state["inner"] = inner.update(scaled, state["inner"],
                                               params)
        state["step"] += 1
        return updates, state

    return GradientTransformation(init, update)
