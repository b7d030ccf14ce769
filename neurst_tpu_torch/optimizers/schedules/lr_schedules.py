"""Learning-rate schedules (counterpart of
``neurst_tpu/optimizers/schedules/lr_schedules.py``).  A schedule is a
callable ``count -> lr`` evaluated at the optimizer's step count, as
optax evaluates its schedules.

``noam`` and ``inverse_sqrt`` count from an initial step: the one they
are given, else the one registered with ``utils.compat`` when they are
built (the JAX package's behaviour).  The trainer registers the resumed
step only where it starts a fresh optimizer; where it restores the
optimizer's own count it registers 0 (ROADMAP R6).
"""

import math
from typing import Optional

from neurst_tpu_torch.utils import compat
from neurst_tpu_torch.utils.flags_core import Flag
from neurst_tpu_torch.utils.registry import setup_registry

__all__ = ["LRSchedule", "build_lr_schedule", "register_lr_schedule",
           "NoamSchedule", "InverseSqrtSchedule", "PiecewiseSchedule",
           "ConstantSchedule"]


def _initial_step(initial_step: Optional[int]) -> float:
    return float(compat.get_registered_initial_step()
                 if initial_step is None else initial_step)


class LRSchedule(object):

    def __init__(self, args=None):
        self._args = dict(args or {})

    @staticmethod
    def class_or_method_args():
        return []

    def __call__(self, global_step) -> float:
        raise NotImplementedError


build_lr_schedule, register_lr_schedule = setup_registry(
    "lr_schedule", base_class=LRSchedule,
    create_fn=lambda cls, args, **kwargs: cls(args, **kwargs))


@register_lr_schedule("noam")
class NoamSchedule(LRSchedule):
    """lr = factor * dmodel^-0.5 * min(1, step / warmup)
    / sqrt(max(step, warmup)), with step counted from ``initial_step``
    (the step a resumed run starts at; the registered one by default)
    plus one, and the factor decaying
    linearly from ``initial_factor`` to ``end_factor`` over
    ``decay_steps`` from ``start_decay_at`` when all three are given."""

    def __init__(self, args=None, initial_step: Optional[int] = None):
        super().__init__(args)
        a = self._args
        self._dmodel = a["dmodel"]
        self._warmup_steps = float(a.get("warmup_steps") or 4000)
        self._initial_step = _initial_step(initial_step)
        self._initial_factor = float(a.get("initial_factor") or 1.0)
        end_factor = a.get("end_factor")
        if (end_factor is not None and a.get("start_decay_at") is not None
                and a.get("decay_steps") is not None):
            self._end_factor = float(end_factor)
            self._start_decay_at = float(a["start_decay_at"])
            self._decay_steps = float(a["decay_steps"])
        else:
            self._end_factor = self._initial_factor
            self._start_decay_at = 0.0
            self._decay_steps = 1.0

    @staticmethod
    def class_or_method_args():
        return [
            Flag("dmodel", dtype=Flag.TYPE.INTEGER, default=None,
                 help="The model dimension in the hidden layers."),
            Flag("warmup_steps", dtype=Flag.TYPE.INTEGER, default=4000,
                 help="The number of linear warmup steps."),
            Flag("initial_factor", dtype=Flag.TYPE.FLOAT, default=1.,
                 help="The initial learning rate scaling factor."),
            Flag("end_factor", dtype=Flag.TYPE.FLOAT, default=None,
                 help="The final decayed scaling factor."),
            Flag("start_decay_at", dtype=Flag.TYPE.INTEGER, default=0,
                 help="The step at which the factor starts decaying."),
            Flag("decay_steps", dtype=Flag.TYPE.INTEGER, default=None,
                 help="The factor decays to end_factor over this many steps."),
        ]

    def __call__(self, global_step) -> float:
        step = float(global_step) + self._initial_step + 1.0
        step_factor = max(min(step - self._start_decay_at,
                              self._decay_steps), 0.0)
        lr = self._end_factor + (self._initial_factor - self._end_factor) \
            * (1.0 - step_factor / self._decay_steps)
        lr = lr * (self._dmodel ** -0.5)
        lr = lr * min(1.0, step / self._warmup_steps)
        return lr / max(step, self._warmup_steps) ** 0.5


@register_lr_schedule("inverse_sqrt")
class InverseSqrtSchedule(LRSchedule):
    """fairseq's inverse square root with a linear warm-up from
    ``init_lr`` to ``peak_lr``, step counted as noam's."""

    def __init__(self, args=None, initial_step: Optional[int] = None):
        super().__init__(args)
        a = self._args
        self._warmup_steps = float(a.get("warmup_steps") or 4000)
        self._peak_lr = float(a.get("peak_lr") if a.get("peak_lr")
                              is not None else 5e-4)
        self._init_lr = float(a.get("init_lr") or 0.0)
        self._initial_step = _initial_step(initial_step)

    @staticmethod
    def class_or_method_args():
        return [
            Flag("warmup_steps", dtype=Flag.TYPE.INTEGER, default=4000,
                 help="The number of linear warmup steps."),
            Flag("peak_lr", dtype=Flag.TYPE.FLOAT, default=5e-4,
                 help="The peak learning rate at the end of warmup."),
            Flag("init_lr", dtype=Flag.TYPE.FLOAT, default=0.,
                 help="The initial learning rate."),
        ]

    def __call__(self, global_step) -> float:
        step = float(global_step) + self._initial_step + 1.0
        if step < self._warmup_steps:
            return self._init_lr + (self._peak_lr - self._init_lr) \
                * (step / self._warmup_steps)
        return self._peak_lr * math.sqrt(self._warmup_steps) \
            / math.sqrt(max(step, self._warmup_steps))


@register_lr_schedule("piecewise")
class PiecewiseSchedule(LRSchedule):
    """values[i] from boundaries[i - 1] on (values[0] before the
    first)."""

    def __init__(self, args=None):
        super().__init__(args)
        a = self._args
        self._boundaries = [float(b) for b in (a.get("boundaries") or [])]
        self._values = [float(v) for v in (a.get("values") or [1e-3])]
        if len(self._values) != len(self._boundaries) + 1:
            raise ValueError("piecewise needs len(values) == "
                             "len(boundaries) + 1")

    @staticmethod
    def class_or_method_args():
        return [
            Flag("boundaries", dtype=Flag.TYPE.FLOAT, default=None,
                 multiple=True, help="The step boundaries."),
            Flag("values", dtype=Flag.TYPE.FLOAT, default=None, multiple=True,
                 help="The learning rate in each interval."),
        ]

    def __call__(self, global_step) -> float:
        lr = self._values[0]
        for b, v in zip(self._boundaries, self._values[1:]):
            if float(global_step) >= b:
                lr = v
        return lr


@register_lr_schedule("constant")
class ConstantSchedule(LRSchedule):

    @staticmethod
    def class_or_method_args():
        return [Flag("learning_rate", dtype=Flag.TYPE.FLOAT, default=1e-3,
                     help="The constant learning rate.")]

    def __call__(self, global_step) -> float:
        return float(self._args.get("learning_rate") or 1e-3)
