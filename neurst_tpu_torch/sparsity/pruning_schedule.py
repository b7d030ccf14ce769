"""Weight-pruning schedules (counterpart of
``neurst_tpu/sparsity/pruning_schedule.py``).

``PruningSchedule`` gates mask refreshes by begin / end / frequency;
``ConstantSparsity`` holds one target and ``PolynomialDecay`` ramps from
the initial to the final sparsity.  The step is the pruning transform's
own count, a host integer, so ``should_prune`` is a Python bool and
``target_sparsity`` a float32 number computed as the JAX package traces
it: float32 arithmetic throughout, and the power through the C
library's ``powf`` (what XLA's CPU backend calls for a float32 power;
torch's and numpy's float32 powers round differently).
"""

import ctypes
import ctypes.util
import functools

import numpy as np

from neurst_tpu_torch.utils.flags_core import Flag
from neurst_tpu_torch.utils.registry import setup_registry

__all__ = ["PruningSchedule", "ConstantSparsity", "PolynomialDecay",
           "build_pruning_schedule", "register_pruning_schedule"]


@functools.lru_cache(maxsize=None)
def _powf():
    fn = ctypes.CDLL(ctypes.util.find_library("m")).powf
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def powf(x, y) -> np.float32:
    """x ** y of two float32 numbers by the C library's ``powf``."""
    return np.float32(_powf()(float(np.float32(x)), float(np.float32(y))))


class PruningSchedule(object):

    def __init__(self, args=None):
        self._args = dict(args or {})
        self._begin_step = int(self._args.get("begin_pruning_step") or 0)
        self._end_step = int(self._args.get("end_pruning_step") or -1)
        self._frequency = int(self._args.get("pruning_frequency") or 100)

    @staticmethod
    def class_or_method_args():
        return [
            Flag("begin_pruning_step", dtype=Flag.TYPE.INTEGER, default=0,
                 help="Step at which pruning begins."),
            Flag("end_pruning_step", dtype=Flag.TYPE.INTEGER, default=-1,
                 help="Step at which pruning ends (-1 = never)."),
            Flag("pruning_frequency", dtype=Flag.TYPE.INTEGER, default=100,
                 help="Re-prune every this many steps."),
        ]

    def should_prune(self, step: int) -> bool:
        """Whether masks are recomputed at ``step``."""
        in_window = step >= self._begin_step
        if self._end_step >= 0:
            in_window = in_window and step <= self._end_step
        return in_window and (step - self._begin_step) % self._frequency == 0

    def target_sparsity(self, step: int) -> np.float32:
        """Fraction of weights pruned at ``step`` (float32)."""
        raise NotImplementedError


class ConstantSparsity(PruningSchedule):
    """Fixed sparsity throughout the pruning window."""

    def __init__(self, args=None):
        super().__init__(args)
        self._sparsity = float(self._args.get("target_sparsity") or 0.5)

    @staticmethod
    def class_or_method_args():
        return PruningSchedule.class_or_method_args() + [
            Flag("target_sparsity", dtype=Flag.TYPE.FLOAT, default=0.5,
                 help="The constant target sparsity."),
        ]

    def target_sparsity(self, step: int) -> np.float32:
        return np.float32(self._sparsity)


class PolynomialDecay(PruningSchedule):
    """Sparsity ramps from initial to final with a cubic-by-default
    polynomial; with no end step the ramp ends at ``begin + 1``."""

    def __init__(self, args=None):
        super().__init__(args)
        self._initial = float(self._args.get("initial_sparsity") or 0.0)
        self._final = float(self._args.get("final_sparsity") or 0.5)
        self._power = float(self._args.get("power") or 3.0)

    @staticmethod
    def class_or_method_args():
        return PruningSchedule.class_or_method_args() + [
            Flag("initial_sparsity", dtype=Flag.TYPE.FLOAT, default=0.,
                 help="The starting sparsity."),
            Flag("final_sparsity", dtype=Flag.TYPE.FLOAT, default=0.5,
                 help="The final sparsity."),
            Flag("power", dtype=Flag.TYPE.FLOAT, default=3.,
                 help="The polynomial power."),
        ]

    def target_sparsity(self, step: int) -> np.float32:
        f32 = np.float32
        end = float(self._end_step if self._end_step >= 0
                    else self._begin_step + 1)
        span = max(end - self._begin_step, 1.0)
        frac = (f32(step) - f32(self._begin_step)) / f32(span)
        frac = min(max(frac, f32(0.0)), f32(1.0))
        decay = powf(f32(1.0) - frac, self._power)
        return f32(self._final) + f32(self._initial - self._final) * decay


build_pruning_schedule, register_pruning_schedule = setup_registry(
    "pruning_schedule", base_class=PruningSchedule,
    create_fn=lambda cls, args: cls(args))

register_pruning_schedule(ConstantSparsity)
register_pruning_schedule(PolynomialDecay)
