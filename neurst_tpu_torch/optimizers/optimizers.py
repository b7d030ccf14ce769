"""Optimizers (counterpart of ``neurst_tpu/optimizers/optimizers.py``).

The JAX package builds optax chains; here the same chain is a small set
of gradient transformations with optax's interface and arithmetic:
``init(params) -> state`` and ``update(updates, state, params) ->
(updates, state)`` over dicts of tensors (name -> tensor, in
``named_parameters`` order), with the step count kept in the state and
per-parameter state (moments, accumulators) kept in dicts under the
parameters' names, so a state saves and restores by name
(``utils/checkpoints.opt_state_to_flat``).
``torch.optim`` is not used: it takes neither the step count nor the
master-weight policy the way optax does.  Updates are new tensors; the
optimizer state (moments, counts) is updated in place, and
``apply_updates`` adds the updates to the parameters in place.

Flag names keep the Keras spelling (beta_1 / beta_2 / epsilon), as the
JAX package does, so its recipes parse unchanged.
"""

from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from neurst_tpu_torch.utils.flags_core import Flag
from neurst_tpu_torch.utils.registry import setup_registry

__all__ = ["GradientTransformation", "Optimizer", "build_optimizer",
           "register_optimizer", "create_optax_chain", "chain", "clip",
           "clip_by_global_norm", "scale_by_adam", "scale_by_rss",
           "scale_by_adadelta", "trace", "add_decayed_weights",
           "scale_by_learning_rate", "freeze", "apply_updates",
           "global_norm"]

Tree = Dict[str, torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[..., Any]


def _rebuild(tree: Tree, values) -> Tree:
    return dict(zip(tree, values))


def _zeros(params: Tree, fill: float = 0.0) -> Tree:
    return {n: torch.full_like(p, fill) for n, p in params.items()}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    norms = torch._foreach_norm(list(tree.values()), 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """params += updates, in place, each in its parameter's dtype."""
    with torch.no_grad():
        for name, p in params.items():
            p.add_(updates[name])
    return params


def chain(*transforms: GradientTransformation) -> GradientTransformation:

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def _stateless(fn) -> GradientTransformation:
    return GradientTransformation(
        lambda params: (), lambda updates, state, params=None: (
            fn(updates, params), state))


def clip(max_delta: float) -> GradientTransformation:
    """Clamps every update to [-max_delta, max_delta]."""
    def fn(updates, params):
        values = torch._foreach_clamp_min(list(updates.values()), -max_delta)
        return _rebuild(updates, torch._foreach_clamp_max(values, max_delta))
    return _stateless(fn)


def clip_by_global_norm(max_norm: float, norm_fn=None
                        ) -> GradientTransformation:
    """Scales the updates by max_norm / ||updates|| when the global norm
    reaches max_norm (without a host sync).  ``norm_fn`` replaces
    ``global_norm`` (the norm over every rank's shards under tensor
    parallelism)."""
    norm_fn = norm_fn or global_norm

    def fn(updates, params):
        g_norm = norm_fn(updates)
        factor = torch.where(g_norm < max_norm, torch.ones_like(g_norm),
                             max_norm / g_norm)
        return _rebuild(updates, torch._foreach_mul(list(updates.values()),
                                                    factor))
    return _stateless(fn)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """updates + weight_decay * params (decoupled weight decay)."""
    def fn(updates, params):
        return _rebuild(updates, torch._foreach_add(
            list(updates.values()), [params[n] for n in updates],
            alpha=weight_decay))
    return _stateless(fn)


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in float32, as optax computes it: with
    beta_2 = 0.999 the float32 rounding of the decay alone moves the
    first step's correction by 1e-5 relative."""
    return float(np.float32(1.0) - np.float32(decay) ** int(count))


def scale_by_adam(b1: float, b2: float, eps: float,
                  amsgrad: bool = False) -> GradientTransformation:
    """optax's ``scale_by_adam`` (``scale_by_amsgrad`` with ``amsgrad``):
    mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, and
    mu_hat / (sqrt(nu_hat) + eps) with the bias corrections of the count
    after this step (nu_hat the running maximum under AMSGrad)."""

    def init(params):
        state = {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}
        if amsgrad:
            state["nu_max"] = _zeros(params)
        return state

    def update(updates, state, params=None):
        names = list(state["mu"])
        g = [updates[n] for n in names]
        mu, nu = list(state["mu"].values()), list(state["nu"].values())
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        state["count"] += 1
        count = state["count"]
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, count))
        nu_hat = torch._foreach_div(nu, _bias_correction(b2, count))
        if amsgrad:
            nu_max = list(state["nu_max"].values())
            torch._foreach_maximum_(nu_max, nu_hat)
            nu_hat = nu_max
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, eps)
        return dict(zip(names, torch._foreach_div(mu_hat, denom))), state

    return GradientTransformation(init, update)


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> GradientTransformation:
    """optax's ``scale_by_rss`` (Adagrad): s = s + g^2 (from
    ``initial_accumulator_value``), updates g / sqrt(s + eps) where
    s > 0, else 0."""

    def update(updates, state, params=None):
        out = {}
        for n, s in state["sum_of_squares"].items():
            g = updates[n]
            s.addcmul_(g, g)
            out[n] = torch.where(s > 0, torch.rsqrt(s + eps),
                                 torch.zeros_like(s)) * g
        return out, state

    return GradientTransformation(
        lambda params: {"sum_of_squares": _zeros(
            params, initial_accumulator_value)}, update)


def scale_by_adadelta(rho: float = 0.9,
                      eps: float = 1e-6) -> GradientTransformation:
    """optax's ``scale_by_adadelta``: e_g = rho e_g + (1 - rho) g^2,
    u = sqrt(e_x + eps) / sqrt(e_g + eps) g, e_x = rho e_x + (1 - rho)
    u^2."""

    def update(updates, state, params=None):
        out = []
        for n, g in updates.items():
            e_g, e_x = state["e_g"][n], state["e_x"][n]
            e_g.mul_(rho).addcmul_(g, g, value=1.0 - rho)
            u = torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps) * g
            e_x.mul_(rho).addcmul_(u, u, value=1.0 - rho)
            out.append(u)
        return _rebuild(updates, out), state

    return GradientTransformation(
        lambda params: {"e_g": _zeros(params), "e_x": _zeros(params)},
        update)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    """optax's ``trace`` (SGD momentum): t = g + decay t, updates t (or
    g + decay t with ``nesterov``)."""

    def update(updates, state, params=None):
        names = list(state["trace"])
        g = [updates[n] for n in names]
        t = list(state["trace"].values())
        torch._foreach_mul_(t, decay)
        torch._foreach_add_(t, g)
        out = torch._foreach_add(g, t, alpha=decay) if nesterov \
            else [x.clone() for x in t]
        return dict(zip(names, out)), state

    return GradientTransformation(
        lambda params: {"trace": _zeros(params)}, update)


def freeze(tx: GradientTransformation, frozen) -> GradientTransformation:
    """optax's ``multi_transform({"train": tx, "frozen": set_to_zero()})``:
    ``tx`` sees only the parameters ``frozen(name)`` leaves out (its
    clipping norm too); the frozen ones get zero updates."""

    def train_part(tree):
        return {n: v for n, v in tree.items() if not frozen(n)}

    def update(updates, state, params=None):
        inner = train_part(updates)
        if inner:  # with everything frozen, the inner state stays put
            inner, state["inner"] = tx.update(
                inner, state["inner"],
                None if params is None else train_part(params))
        return {n: inner[n] if n in inner else torch.zeros_like(g)
                for n, g in updates.items()}, state

    return GradientTransformation(
        lambda params: {"inner": tx.init(train_part(params))}, update)


def scale_by_learning_rate(learning_rate: Union[float, Callable]
                           ) -> GradientTransformation:
    """updates * -lr, with a schedule evaluated at this transformation's
    step count before it is incremented (optax's ``scale_by_schedule``)."""

    def update(updates, state, params=None):
        lr = learning_rate(state["count"]) if callable(learning_rate) \
            else learning_rate
        state["count"] += 1
        return _rebuild(updates, torch._foreach_mul(list(updates.values()),
                                                    -lr)), state

    return GradientTransformation(lambda params: {"count": 0}, update)


class Optimizer(object):
    """A named factory: args -> GradientTransformation(lr)."""

    def __init__(self, args=None):
        self._args = dict(args or {})

    @staticmethod
    def class_or_method_args():
        return []

    def make(self, learning_rate) -> GradientTransformation:
        raise NotImplementedError


build_optimizer, register_optimizer = setup_registry(
    "optimizer", base_class=Optimizer,
    create_fn=lambda cls, args: cls(args))


@register_optimizer("adam")
class Adam(Optimizer):
    """optax's ``adam``; ``weight_decay`` makes it ``adamw`` and
    ``amsgrad`` ``amsgrad``."""

    @staticmethod
    def class_or_method_args():
        return [
            Flag("learning_rate", dtype=Flag.TYPE.FLOAT, default=None,
                 help="A fixed learning rate (overridden by lr_schedule)."),
            Flag("beta_1", dtype=Flag.TYPE.FLOAT, default=0.9,
                 help="The exponential decay rate for the 1st moment."),
            Flag("beta_2", dtype=Flag.TYPE.FLOAT, default=0.999,
                 help="The exponential decay rate for the 2nd moment."),
            Flag("epsilon", dtype=Flag.TYPE.FLOAT, default=1e-7,
                 help="A small constant for numerical stability."),
            Flag("amsgrad", dtype=Flag.TYPE.BOOLEAN, default=False,
                 help="Whether to apply the AMSGrad variant."),
            Flag("weight_decay", dtype=Flag.TYPE.FLOAT, default=None,
                 help="Decoupled (AdamW) weight decay rate."),
        ]

    def make(self, learning_rate):
        a = self._args
        adam = scale_by_adam(a.get("beta_1", 0.9), a.get("beta_2", 0.999),
                             a.get("epsilon", 1e-7),
                             amsgrad=bool(a.get("amsgrad"))
                             and not a.get("weight_decay"))
        parts = [adam]
        if a.get("weight_decay"):
            parts.append(add_decayed_weights(a["weight_decay"]))
        parts.append(scale_by_learning_rate(learning_rate))
        return chain(*parts)


@register_optimizer("adagrad")
class Adagrad(Optimizer):
    """optax's ``adagrad``."""

    @staticmethod
    def class_or_method_args():
        return [
            Flag("initial_accumulator_value", dtype=Flag.TYPE.FLOAT,
                 default=0.1, help="Starting accumulator value."),
            Flag("epsilon", dtype=Flag.TYPE.FLOAT, default=1e-7,
                 help="A small constant for numerical stability."),
        ]

    def make(self, learning_rate):
        a = self._args
        return chain(scale_by_rss(a.get("initial_accumulator_value", 0.1),
                                  a.get("epsilon", 1e-7)),
                     scale_by_learning_rate(learning_rate))


@register_optimizer("adadelta")
class Adadelta(Optimizer):
    """optax's ``adadelta`` (no weight decay)."""

    @staticmethod
    def class_or_method_args():
        return [
            Flag("rho", dtype=Flag.TYPE.FLOAT, default=0.95,
                 help="The decay rate."),
            Flag("epsilon", dtype=Flag.TYPE.FLOAT, default=1e-7,
                 help="A small constant for numerical stability."),
        ]

    def make(self, learning_rate):
        a = self._args
        return chain(scale_by_adadelta(a.get("rho", 0.95),
                                       a.get("epsilon", 1e-7)),
                     scale_by_learning_rate(learning_rate))


@register_optimizer("sgd")
class SGD(Optimizer):
    """optax's ``sgd``: momentum (a trace) when ``momentum`` is set."""

    @staticmethod
    def class_or_method_args():
        return [
            Flag("momentum", dtype=Flag.TYPE.FLOAT, default=0.,
                 help="The momentum factor."),
            Flag("nesterov", dtype=Flag.TYPE.BOOLEAN, default=False,
                 help="Whether to use Nesterov momentum."),
        ]

    def make(self, learning_rate):
        a = self._args
        if a.get("momentum"):
            return chain(trace(a["momentum"], bool(a.get("nesterov"))),
                         scale_by_learning_rate(learning_rate))
        return scale_by_learning_rate(learning_rate)


def create_optax_chain(optimizer: Optimizer,
                       lr: Union[float, Callable],
                       clip_value: Optional[float] = None,
                       clip_norm: Optional[float] = None,
                       norm_fn: Optional[Callable] = None
                       ) -> GradientTransformation:
    """clip by value -> clip by global norm -> optimizer(lr), as the JAX
    package's chain of the same name; ``norm_fn`` is the clip's norm
    (``global_norm`` by default)."""
    parts = []
    if clip_value:
        parts.append(clip(clip_value))
    if clip_norm:
        parts.append(clip_by_global_norm(clip_norm, norm_fn))
    parts.append(optimizer.make(lr))
    return chain(*parts) if len(parts) > 1 else parts[0]
