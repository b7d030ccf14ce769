"""Quantization-aware training and int8 serving (counterpart of
``neurst_tpu/layers/quantization/quant_layers.py``).

QAT: min/max fake quantization driven by a process-global config
(``--enable_quant --quant_params``, ``global_init``).  Every quantized
dense gets a learned scalar ``kernel_clip_max`` (init
``quant_weight_clip_max``; the symmetric minimum is ``-max * B / (B - 1)``
with ``B = 2^(bits-1)``) and ``output_clip_max`` (init
``quant_act_clip_max``; relu outputs clip at [0, max], softmax outputs use
the fixed range [0, (2^b - 1) / 2^b]).  Rounding is straight-through; the
clip bounds pass gradient to the clip variables with JAX's tie rule
(``jnp.clip`` is ``minimum(maximum(x, lo), hi)``, and a tie at either
bound splits the gradient 0.5 / 0.5, where ``torch.clamp`` gives it all
to ``x``): ``_FakeQuant`` below.  ``clip_l2_penalty``
is the L2 term on the clips the trainer adds to the loss.

int8 serving (inference only): ``set_int8_serving`` makes every
``dense_general`` site an ``Int8Dense`` (an int8 kernel ``kernel_q``
[out, in] with a float32 per-output-channel ``kernel_scale``) and the
word embedding an int8 table (``weights_q``, per-row ``weights_scale``).
Three modes: weight-only (``(x @ q) * scale`` in the compute dtype, the
scale applied in float32), dynamic per-token int8 activations, and static
per-tensor ``act_scale`` (calibrated, or taken from a QAT checkpoint's
FFN clip).  The int8 x int8 -> int32 product is ``torch._int_mm`` on the
card (JAX computes it with ``lax.dot_general`` outside any Pallas kernel)
and an exact float64 product on the CPU.  ``int8ify_flat_params``
quantizes a float32 checkpoint (in the JAX package's flat names and
layouts) for an int8 model, bitwise as the JAX function does.

Port layouts: the dense kernels are ``nn.Linear``'s [out, in] (the
bridge transposes), so ``kernel_q`` is [out, in] and a fused attention
projection's ``kernel_scale`` [n, N, H] is flattened to [n * N * H].
"""

import contextlib
import functools
import logging

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from neurst_tpu_torch.parallel import collectives

__all__ = ["global_init", "get_global_config", "quant_enabled",
           "fake_quant_minmax",
           "QuantDense", "Int8Dense", "dense_general", "clip_l2_penalty",
           "set_int8_serving", "int8_serving_enabled",
           "int8_static_act_enabled", "set_int8_calibration",
           "calibrate_int8_act_scales", "write_calibrated_act_scales",
           "int8ify_flat_params", "qat_act_scale_names", "int8_matmul",
           "recording_act_absmax"]

_CONFIG = {
    "enable_quant": False,
    "quant_strategy": "min/max",
    "quant_bits": 8,
    "quant_weight_clip_max": 1.0,
    "quant_act_clip_max": 16.0,
}


def global_init(enable_quant, quant_strategy="min/max", quant_bits=8,
                quant_weight_clip_max=1.0, quant_act_clip_max=16.0,
                **kwargs):
    """Sets the process-global quantization config; must run before the
    model is built."""
    _CONFIG["enable_quant"] = bool(enable_quant)
    if enable_quant:
        if quant_strategy != "min/max":
            raise ValueError(
                "Only min/max quantization is supported currently.")
        _CONFIG["quant_strategy"] = quant_strategy
        _CONFIG["quant_bits"] = int(quant_bits)
        _CONFIG["quant_weight_clip_max"] = float(quant_weight_clip_max)
        _CONFIG["quant_act_clip_max"] = float(quant_act_clip_max)
        logging.info("Enable min/max quantization: bits=%d "
                     "weight_clip_max=%s act_clip_max=%s", quant_bits,
                     quant_weight_clip_max, quant_act_clip_max)
    if kwargs:
        logging.info("Unknown args of quantization: %s", kwargs)


def get_global_config():
    return dict(_CONFIG)


def quant_enabled() -> bool:
    return bool(_CONFIG["enable_quant"])


@functools.lru_cache(maxsize=None)
def _const(value: float, device: str):
    """A float32 0-d constant on ``device``, made once: a Python number
    sent to the card at every call would copy it there (and wait)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _as_tensor(v, like):
    if isinstance(v, torch.Tensor):
        return v
    return _const(float(v), str(like.device))


def _div(a, divisor: float):
    """``a / divisor`` rounded as IEEE division on every device (a CUDA
    tensor divided by a Python number is multiplied by its reciprocal,
    which can differ by a rounding)."""
    return a / _const(float(divisor), str(a.device))


def _tie_share(a, b, greater: bool):
    """d max(a, b) / da (``greater``) or d min(a, b) / da as ``lax.max`` /
    ``lax.min`` give it: 1 where a wins, 0.5 at a tie, 0 where b wins,
    as ``(sign(a - b) + 1) / 2`` (a difference of two finite floats is 0
    exactly at a tie)."""
    return torch.sign(a - b if greater else b - a).add_(1.0).mul_(0.5)


class _FakeQuant(torch.autograd.Function):
    """``fake_quant_minmax`` as one autograd node: the clip
    ``jnp.clip(x, lo, hi)`` = ``minimum(maximum(x, lo), hi)`` in float32
    with the balanced gradient at both bounds, the rounding straight
    through (``clipped + (q - clipped)``, as the JAX function computes
    it), the result and dx in x's dtype.  One node in place of a clip,
    an add and two casts: a QAT step runs two of these a dense, and on
    the card their launches and nodes set the step's time."""

    @staticmethod
    def forward(ctx, x, lo, hi, bits):
        x32 = x.float()
        m = torch.maximum(x32, lo)
        clipped = torch.minimum(m, hi)
        ctx.save_for_backward(x32, lo, hi, m)
        ctx.dtype = x.dtype
        scale = torch.clamp_min(_div(hi - lo, 2 ** bits - 1), 1e-9)
        q = torch.round((clipped - lo) / scale) * scale + lo
        return (clipped + (q - clipped)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x32, lo, hi, m = ctx.saved_tensors
        g = g.float()
        g_m = g * _tie_share(m, hi, False)
        dx = g_m * _tie_share(x32, lo, True)
        d_lo = (g_m - dx).sum_to_size(lo.shape) \
            if ctx.needs_input_grad[1] else None
        d_hi = (g - g_m).sum_to_size(hi.shape) \
            if ctx.needs_input_grad[2] else None
        return dx.to(ctx.dtype), d_lo, d_hi, None


class _JaxMaxScalar(torch.autograd.Function):
    """``jnp.maximum(a, c)`` for a Python number c, with the balanced
    gradient."""

    @staticmethod
    def forward(ctx, a, c):
        ctx.save_for_backward(a)
        ctx.c = c
        return torch.clamp_min(a, c)

    @staticmethod
    def backward(ctx, g):
        a, = ctx.saved_tensors
        return g * _tie_share(a, ctx.c, True).to(g.dtype), None


def fake_quant_minmax(x, clip_min, clip_max, bits: int):
    """Uniform fake quantization over [clip_min, clip_max] in float32,
    straight through the rounding; the result in x's dtype."""
    return _FakeQuant.apply(x, _as_tensor(clip_min, x).float(),
                            _as_tensor(clip_max, x).float(), bits)


def _symmetric_min(cmax, bits: int):
    """-cmax * B / (B - 1), B = 2^(bits-1): the grid's minimum."""
    bits_tmp = float(2 ** (bits - 1))
    return _div(-cmax * bits_tmp, bits_tmp - 1.0)


def _weight_quant(w, clip):
    bits = _CONFIG["quant_bits"]
    cmax = _JaxMaxScalar.apply(clip, 0.0)
    return fake_quant_minmax(w, _symmetric_min(cmax, bits), cmax, bits)


def _act_quant(x, clip, activation):
    bits = _CONFIG["quant_bits"]
    if activation == "softmax":
        cmax = float(2 ** bits - 1) / float(2 ** bits)
        return fake_quant_minmax(x, 0.0, cmax, bits)
    cmax = _JaxMaxScalar.apply(clip, 0.0)
    cmin = 0.0 if activation == "relu" else _symmetric_min(cmax, bits)
    return fake_quant_minmax(x, cmin, cmax, bits)


class QuantDense(nn.Linear):
    """The QAT dense (JAX ``QuantDenseGeneral``): weight fake-quant, the
    product in the compute dtype, bias, its own ``activation``, output
    fake-quant.  ``weight`` / ``bias`` as ``nn.Linear``'s, plus the
    scalars ``kernel_clip_max`` and ``output_clip_max`` (none for a
    softmax output, whose range is fixed).

    Under tensor parallelism (``parallel.apply_mesh`` sets ``tp_group``
    and ``row_parallel``) the weight is this rank's shard and the clips
    are whole on every rank: a clip read by this rank's part of the
    kernel or of the output goes through ``collectives.copy_to``, so its
    gradient is summed over the model group.  A column-parallel site
    computes its own output columns; a row-parallel one reduces its
    partial product over the group and then adds the bias, activates and
    fake-quantizes the whole output, whose clip then needs no sum."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, activation=None):
        super().__init__(in_features, out_features, bias=bias)
        self.activation = activation
        self.kernel_clip_max = nn.Parameter(torch.empty(()))
        self.output_clip_max = None if activation == "softmax" \
            else nn.Parameter(torch.empty(()))
        self.tp_group, self.row_parallel = None, False

    def init_extra_params(self):
        """The clips' initial values from the global config."""
        with torch.no_grad():
            self.kernel_clip_max.fill_(_CONFIG["quant_weight_clip_max"])
            if self.output_clip_max is not None:
                self.output_clip_max.fill_(_CONFIG["quant_act_clip_max"])

    def quantized_kernel(self):
        """The weight fake-quantized on its learned symmetric grid."""
        return _weight_quant(self.weight, collectives.copy_to(
            self.kernel_clip_max, self.tp_group))

    def quantize_output(self, y):
        """The output fake quant of the activated product ``y``."""
        kind = self.activation if self.activation in ("relu", "softmax") \
            else "act"
        clip = self.output_clip_max
        if clip is not None and not self.row_parallel:
            clip = collectives.copy_to(clip, self.tp_group)
        return _act_quant(y, clip, kind)

    def dense(self, x, dtype):
        from neurst_tpu_torch.layers.common_layers import activation_by_name
        y = F.linear(x.to(dtype), self.quantized_kernel().to(dtype))
        if self.row_parallel:
            y = collectives.reduce_from(y, self.tp_group)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        if self.activation and self.activation != "linear":
            y = activation_by_name(self.activation)(y)
        return self.quantize_output(y)


_INT8_SERVING = {"on": False, "qat_bits": 8, "activations": False,
                 "static_act": False, "calibrate": False, "record": False}


def set_int8_serving(on: bool, qat_bits: int = 8, activations: bool = False,
                     static_activation_scales: bool = False):
    """Turns int8 serving on or off; must be set before the model is
    built.  A QAT config must be turned off first (``global_init(False)``):
    the checkpoint's learned clips then drive the int8 ranges
    (``int8ify_flat_params``) on the grid QAT trained with (``qat_bits``).
    ``activations``: int8 x int8 products with dynamic per-token
    activation scales; ``static_activation_scales``: a per-tensor
    ``act_scale`` parameter in each ``Int8Dense`` instead."""
    if on and quant_enabled():
        raise ValueError(
            "int8_serving builds Int8 modules; turn QAT module "
            "construction off first (global_init(False)) — the "
            "checkpoint's learned clips still drive the int8 ranges")
    _INT8_SERVING["on"] = bool(on)
    _INT8_SERVING["qat_bits"] = int(qat_bits)
    _INT8_SERVING["activations"] = bool(on) and bool(activations)
    _INT8_SERVING["static_act"] = (_INT8_SERVING["activations"]
                                   and bool(static_activation_scales))
    _INT8_SERVING["calibrate"] = False
    _INT8_SERVING["record"] = False


def int8_serving_enabled() -> bool:
    return bool(_INT8_SERVING["on"])


def int8_static_act_enabled() -> bool:
    return bool(_INT8_SERVING["static_act"])


def set_int8_calibration(on: bool):
    """Calibration mode for static activation scales: every ``Int8Dense``
    quantizes its input dynamically (as without ``act_scale``); inside
    ``recording_act_absmax`` it also records the running input absmax."""
    _INT8_SERVING["calibrate"] = bool(on)


def int8_matmul(x_q, kernel_q):
    """int8 x_q [..., K] times int8 kernel_q [N, K] transposed -> exact
    int32 [..., N].  On the card ``torch._int_mm``, which takes at least
    17 rows (fewer are padded with zero rows) and K, N multiples of 8
    (others raise); on the CPU a float64 product, exact at these widths
    (|sum| <= 127 * 127 * K)."""
    k, n = x_q.shape[-1], kernel_q.shape[0]
    a = x_q.reshape(-1, k)
    m = a.shape[0]
    if a.device.type == "cpu":
        acc = (a.double() @ kernel_q.double().t()).to(torch.int32)
    else:
        if k % 8 or n % 8:
            raise ValueError(f"int8 product on the card needs K and N "
                             f"multiples of 8 (torch._int_mm), got K {k}, "
                             f"N {n}")
        if m <= 16:
            a = F.pad(a, (0, 0, 0, 17 - m))
        acc = torch._int_mm(a.contiguous(), kernel_q.t())[:m]
    return acc.reshape(*x_q.shape[:-1], n)


class Int8Dense(nn.Module):
    """int8 serving dense (JAX ``Int8DenseGeneral``): ``kernel_q`` int8
    [out, in], ``kernel_scale`` float32 [out], ``bias``, and under static
    activation scales ``act_scale`` (a float32 scalar).  Its values come
    from ``int8ify_flat_params``; the init values are placeholders.
    ``act_scale_from_clip``: the ``act_scale`` came from a QAT clip
    (``utils/param_policy.restore_inference_params`` sets it), and
    calibration leaves it as it is.

    Under tensor parallelism (``parallel.apply_mesh`` sets ``tp_group``
    and ``row_parallel``) a column-parallel site holds its output
    channels' rows of ``kernel_q``, ``kernel_scale`` and ``bias`` and
    computes as one rank does.  A row-parallel site holds its input
    columns of ``kernel_q``: the per-token absmax of the dynamic mode
    (and the calibration's) is the max over the model group, the int32
    accumulator (or the weight-only partial product, in float32) is
    summed over the group, and the scales and the bias act on the sum,
    so an int8 x int8 site gives one rank's output bit for bit."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.kernel_q = nn.Parameter(
            torch.empty(out_features, in_features, dtype=torch.int8),
            requires_grad=False)
        self.kernel_scale = nn.Parameter(torch.empty(out_features),
                                         requires_grad=False)
        self.bias = nn.Parameter(torch.empty(out_features),
                                 requires_grad=False) if bias else None
        self.act_scale = nn.Parameter(torch.empty(()), requires_grad=False) \
            if _INT8_SERVING["static_act"] else None
        self.act_scale_from_clip = False
        self.act_absmax = None
        self.tp_group, self.row_parallel = None, False

    def init_own_params(self, generator=None):
        with torch.no_grad():
            self.kernel_q.zero_()
            self.kernel_scale.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()
            if self.act_scale is not None:
                self.act_scale.fill_(1.0)

    def _over_rows(self, t, op=dist.ReduceOp.SUM):
        """``t`` reduced over the model group at a row-parallel site (in
        place), else as it is."""
        if not self.row_parallel:
            return t
        return collectives.all_reduce(t, self.tp_group, op)

    def _token_absmax(self, x32):
        """The absmax of each token's whole input [..., 1]."""
        return self._over_rows(x32.abs().amax(dim=-1, keepdim=True),
                               dist.ReduceOp.MAX)

    def dense(self, x, dtype):
        scale = self.kernel_scale.float()
        if _INT8_SERVING["activations"]:
            x32 = x.float()
            static = self.act_scale is not None
            if static and _INT8_SERVING["calibrate"]:
                amax = self._token_absmax(x32)
                if _INT8_SERVING["record"]:
                    top = amax.max()
                    self.act_absmax = top if self.act_absmax is None \
                        else torch.maximum(self.act_absmax, top)
                static = False
            else:
                amax = None if static else self._token_absmax(x32)
            s = self.act_scale.float().clamp_min(1e-9) if static \
                else _div(amax.clamp_min(1e-9), 127.0)
            x_q = torch.clamp(torch.round(x32 / s), -127, 127).to(
                torch.int8)
            acc = self._over_rows(int8_matmul(x_q, self.kernel_q))
            y = (acc.float() * s * scale).to(dtype)
        else:
            y = F.linear(x.to(dtype), self.kernel_q.to(dtype)).float()
            y = (self._over_rows(y) * scale).to(dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y

    def forward(self, x, dtype=torch.float32):
        return self.dense(x, dtype)


def dense_general(in_features: int, out_features: int, bias: bool = True,
                  activation=None) -> nn.Module:
    """The dense of a quantizable site: ``Int8Dense`` under int8 serving,
    ``QuantDense`` (which applies ``activation`` itself) under QAT, else a
    plain ``nn.Linear`` (its caller applies any activation)."""
    if int8_serving_enabled():
        return Int8Dense(in_features, out_features, bias)
    if quant_enabled():
        return QuantDense(in_features, out_features, bias, activation)
    return nn.Linear(in_features, out_features, bias=bias)


@contextlib.contextmanager
def recording_act_absmax(model):
    """Inside: every static ``Int8Dense`` of ``model`` records its running
    input absmax (calibration mode must be on).  Yields the dict {module
    path: absmax} that is filled when the block exits."""
    found = {}
    for module in model.modules():
        if isinstance(module, Int8Dense):
            module.act_absmax = None
    _INT8_SERVING["record"] = True
    try:
        yield found
    finally:
        _INT8_SERVING["record"] = False
        for name, module in model.named_modules():
            if isinstance(module, Int8Dense) and \
                    module.act_absmax is not None:
                found[name] = float(module.act_absmax)
                module.act_absmax = None


def calibrate_int8_act_scales(model, batches, margin: float = 1.0):
    """Post-training calibration of the static activation scales: runs
    ``batches`` (model-input dicts) through ``model`` in calibration mode,
    takes each dense's input absmax over all of them and writes
    ``act_scale = margin * absmax / 127``.  Returns ``model``."""
    if not _INT8_SERVING["static_act"]:
        raise ValueError(
            "calibrate_int8_act_scales requires set_int8_serving("
            "activations=True, static_activation_scales=True)")
    set_int8_calibration(True)
    n = 0
    try:
        with torch.no_grad(), recording_act_absmax(model) as found:
            for batch in batches:
                model(batch)
                n += 1
        if not n:
            raise ValueError("calibration got zero batches")
        logging.info("int8 activation calibration: %d batches", n)
    finally:
        set_int8_calibration(False)
    return write_calibrated_act_scales(model, found, margin=margin)


def write_calibrated_act_scales(model, calibration, margin: float = 1.0):
    """``act_scale = margin * absmax / 127`` for each module path of
    ``calibration`` ({path: absmax}), except the modules whose scale came
    from a QAT clip (``act_scale_from_clip``).  Returns ``model``."""
    modules = dict(model.named_modules())
    with torch.no_grad():
        for path, amax in calibration.items():
            if modules[path].act_scale_from_clip:
                continue
            modules[path].act_scale.fill_(float(np.float32(
                max(float(amax) * float(margin), 1e-9) / 127.0)))
    return model


def int8ify_flat_params(flat: dict, template_flat: dict) -> dict:
    """A float32 checkpoint (flat, the JAX package's names and layouts)
    rewritten for an int8 model whose parameters ``template_flat`` lists
    in the same names and layouts (``param_bridge.state_dict_to_flat``):
    each ``<p>/kernel`` (``<p>/weights``) with a ``<p>/kernel_q``
    (``weights_q``) in the template becomes int8 with an absmax scale per
    output channel (per vocabulary row); a QAT ``<p>/kernel_clip_max``
    gives a per-tensor scale ``clip / (2^(b-1) - 1)`` with levels in
    [-2^(b-1), 2^(b-1) - 1] instead, the grid QAT trained on; under
    static activation scales, ``ffn/dense2/act_scale`` is taken from
    ``ffn/dense1/output_clip_max / 127``."""
    out = dict(flat)
    from_clip = qat_act_scale_names(flat, template_flat)
    for name, tmpl in template_flat.items():
        if not (name.endswith("/kernel_q") or name.endswith("/weights_q")):
            continue
        base = name[:-2]
        scale_name = base + "_scale"
        w = flat.get(base)
        if w is None:
            continue
        w = np.asarray(w, np.float32)
        s_shape = tuple(np.shape(template_flat[scale_name]))
        lead, trail, reduce_axes = _scale_axes(w.shape, s_shape, name)
        denom_shape = (w.shape[:lead] + (1,) * len(reduce_axes)
                       + w.shape[w.ndim - trail:])
        clip = flat.get(base + "_clip_max")
        if clip is not None and name.endswith("/kernel_q"):
            b = int(_INT8_SERVING["qat_bits"])
            if b > 8:
                raise ValueError(
                    f"QAT quant_bits={b} does not fit int8 serving")
            half = 2 ** (b - 1)
            clip = np.asarray(clip, np.float32)
            scale = np.broadcast_to(
                clip.reshape(clip.shape + (1,) * (len(s_shape) - clip.ndim)),
                s_shape) / (half - 1.0)
            scale = np.maximum(scale, 1e-9 / (half - 1.0))
            q = np.clip(np.round(w / scale.reshape(denom_shape)),
                        -half, half - 1).astype(np.int8)
            out.pop(base, None)
            out.pop(base + "_clip_max", None)
            out[name] = q
            out[scale_name] = scale.astype(np.float32)
            continue
        keep = np.max(np.abs(w), axis=reduce_axes)
        scale = np.maximum(keep, 1e-9) / 127.0
        q = np.clip(np.round(w / scale.reshape(denom_shape)),
                    -127, 127).astype(np.int8)
        out.pop(base, None)
        out[name] = q
        out[scale_name] = scale.astype(np.float32)

    for name in from_clip:
        clip_name = _dense1_clip_name(name)
        clip = np.maximum(np.asarray(flat[clip_name], np.float32), 1e-9)
        out[name] = np.broadcast_to(
            clip / 127.0, np.shape(template_flat[name])).astype(np.float32)
        out.pop(clip_name, None)
    return out


def _dense1_clip_name(act_scale_name):
    return (act_scale_name[:-len("dense2/act_scale")]
            + "dense1/output_clip_max")


def qat_act_scale_names(flat: dict, template_flat: dict) -> set:
    """The ``.../ffn/dense2/act_scale`` names of ``template_flat`` whose
    value ``int8ify_flat_params`` takes from the QAT checkpoint ``flat``'s
    ``ffn/dense1/output_clip_max`` (under static activation scales; else
    none)."""
    if not _INT8_SERVING["static_act"]:
        return set()
    return {name for name in template_flat
            if name.endswith("dense2/act_scale")
            and _dense1_clip_name(name) in flat}


def _scale_axes(w_shape, scale_shape, name):
    """(leading kept, trailing kept, reduced axes) of a quantized tensor
    so that the kept axes give ``scale_shape``: dense kernels [in...,
    out...] keep their trailing axes first, embedding tables [V, D] their
    leading one."""
    n, k = len(w_shape), len(scale_shape)
    leads = range(0, k + 1) if name.endswith("/kernel_q") \
        else range(k, -1, -1)
    for lead in leads:
        trail = k - lead
        if (tuple(w_shape[:lead]) == tuple(scale_shape[:lead])
                and tuple(w_shape[n - trail:])
                == tuple(scale_shape[lead:])
                and lead + trail <= n):
            return lead, trail, tuple(range(lead, n - trail))
    raise ValueError(
        f"cannot align scale shape {scale_shape} to tensor shape "
        f"{w_shape} for {name}")


def clip_l2_penalty(params) -> torch.Tensor:
    """The L2 term on the learned clips, 1e-3 on weight clips and 1e-2 on
    activation clips, of a {name: tensor} dict (the train step's
    parameters).  Each kind is one stacked sum (a term a clip would cost
    launches a clip); JAX adds the terms one by one."""
    total = None
    for suffix, coef in (("kernel_clip_max", 1e-3), ("output_clip_max",
                                                     1e-2)):
        clips = [v for name, v in params.items() if name.endswith(suffix)]
        if clips:
            term = coef * torch.stack(clips).float().square().sum()
            total = term if total is None else total + term
    if total is None:
        device = next(iter(params.values())).device if params else None
        return torch.zeros((), dtype=torch.float32, device=device)
    return total
