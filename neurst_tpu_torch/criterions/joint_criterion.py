"""Weighted sum of sub-criterions (the port's copy of
``neurst_tpu/criterions/joint_criterion.py``).

``criterions`` is a YAML list of ``{class, params, weight, output_key,
input_prefix}``.  Sub-criterion i reads the model output under
``model_out[output_key]`` (the whole output without a key or where the
output is not a dict) and contributes ``weight * loss``; ``input_prefix``
remaps its inputs, so that prefix ``asr`` reads ``asr_trg``,
``asr_trg_padding``, ... as ``trg``, ``trg_padding``, ...  The
statistics are one tuple a sub-criterion; ``reduce_metrics`` names each
metric ``<output_key>_<name>`` (``<i>_<name>`` without a key) where there
are several.
"""

import yaml

from neurst_tpu_torch.criterions.criterion import (Criterion,
                                                   build_criterion,
                                                   register_criterion)
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["JointCriterion"]


@register_criterion("joint_criterion")
class JointCriterion(Criterion):

    def __init__(self, args=None):
        super().__init__(args)
        spec = self._args.get("criterions")
        if isinstance(spec, str):
            spec = yaml.safe_load(spec)
        if not spec:
            raise ValueError("joint_criterion requires `criterions`: a "
                             "list of {class, params, weight, output_key}")
        self._subs = []
        for item in spec:
            crit = build_criterion({
                "criterion.class": item.get("class"),
                "criterion.params": item.get("params") or {}})
            self._subs.append((crit, float(item.get("weight", 1.0)),
                               item.get("output_key"),
                               item.get("input_prefix")))

    @staticmethod
    def class_or_method_args():
        return [Flag("criterions", dtype=Flag.TYPE.STRING, default=None,
                     help="A YAML list of sub-criterion specs "
                          "({class, params, weight, output_key, "
                          "input_prefix}).  input_prefix remaps model "
                          "inputs for the sub-criterion: prefix `asr` "
                          "makes it read asr_trg/asr_trg_padding/... "
                          "as trg/trg_padding/... (multi-task heads "
                          "with per-head targets).")]

    @staticmethod
    def _out_for(model_out, key):
        if key and isinstance(model_out, dict):
            return model_out[key]
        return model_out

    @staticmethod
    def _inp_for(model_inp, prefix):
        if not prefix:
            return model_inp
        out = dict(model_inp)
        tag = prefix + "_"
        for k, v in model_inp.items():
            if k.startswith(tag):
                out[k[len(tag):]] = v
        return out

    def reduce_loss(self, model_inp, model_out):
        total = 0.0
        for crit, weight, key, prefix in self._subs:
            total = total + weight * crit.reduce_loss(
                self._inp_for(model_inp, prefix),
                self._out_for(model_out, key))
        return total

    def __call__(self, model_inp, model_out):
        return tuple(crit(self._inp_for(model_inp, prefix),
                          self._out_for(model_out, key))
                     for crit, _, key, prefix in self._subs)

    def reduce_metrics(self, eval_res_list) -> dict:
        out = {}
        for i, (crit, _, key, _) in enumerate(self._subs):
            sub = crit.reduce_metrics([res[i] for res in eval_res_list])
            for k, v in sub.items():
                out[f"{key or i}_{k}" if len(self._subs) > 1 else k] = v
        return out

    def as_metric(self):
        return self._subs[0][0].as_metric()
