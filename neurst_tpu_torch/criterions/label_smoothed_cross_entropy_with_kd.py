"""Label-smoothed cross entropy with a distillation term (the port's copy
of ``neurst_tpu/criterions/label_smoothed_cross_entropy_with_kd.py``).

loss = (1 - kd_weight) * CE + kd_weight * KD, where KD is

* with teacher logits (``model_out["teacher_logits"]`` or
  ``model_inp["teacher_logits"]``): T^2 * KL(softmax(teacher / T) ||
  softmax(student / T)), token-weighted as the CE;
* else, with CTNMT's ``kd_teacher_states`` in the model output: the
  squared L2 norm over the hidden dim of (student - teacher) states per
  source position (a sum, not a mean), averaged over non-padded source
  positions;
* else nothing: the plain CE.

Both branches, and ``reduce_loss`` / ``reduce_loss_terms``, compute what
the JAX criterion computes, its approximation included (below).
"""

import torch

from neurst_tpu_torch.criterions.criterion import register_criterion
from neurst_tpu_torch.criterions.label_smoothed_cross_entropy import \
    LabelSmoothedCrossEntropy
from neurst_tpu_torch.layers.layer_utils import input_length_to_padding
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["LabelSmoothedCrossEntropyWithKd"]


@register_criterion("label_smoothed_cross_entropy_with_kd")
class LabelSmoothedCrossEntropyWithKd(LabelSmoothedCrossEntropy):

    # the distillation terms read the logits: no fused prelogits path
    supports_prelogits = False

    def __init__(self, args=None):
        super().__init__(args)
        v = self._args.get("kd_weight")
        self._kd_weight = 0.1 if v is None else float(v)
        assert 0.0 <= self._kd_weight < 1.0, (
            f"kd_weight must be in [0, 1), got {self._kd_weight}")
        v = self._args.get("kd_temperature")
        self._kd_temperature = 1.0 if v is None else float(v)

    @staticmethod
    def class_or_method_args():
        return LabelSmoothedCrossEntropy.class_or_method_args() + [
            Flag("kd_weight", dtype=Flag.TYPE.FLOAT, default=0.1,
                 help="The weight of the distillation term."),
            Flag("kd_temperature", dtype=Flag.TYPE.FLOAT, default=1.0,
                 help="The distillation softmax temperature."),
        ]

    def reduce_loss_terms(self, model_inp, model_out):
        """Token-weighted terms.  Exact for the logit-KD branch (the KD
        KL shares the CE's target-token normalizer); for the CTNMT
        state branch the KD normalizer is source positions, so token
        weighting is a close approximation rather than exact, as in the
        JAX criterion."""
        ce_sum, n = super().reduce_loss_terms(model_inp, model_out)
        kd = self._kd_term(model_inp, model_out)
        if kd is None:
            return ce_sum, n
        # loss_sum / denom must equal reduce_loss: fold the (already
        # mean-normalized) KD term in at weight w per token
        return ((1.0 - self._kd_weight) * ce_sum
                + self._kd_weight * kd * n), n

    def reduce_loss(self, model_inp, model_out):
        ce = super().reduce_loss(model_inp, model_out)
        kd = self._kd_term(model_inp, model_out)
        if kd is None:
            return ce
        return (1.0 - self._kd_weight) * ce + self._kd_weight * kd

    def _kd_term(self, model_inp, model_out):
        """The mean-normalized distillation term (temperature factor
        included), or None without a teacher signal."""
        logits = model_out["logits"] if isinstance(model_out, dict) \
            else model_out
        teacher_logits = None
        if isinstance(model_out, dict):
            teacher_logits = model_out.get("teacher_logits")
        if teacher_logits is None:
            teacher_logits = model_inp.get("teacher_logits")
        if teacher_logits is None:
            if isinstance(model_out, dict) \
                    and "kd_teacher_states" in model_out:
                s = model_out["kd_student_states"].float()
                t = torch.as_tensor(model_out["kd_teacher_states"],
                                    device=s.device).float()
                pad = model_out.get("kd_padding")
                w = (1.0 - torch.as_tensor(pad, device=s.device).float()) \
                    if pad is not None else torch.ones(s.shape[:2],
                                                       device=s.device)
                # squared L2 norm over the hidden dim per position (the
                # original CTNMT's square(norm(s - t)): a sum)
                sq = ((s - t) ** 2).sum(dim=-1)
                return (sq * w).sum() / w.sum().clamp_min(1.0)
            return None
        t = self._kd_temperature
        device = logits.device
        student_lp = torch.log_softmax(logits.float() / t, dim=-1)
        teacher_p = torch.softmax(
            torch.as_tensor(teacher_logits, device=device).float() / t,
            dim=-1)
        kl = (teacher_p * (torch.log(teacher_p.clamp_min(1e-20))
                           - student_lp)).sum(dim=-1)
        labels = torch.as_tensor(model_inp["trg"], device=device)
        padding = model_inp.get("trg_padding")
        if padding is not None:
            weights = 1.0 - torch.as_tensor(padding, device=device).float()
        else:
            weights = 1.0 - input_length_to_padding(
                torch.as_tensor(model_inp["trg_length"], device=device),
                labels.shape[1])
        kd_loss = (kl * weights).sum() / weights.sum().clamp_min(1.0)
        return (t ** 2) * kd_loss
