"""Label-smoothed cross entropy (counterpart of
``neurst_tpu/criterions/label_smoothed_cross_entropy.py``): soft targets
with confidence 1 - eps on the label and eps / (V - 1) elsewhere, the
normalizing constant subtracted, (nll_sum, n_samples, n_tokens)
statistics, token weights from ``trg_padding`` or ``trg_length`` and an
optional ``sample_mask``.  Computed in float32.

The model output is the logits tensor, a dict with "logits", or, on the
fused training path, a dict with "prelogits" / "softmax_w"
(/ "softmax_bias"): then the projection and the cross entropy run in one
kernel pair (``ops/fused_ce.fused_linear_xent``) and the [B, T, V]
logits are never formed.
"""

import math

import torch

from neurst_tpu_torch.criterions.criterion import (Criterion,
                                                   register_criterion)
from neurst_tpu_torch.layers.layer_utils import input_length_to_padding
from neurst_tpu_torch.metrics.metric import MetricWrapper
from neurst_tpu_torch.ops.fused_ce import fused_linear_xent
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["LabelSmoothedCrossEntropy"]


@register_criterion("label_smoothed_cross_entropy")
class LabelSmoothedCrossEntropy(Criterion):

    # the train step asks for prelogits only from criterions that say so
    supports_prelogits = True

    def __init__(self, args=None):
        super().__init__(args)
        self._label_smoothing = float(
            self._args.get("label_smoothing") or 0.0)

    @staticmethod
    def class_or_method_args():
        return [Flag("label_smoothing", dtype=Flag.TYPE.FLOAT, default=0.,
                     help="The label smoothing constant.")]

    def __call__(self, model_inp: dict, model_out):
        """Returns (nll_sum [B], n_samples [1], n_tokens [B])."""
        prelogits = model_out.get("prelogits") \
            if isinstance(model_out, dict) else None
        if prelogits is not None:
            vocab_size = model_out["softmax_w"].shape[0]
            device = prelogits.device
        else:
            logits = model_out["logits"] if isinstance(model_out, dict) \
                else model_out
            vocab_size = logits.shape[-1]
            device = logits.device

        def tensor(name):
            return torch.as_tensor(model_inp[name], device=device)

        labels = tensor("trg").long()
        confidence = 1.0 - self._label_smoothing
        low_confidence = self._label_smoothing / (vocab_size - 1)
        if prelogits is not None:
            xent = fused_linear_xent(
                prelogits, model_out["softmax_w"], labels, confidence,
                low_confidence, bias=model_out.get("softmax_bias"))
        else:
            # with logp_v = z_v - lse:
            #   -sum_v soft_v logp_v
            #     = -(conf - low)(z_label - lse) - low (sum z - V lse)
            z32 = logits.float()
            lse = torch.logsumexp(z32, dim=-1)
            label_z = z32.gather(-1, labels[..., None])[..., 0]
            xent = (-(confidence - low_confidence) * (label_z - lse)
                    - low_confidence * (z32.sum(dim=-1) - vocab_size * lse))
        if self._label_smoothing:
            normalizing = -(confidence * math.log(confidence)
                            + (vocab_size - 1) * low_confidence
                            * math.log(low_confidence + 1e-20))
            xent = xent - normalizing

        if model_inp.get("trg_padding") is not None:
            weights = 1.0 - tensor("trg_padding").float()
        else:
            length = model_inp.get("trg_length", model_inp.get("length"))
            weights = 1.0 - input_length_to_padding(
                torch.as_tensor(length, device=device), labels.shape[1])
        sample_mask = model_inp.get("sample_mask")
        if sample_mask is not None:
            sample_mask = tensor("sample_mask").float()
            weights = weights * sample_mask[:, None]
            n_samples = sample_mask.sum()[None]
        else:
            n_samples = torch.tensor([labels.shape[0]], dtype=torch.float32,
                                     device=device)
        return (xent * weights).sum(dim=1), n_samples, weights.sum(dim=1)

    def reduce_loss(self, model_inp, model_out):
        nll_sum, _, n_tokens = self(model_inp, model_out)
        return nll_sum.sum() / n_tokens.sum().clamp_min(1.0)

    def reduce_loss_terms(self, model_inp, model_out):
        """(sum of token nlls, token count): accumulation over ragged
        micro-batches then matches one big batch exactly."""
        nll_sum, _, n_tokens = self(model_inp, model_out)
        return nll_sum.sum(), n_tokens.sum()

    def reduce_metrics(self, eval_res_list) -> dict:
        nll, samples, tokens = 0.0, 0.0, 0.0
        for _nll, _s, _t in eval_res_list:
            nll += float(torch.as_tensor(_nll).sum())
            samples += float(torch.as_tensor(_s).sum())
            tokens += float(torch.as_tensor(_t).sum())
        return {"NLL": nll / max(samples, 1.0),
                "PPL": 2.0 ** (nll / max(tokens, 1.0))}

    def reduce_sample_metrics(self, eval_res) -> list:
        nll_sum, _, n_tokens = (torch.as_tensor(x).double().cpu().tolist()
                                for x in eval_res)
        return [{"nll": n, "ppl": 2.0 ** (n / max(t, 1.)),
                 "nll_per_token": n / max(t, 1.)}
                for n, t in zip(nll_sum, n_tokens)]

    def as_metric(self):
        return MetricWrapper(flag="NLL", greater_is_better=False)
