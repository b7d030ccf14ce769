"""WER / CER (the port's copy of ``neurst_tpu/metrics/wer.py``): edit
distance over words, over characters for zh/ja.  Lower is better."""

from neurst_tpu_torch.data.data_pipelines.data_pipeline import \
    lowercase_and_remove_punctuations
from neurst_tpu_torch.metrics.metric import Metric, register_metric
from neurst_tpu_torch.utils.flags_core import Flag

__all__ = ["WER", "edit_distance"]


def edit_distance(hyp, ref) -> int:
    """Levenshtein distance between two token sequences."""
    m, n = len(hyp), len(ref)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        curr = [i] + [0] * n
        for j in range(1, n + 1):
            sub = prev[j - 1] + (hyp[i - 1] != ref[j - 1])
            curr[j] = min(prev[j] + 1, curr[j - 1] + 1, sub)
        prev = curr
    return prev[n]


@register_metric("wer")
class WER(Metric):

    def __init__(self, args=None, language="en"):
        super().__init__(args)
        self._language = self._args.get("language") or language
        self._flag = "CER" if self._language in ("zh", "ja") else "WER"

    @staticmethod
    def class_or_method_args():
        return [Flag("language", dtype=Flag.TYPE.STRING, default="en",
                     help="The language (CER for zh/ja).")]

    def greater_or_eq(self, result1, result2):
        return self.get_value(result1) <= self.get_value(result2)

    def _tokens(self, text):
        if self._language in ("zh", "ja"):
            return [c for c in text if c.strip()]
        return text.split()

    def call(self, hypothesis, groundtruth) -> dict:
        # lowercased, punctuation-stripped text on both sides
        total_err, total_ref = 0, 0
        for hyp, ref in zip(hypothesis, groundtruth):
            hyp = lowercase_and_remove_punctuations(self._language, hyp)
            ref = lowercase_and_remove_punctuations(self._language, ref)
            h = self._tokens(hyp)
            r = self._tokens(ref)
            total_err += edit_distance(h, r)
            total_ref += len(r)
        wer = 100.0 * total_err / max(total_ref, 1)
        return {self._flag: wer}
