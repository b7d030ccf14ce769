from neurst_tpu_torch.metrics.metric import (Metric,  # noqa: F401
                                             build_metric, register_metric)
from neurst_tpu_torch.metrics import bleu  # noqa: F401
from neurst_tpu_torch.metrics import compound_split_bleu  # noqa: F401
from neurst_tpu_torch.metrics import wer  # noqa: F401
