"""NeurST on PyTorch and CUDA for NVIDIA Hopper: the port of
``neurst_tpu`` (the JAX/TPU package, kept beside it as the reference).

Module paths mirror ``neurst_tpu``'s.  The package imports torch and
nothing of JAX or ``neurst_tpu``.  Importing it registers the ported
models, search layers, criterions, optimizers, learning-rate schedules,
tasks, datasets, data pipelines, tokenizers, metrics and entries;
kernels are built on first use.
"""

from neurst_tpu_torch import data, exps, metrics, tasks  # noqa: F401
from neurst_tpu_torch.criterions import build_criterion  # noqa: F401
from neurst_tpu_torch.data import data_pipelines, datasets, text  # noqa: F401
from neurst_tpu_torch.layers.search import beam_search  # noqa: F401
from neurst_tpu_torch.layers.search.sequence_search import \
    build_search_layer  # noqa: F401
from neurst_tpu_torch.models import speech_transformer  # noqa: F401
from neurst_tpu_torch.models import transformer  # noqa: F401
from neurst_tpu_torch.models.model import build_model  # noqa: F401
from neurst_tpu_torch.optimizers.optimizers import \
    build_optimizer  # noqa: F401
from neurst_tpu_torch.optimizers.schedules.lr_schedules import \
    build_lr_schedule  # noqa: F401
