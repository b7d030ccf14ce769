"""NeurST on PyTorch and CUDA for NVIDIA Hopper: the port of
``neurst_tpu`` (the JAX/TPU package, kept beside it as the reference).

Module paths mirror ``neurst_tpu``'s.  The package imports torch and
nothing of JAX or ``neurst_tpu``.  Importing it registers the ported
models (the multi-task speech model, the wait-k Transformer, the
LightConv model, BERT, CTNMT, GPT-2 and wav2vec 2.0 among them), search
layers (beam search and sampling), criterions (``joint_criterion`` and
``label_smoothed_cross_entropy_with_kd`` among them), optimizers,
learning-rate schedules, tasks (``lm`` among them), datasets, data
pipelines, tokenizers, metrics, validators, checkpoint converters and
entries (``predict``, ``train``, ``eval``, ``sequence_evaluator`` and
``validation``); kernels are built on first use.
"""

from neurst_tpu_torch import data, exps, metrics, tasks, training  # noqa: F401
from neurst_tpu_torch.criterions import build_criterion  # noqa: F401
from neurst_tpu_torch.data import data_pipelines, datasets, text  # noqa: F401
from neurst_tpu_torch.layers.search import beam_search  # noqa: F401
from neurst_tpu_torch.layers.search import sampling  # noqa: F401
from neurst_tpu_torch.layers.search.sequence_search import \
    build_search_layer  # noqa: F401
from neurst_tpu_torch.models import bert  # noqa: F401
from neurst_tpu_torch.models import ctnmt_transformer  # noqa: F401
from neurst_tpu_torch.models import gpt2  # noqa: F401
from neurst_tpu_torch.models import light_convolution_model  # noqa: F401
from neurst_tpu_torch.models import multi_task_speech_transformer  # noqa: F401
from neurst_tpu_torch.models import speech_transformer  # noqa: F401
from neurst_tpu_torch.models import transformer  # noqa: F401
from neurst_tpu_torch.models import waitk_transformer  # noqa: F401
from neurst_tpu_torch.models import wav2vec2  # noqa: F401
from neurst_tpu_torch.models.model import build_model  # noqa: F401
from neurst_tpu_torch.optimizers.optimizers import \
    build_optimizer  # noqa: F401
from neurst_tpu_torch.optimizers.schedules.lr_schedules import \
    build_lr_schedule  # noqa: F401
from neurst_tpu_torch.utils import converters  # noqa: F401
