from neurst_tpu_torch.tasks.task import (Task, build_task,  # noqa: F401
                                         register_task)
from neurst_tpu_torch.tasks import seq2seq  # noqa: F401
from neurst_tpu_torch.tasks import speech2text  # noqa: F401
from neurst_tpu_torch.tasks import translation  # noqa: F401
from neurst_tpu_torch.tasks import waitk_translation  # noqa: F401
from neurst_tpu_torch.tasks import language_model  # noqa: F401
