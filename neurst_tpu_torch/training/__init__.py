from neurst_tpu_torch.training.validator import (  # noqa: F401
    TrainingStatusRecorder, Validator, build_validator, register_validator)
from neurst_tpu_torch.training import criterion_validator  # noqa: F401
from neurst_tpu_torch.training import seq_generation_validator  # noqa: F401
