from neurst_tpu_torch.exps.base_experiment import (BaseExperiment,  # noqa: F401
                                                   build_exp, register_exp)
from neurst_tpu_torch.exps import evaluator  # noqa: F401
from neurst_tpu_torch.exps import sequence_evaluator  # noqa: F401
from neurst_tpu_torch.exps import sequence_generator  # noqa: F401
from neurst_tpu_torch.exps import trainer  # noqa: F401
from neurst_tpu_torch.exps import validation  # noqa: F401
from neurst_tpu_torch.exps import export  # noqa: F401
