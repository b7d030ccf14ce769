from neurst_tpu_torch.criterions.criterion import (Criterion,  # noqa: F401
                                                   build_criterion,
                                                   register_criterion)
from neurst_tpu_torch.criterions.label_smoothed_cross_entropy import \
    LabelSmoothedCrossEntropy  # noqa: F401
from neurst_tpu_torch.criterions.joint_criterion import \
    JointCriterion  # noqa: F401
from neurst_tpu_torch.criterions.label_smoothed_cross_entropy_with_kd \
    import LabelSmoothedCrossEntropyWithKd  # noqa: F401
