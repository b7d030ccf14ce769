from neurst_tpu_torch.sparsity.pruning_optimizer import (  # noqa: F401
    make_variable_filter, prune_gradients)
from neurst_tpu_torch.sparsity.pruning_schedule import (  # noqa: F401
    ConstantSparsity, PolynomialDecay, PruningSchedule,
    build_pruning_schedule)
