from neurst_tpu_torch.parallel.train_step import (TrainState,  # noqa: F401
                                                  make_eval_step,
                                                  make_train_step)
