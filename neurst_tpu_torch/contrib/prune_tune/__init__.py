"""PruneTune (the counterpart of ``examples/prune_tune/src``): the
``partial_tune`` trainer (``partial_trainer.py``) and the
``mask_predict`` generator (``mask_sequence_generator.py``), reached
through ``run_exp --include``."""
