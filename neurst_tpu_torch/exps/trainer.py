"""The training entry (the port's counterpart of
``neurst_tpu/exps/trainer.py``), on one device.

``Trainer.run`` builds the criterion, restores the newest checkpoint of
the model dir (or a name-filtered ``pretrain_model``), builds the
optimizer chain (clip -> optimizer(lr schedule) -> freeze / rate
schedule -> bf16 params with an f32 master, in that order), writes
``model_configs.yml``, and trains for ``train_steps`` over the task's
TRAIN batches: ``update_cycle`` micro-batches a step, a dropout key
folded with the step, a log (and TensorBoard scalars) every
``summary_steps`` with loss, lr, grad norm, steps/s, target tokens/s and
samples/s, an npz checkpoint every ``save_checkpoint_steps`` (the f32
master with bf16 params) with the port's optimizer sidecar for exact
resume, and an inline validator.

Resume: with the port's sidecar (``ckpt-N.torch_optstate.npz``) the
optimizer state, its counts and the train state's step come back exactly,
and the schedule is read at the restored count; without it a fresh
optimizer starts and the schedule counts from the checkpoint's step.
Both continue at step N + 1 (the JAX package reads its schedule at
2N + 1 after restoring its sidecar: ROADMAP R6).  A JAX ``.optstate``
without a port sidecar raises (``pretrain_model`` starts from the
parameters alone).

Not ported, and refused when set: ``checkpoint_format: orbax``, tensor
and pipeline parallelism, ``gradient_remat``, ``pruning_schedule``,
quantization-aware training and a ``distribution_strategy`` other than
one device.  ``enable_profiler`` traces a window of steps with
``torch.profiler`` (``training/summary.py``).
"""

import logging
import os
import re
import time

import numpy as np
import torch

from neurst_tpu_torch.criterions.criterion import build_criterion
from neurst_tpu_torch.exps.base_experiment import BaseExperiment, register_exp
from neurst_tpu_torch.optimizers.master_weights import (cast_params_bf16,
                                                         with_bf16_params)
from neurst_tpu_torch.optimizers.optimizers import (build_optimizer,
                                                     create_optax_chain,
                                                     freeze)
from neurst_tpu_torch.optimizers.rate_schedule_optimizer import \
    rate_scheduled_updates
from neurst_tpu_torch.optimizers.schedules.lr_schedules import \
    build_lr_schedule
from neurst_tpu_torch.parallel import TrainState, make_train_step
from neurst_tpu_torch.training.summary import (SummaryWriterWrapper,
                                               TrainingProfiler)
from neurst_tpu_torch.training.validator import build_validator
from neurst_tpu_torch.utils import checkpoints as ckpt_lib
from neurst_tpu_torch.utils import compat
from neurst_tpu_torch.utils.configurable import ModelConfigs
from neurst_tpu_torch.utils.flags_core import Flag, ModuleFlag
from neurst_tpu_torch.utils.param_bridge import (state_dict_to_flat,
                                                 to_jax_name)
from neurst_tpu_torch.utils.rng import make_key

__all__ = ["Trainer", "split_microbatches"]

# flags of features the port does not have, and the values that mean off
_UNPORTED = {"checkpoint_format": (None, "npz"),
             "num_model_partitions": (None, 1),
             "pipeline_parallel": (None, 1),
             "gradient_remat": (None, False),
             "pruning_schedule.class": (None, ""),
             "enable_quant": (None, False),
             "distribution_strategy": (None, "", "none", "one_device",
                                       "onedevice")}


@register_exp("train")
class Trainer(BaseExperiment):

    @staticmethod
    def class_or_method_args():
        return [
            ModuleFlag("criterion", "criterion",
                       default="label_smoothed_cross_entropy",
                       help="The training criterion."),
            ModuleFlag("optimizer", "optimizer", default="adam",
                       help="The optimizer."),
            ModuleFlag("lr_schedule", "lr_schedule",
                       help="The learning rate schedule."),
            Flag("train_steps", dtype=Flag.TYPE.INTEGER, default=10000000,
                 help="The maximum number of training steps."),
            Flag("save_checkpoint_steps", dtype=Flag.TYPE.INTEGER,
                 default=1000, help="Save a checkpoint every N steps."),
            Flag("summary_steps", dtype=Flag.TYPE.INTEGER, default=200,
                 help="Log training metrics every N steps."),
            Flag("checkpoints_max_to_keep", dtype=Flag.TYPE.INTEGER,
                 default=8, help="The maximum checkpoints to keep."),
            Flag("checkpoint_format", dtype=Flag.TYPE.STRING,
                 default="npz", help="npz (orbax is not ported)."),
            Flag("update_cycle", dtype=Flag.TYPE.INTEGER, default=1,
                 help="Accumulate gradients over N micro-batches."),
            Flag("bf16_params", dtype=Flag.TYPE.BOOLEAN, default=None,
                 help="Store live parameters in bfloat16 with a float32 "
                      "master copy in the optimizer state (checkpoints "
                      "stay float32 via the master); on by default for a "
                      "bfloat16 model."),
            Flag("clip_value", dtype=Flag.TYPE.FLOAT, default=None,
                 help="Clip gradients by value."),
            Flag("clip_norm", dtype=Flag.TYPE.FLOAT, default=None,
                 help="Clip gradients by global norm."),
            Flag("initial_global_step", dtype=Flag.TYPE.INTEGER, default=None,
                 help="The initial global step (for lr schedule resume)."),
            Flag("pretrain_model", dtype=Flag.TYPE.STRING, default=None,
                 multiple=True, help="Path(s) to pretrained checkpoints "
                                     "for partial (name-based) restore."),
            Flag("pretrain_variable_pattern", dtype=Flag.TYPE.STRING,
                 default=None, multiple=True,
                 help="Regex pattern(s) selecting variables to restore "
                      "from each pretrain_model."),
            Flag("num_model_partitions", dtype=Flag.TYPE.INTEGER, default=1,
                 help="Tensor-parallel size (not ported: 1 only)."),
            Flag("pipeline_parallel", dtype=Flag.TYPE.INTEGER, default=1,
                 help="Pipeline-parallel size (not ported: 1 only)."),
            Flag("distribution_strategy", dtype=Flag.TYPE.STRING,
                 default=None,
                 help="Kept for recipe compatibility: one device only."),
            Flag("dtype", dtype=Flag.TYPE.STRING, default=None,
                 help="Computation dtype override for training."),
            Flag("freeze_variables", dtype=Flag.TYPE.STRING,
                 default=None, help="Regex of variables excluded from "
                                    "updates."),
            Flag("experimental_frozen_variables", dtype=Flag.TYPE.STRING,
                 default=None, help="Another name of freeze_variables."),
            Flag("gradient_remat", dtype=Flag.TYPE.BOOLEAN, default=None,
                 help="Rematerialization (not ported)."),
            Flag("enable_tensorboard", dtype=Flag.TYPE.BOOLEAN,
                 default=True,
                 help="Write TensorBoard scalars under model_dir/train."),
            Flag("enable_profiler", dtype=Flag.TYPE.BOOLEAN, default=None,
                 help="Trace steps 3-5 with torch.profiler into "
                      "model_dir/profile (a Chrome trace)."),
            ModuleFlag("validator", "validator",
                       help="Inline validator run every eval_steps."),
            ModuleFlag("pruning_schedule", "pruning_schedule",
                       help="Weight pruning (not ported)."),
            Flag("rate_scheduled_pattern", dtype=Flag.TYPE.STRING,
                 default=None,
                 help="Regex of variables with rate-scheduled updates "
                      "(CTNMT: freeze then ramp, e.g. 'bert')."),
            Flag("rate_freeze_until", dtype=Flag.TYPE.INTEGER, default=0,
                 help="Matched variables frozen until this step."),
            Flag("rate_ramp_steps", dtype=Flag.TYPE.INTEGER, default=1,
                 help="Matched variables ramp to full updates over this "
                      "many steps."),
        ]

    @staticmethod
    def _refuse_unported(args):
        on = []
        for key, off in _UNPORTED.items():
            value = args.get(key)
            if (value.lower() if isinstance(value, str) else value) \
                    not in off:
                on.append(f"{key}={value}")
        if on:
            raise NotImplementedError(
                f"trainer features not ported: {', '.join(on)}")

    def _restore(self, model, args):
        """The newest checkpoint of the model dir into ``model``, else the
        pretrain models.  Returns (step, path or None, sidecar mapping or
        None)."""
        manager = ckpt_lib.NameBasedCheckpointManager(
            self._model_dir, args.get("checkpoints_max_to_keep") or 8)
        restored = manager.restore(model) if self._model_dir else None
        if restored is None:
            patterns = args.get("pretrain_variable_pattern") or []
            for i, pretrain in enumerate(args.get("pretrain_model") or []):
                path = ckpt_lib.latest_checkpoint(pretrain) \
                    if os.path.isdir(pretrain) else pretrain
                if path is None:
                    raise FileNotFoundError(f"no checkpoint in {pretrain}")
                ckpt_lib.restore_into(
                    model, ckpt_lib.restore_checkpoint_params(path),
                    name_pattern=patterns[i] if i < len(patterns) else None)
                logging.info("Restored pretrain model from %s", path)
            return 0, None, None
        path = restored["path"]
        logging.info("Restored checkpoint at step %s from %s",
                     restored["step"], path)
        sidecar = ckpt_lib.sidecar_path(path)
        if os.path.exists(sidecar):
            with np.load(sidecar) as data:
                return restored["step"] or 0, path, dict(data)
        jax_sidecar = path[:-len(".npz")] + ckpt_lib.JAX_SIDECAR_SUFFIX
        if os.path.exists(jax_sidecar):
            raise ValueError(
                f"{jax_sidecar} is the JAX package's optimizer state (flax "
                f"msgpack of an optax state), which the port cannot read, "
                f"and there is no port sidecar "
                f"({os.path.basename(sidecar)}) beside it.  To start from "
                f"these parameters with a fresh optimizer, train in a new "
                f"model dir with pretrain_model: {path}")
        return restored["step"] or 0, path, None

    def _build_tx(self, args, model, lr_schedule):
        optimizer = build_optimizer(args)
        lr = lr_schedule if lr_schedule is not None else (
            (args.get("optimizer.params") or {}).get("learning_rate")
            or 1e-3)
        tx = create_optax_chain(optimizer, lr,
                                clip_value=args.get("clip_value"),
                                clip_norm=args.get("clip_norm"))
        frozen = (args.get("freeze_variables")
                  or args.get("experimental_frozen_variables"))
        if frozen:
            pat = re.compile(frozen)
            n_frozen = sum(1 for n, _ in model.named_parameters()
                           if pat.search(to_jax_name(n)))
            if n_frozen == 0:
                logging.warning("freeze_variables pattern '%s' matches NO "
                                "variables: nothing is frozen.", frozen)
            else:
                logging.info("freeze_variables '%s': %d variables frozen.",
                             frozen, n_frozen)
            tx = freeze(tx, lambda n: bool(pat.search(to_jax_name(n))))
        if args.get("rate_scheduled_pattern"):
            tx = rate_scheduled_updates(
                tx, args["rate_scheduled_pattern"],
                freeze_until=int(args.get("rate_freeze_until") or 0),
                ramp_steps=int(args.get("rate_ramp_steps") or 1),
                name_of=to_jax_name)
            logging.info("Rate-scheduled updates for pattern '%s'",
                         args["rate_scheduled_pattern"])
        if args.get("bf16_params"):
            # outermost: the freeze and rate masks act on the master's
            # updates inside it, so a frozen weight's master stays put
            tx = with_bf16_params(tx)
            logging.info("bf16 stored params + f32 master enabled")
        return tx

    def run(self):
        args = self._args
        task, model, model_dir = self._task, self._model, self._model_dir
        self._refuse_unported(args)
        if args.get("bf16_params") is None:
            args["bf16_params"] = str(
                model.args.get("dtype") or "").startswith("bf")
        criterion = build_criterion(args)
        seed = int(args.get("seed") or 0)
        model.init_params(torch.Generator().manual_seed(seed))
        logging.info("Model has %.2fM parameters", sum(
            p.numel() for p in model.parameters()) / 1e6)
        init_step, _, opt_flat = self._restore(model, args)
        if args.get("initial_global_step") is not None:
            init_step = args["initial_global_step"]
        # a restored optimizer carries its own count (ROADMAP R6)
        compat.register_initial_step(0 if opt_flat is not None
                                     else init_step)
        lr_schedule = build_lr_schedule(args) \
            if args.get("lr_schedule.class") else None
        tx = self._build_tx(args, model, lr_schedule)
        if args.get("bf16_params"):
            cast_params_bf16(model)
        if model_dir:
            ModelConfigs.dump(task.model_configs(model), model_dir)

        state = TrainState.create(dict(model.named_parameters()), tx)
        if opt_flat is not None:
            # the master comes back exactly; the live bf16 params, read
            # from the checkpoint of that master, are already bf16(master)
            opt_state, step = ckpt_lib.load_opt_state(state.opt_state,
                                                      opt_flat)
            state = TrainState(step=step, params=state.params,
                               opt_state=opt_state)
            logging.info("Restored optimizer state (step %d)", step)
        update_cycle = int(args.get("update_cycle") or 1)
        train_step = make_train_step(model, criterion, tx,
                                     update_cycle=update_cycle,
                                     lr_schedule=lr_schedule)

        train_steps = int(args.get("train_steps") or 10_000_000)
        save_every = int(args.get("save_checkpoint_steps") or 1000)
        log_every = int(args.get("summary_steps") or 200)
        writer = SummaryWriterWrapper(
            os.path.join(model_dir, "train") if model_dir else None,
            enabled=bool(args.get("enable_tensorboard", True)))
        profiler = TrainingProfiler(model_dir,
                                    bool(args.get("enable_profiler")),
                                    model.device)
        validator = None
        if args.get("validator.class"):
            validator = build_validator(args).build(task, model, model_dir)
            logging.info("Inline validator: %s", args["validator.class"])
        # bucket batch sizes must divide the micro-batch count
        batch_args = dict(args, batch_size_multiple=max(8, update_cycle))
        batch_iter_fn = task.create_batch_iterator(
            self._custom_dataset, compat.ModeKeys.TRAIN, batch_args)
        step_key = make_key(seed + 1)
        device = model.device

        step = init_step
        window_start = time.perf_counter()
        window_tokens = window_samples = 0
        last_loss = metrics = None
        logging.info("Start training from step %d to %d", step, train_steps)
        try:
            while step < train_steps:
                epoch_batches = 0
                for batch in _resilient_batches(batch_iter_fn):
                    host_batch = batch
                    if update_cycle > 1:
                        host_batch = split_microbatches(batch, update_cycle)
                        if host_batch is None:
                            continue
                    device_batch = {
                        k: torch.from_numpy(np.ascontiguousarray(v)).to(
                            device, non_blocking=True)
                        for k, v in host_batch.items()}
                    state, metrics = train_step(state, device_batch, step_key)
                    profiler.step()
                    step += 1
                    epoch_batches += 1
                    # tokens/s counts the primary target's non-pad tokens
                    # (``trg_length``), as the JAX trainer does: for the
                    # multi-task model the translation's, not the transcript's
                    window_tokens += int(np.sum(batch["trg_length"]))
                    window_samples += int(np.sum(batch["sample_mask"]))
                    if step % log_every == 0:
                        last_loss = float(metrics["loss"])
                        elapsed = time.perf_counter() - window_start
                        scalars = {
                            "loss": last_loss,
                            "lr": float(metrics.get("lr", 0.0)),
                            "grad_norm": float(metrics["grad_norm"]),
                            "steps_per_sec": log_every / elapsed,
                            "tokens_per_sec": window_tokens / elapsed,
                            "samples_per_sec": window_samples / elapsed}
                        logging.info(
                            "step %d | loss %.4f | lr %.3e | grad_norm %.3f | "
                            "%.2f steps/s | %.3f secs/step | %.0f tokens/s | "
                            "%.1f samples/s", step, last_loss, scalars["lr"],
                            scalars["grad_norm"], scalars["steps_per_sec"],
                            elapsed / log_every, scalars["tokens_per_sec"],
                            scalars["samples_per_sec"])
                        writer.scalars("training", scalars, step)
                        window_start = time.perf_counter()
                        window_tokens = window_samples = 0
                    if step % save_every == 0 and model_dir:
                        self._save(model_dir, step, state, model, args)
                    if validator is not None and validator.should_eval(step):
                        if validator.validate(step, state_dict_to_flat(model)):
                            logging.info("Early stop at step %d.", step)
                            train_steps = step
                    if step >= train_steps:
                        break
                if epoch_batches == 0:
                    logging.warning("Empty dataset epoch; stopping.")
                    break
        finally:
            profiler.close()
        if model_dir:
            self._save(model_dir, step, state, model, args)
        writer.close()
        if last_loss is None and metrics is not None:
            last_loss = float(metrics["loss"])
        logging.info("Training finished at step %d (last loss: %s)", step,
                     last_loss)
        return state

    @staticmethod
    def _params_for_save(state, args):
        """The float32 master with bf16 params, else the live params."""
        if args.get("bf16_params"):
            return state.opt_state["master"]
        return state.params

    def _save(self, model_dir, step, state, model, args):
        ckpt_lib.save_checkpoint(
            model_dir, step,
            state_dict_to_flat(model, self._params_for_save(state, args)),
            max_to_keep=args.get("checkpoints_max_to_keep") or 8,
            opt_state=ckpt_lib.opt_state_to_flat(state.opt_state,
                                                 state.step))


def _resilient_batches(batch_iter_fn):
    """The epoch's batches, retrying transient data errors up to 10
    times: a fresh iterator is fast-forwarded past the batches already
    consumed and the failing one, so nothing is trained twice."""
    retries = consumed = 0
    it = batch_iter_fn()
    while True:
        try:
            batch = next(it)
        except StopIteration:
            return
        except (IOError, EOFError, ValueError) as e:
            retries += 1
            if retries > 10:
                raise
            logging.warning("data error (retry %d/10) after %d batches, "
                            "skipping the failing batch: %s", retries,
                            consumed, e)
            it = batch_iter_fn()
            consumed += 1
            for _ in range(consumed):
                try:
                    next(it)
                except StopIteration:
                    return
                except (IOError, EOFError, ValueError):
                    pass  # the same bad record while fast-forwarding
            continue
        consumed += 1
        yield batch


_SPLIT_DROPPED = {"count": 0}


def split_microbatches(batch, update_cycle):
    """[B, ...] -> [update_cycle, B // update_cycle, ...] for every array
    field (0-d fields broadcast).  None, counted and logged every 100,
    when B is not a multiple of ``update_cycle``."""
    out = {}
    for k, v in batch.items():
        if not hasattr(v, "shape") or v.dtype == object:
            continue
        if v.ndim == 0:
            out[k] = np.broadcast_to(v, (update_cycle,))
            continue
        b = v.shape[0]
        if b % update_cycle != 0:
            _SPLIT_DROPPED["count"] += 1
            if _SPLIT_DROPPED["count"] % 100 == 1:
                logging.warning(
                    "Dropped %d batches whose batch dim %% update_cycle "
                    "!= 0 (latest: %s %% %d); align bucket batch sizes "
                    "with update_cycle.", _SPLIT_DROPPED["count"], b,
                    update_cycle)
            return None
        out[k] = v.reshape((update_cycle, b // update_cycle) + v.shape[1:])
    return out
