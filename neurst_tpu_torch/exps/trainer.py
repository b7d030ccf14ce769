"""The training entry (the port's counterpart of
``neurst_tpu/exps/trainer.py``), on one rank or over a mesh of ranks.

``Trainer.run`` builds the criterion, restores the newest checkpoint of
the model dir (or a name-filtered ``pretrain_model``), builds the
optimizer chain (clip -> optimizer(lr schedule) -> pruning -> freeze
-> rate schedule -> ``_wrap_tx`` -> bf16 params with an f32 master, in
that order), writes
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

With ``enable_quant`` (QAT; the layers were built under ``run_exp``'s
``global_init``) the step adds ``clip_l2_penalty`` of the clips to the
loss, once a step.  ``pruning_schedule`` adds magnitude pruning
(``sparsity/pruning_optimizer.py``) over the variables that
``pruning_variable_pattern`` / ``nopruning_variable_pattern`` select by
the JAX package's flat names; its masks and count ride in the sidecar.
``gradient_remat`` recomputes the forward in the backward
(``torch.utils.checkpoint`` over the whole forward, as the JAX step
wraps it in ``jax.checkpoint``).  ``_wrap_tx`` is a hook for entries
that subclass the trainer (the PruneTune plug-in masks updates there).

Parallelism (one process per GPU, ``parallel/``): the ranks form a
("data", "stage", "model") mesh with ``pipeline_parallel`` stages and
``num_model_partitions`` model ranks; data parallelism is always on over
the rest, as in the JAX trainer.  Each data rank batches its own shard of
the data (``shard_id`` / ``total_shards``) at ``batch_size``, so the
global batch is data ranks x batch size, as a JAX process with one
device batches it (ROADMAP R16); its first stage and model rank reads the
batch and hands it to the others of its data coordinate.  Bucket batch
sizes are multiples of lcm(max(8, dp x update_cycle), the pipeline's
micro-batches).  The step reduces the loss and gradients over "data" and
"stage" (``parallel/train_step.py``); ``clip_norm`` and the logged norm
are global.  A pipeline stage holds its own layers and their optimizer
moments only (``parallel.apply_mesh``).  Checkpoints gather the model's
shards and stages and are written, with the logs' TensorBoard scalars
and ``model_configs.yml``, by rank 0 only; a restore cuts every rank's
part of the parameters and of the optimizer's state.  An inline
validator runs on the model group of rank 0 (rank 0 alone without tensor
parallelism; the group decodes together through the tensor-parallel
layers), with every pipeline layer gathered to every rank and each ring
encoder over one rank for the while; rank 0 scores, keeps the best
checkpoints and broadcasts the early stop.  Magnitude pruning takes each
variable's threshold from the whole variable.  A data error raises on a
mesh of several ranks instead of retrying, and a rank whose shard yields
no batch in an epoch stops every rank.  ``distribution_strategy`` is
accepted and ignored: the process group replaces it.

``checkpoint_format: orbax`` saves the parameters as ``ckpt-N.orbax``
directories (``utils/orbax_checkpoints``: every rank writes the
hyperslabs its shards are, in the JAX layout, and rank 0 the root
manifest over them) with the port's optimizer sidecar beside them; a
resume reads the newest checkpoint of either format.  A JAX dir whose
newest checkpoint has only the JAX package's ``ckpt-N.optstate.orbax``
resumes from it where its Adam / AdamW state (counts and moments) maps
onto the port's optimizer state, and raises otherwise.
``enable_profiler`` traces a window of steps with ``torch.profiler``
(``training/summary.py``).
"""

import logging
import math
import os
import re
import time

import numpy as np
import torch

from neurst_tpu_torch.criterions.criterion import build_criterion
from neurst_tpu_torch.exps.base_experiment import BaseExperiment, register_exp
from neurst_tpu_torch.layers.quantization.quant_layers import clip_l2_penalty
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
from neurst_tpu_torch.parallel import collectives
from neurst_tpu_torch.parallel.mesh import make_mesh
from neurst_tpu_torch.parallel.sharding import (apply_mesh,
                                                checkpoint_leaves,
                                                data_sharded, gather_tensors,
                                                make_norm_fn, shard_tensors,
                                                whole_model)
from neurst_tpu_torch.parallel.utils import process_index
from neurst_tpu_torch.sparsity.pruning_optimizer import (make_variable_filter,
                                                         prune_gradients)
from neurst_tpu_torch.sparsity.pruning_schedule import \
    build_pruning_schedule
from neurst_tpu_torch.training.summary import (SummaryWriterWrapper,
                                               TrainingProfiler)
from neurst_tpu_torch.training.validator import build_validator
from neurst_tpu_torch.utils import checkpoints as ckpt_lib
from neurst_tpu_torch.utils import orbax_checkpoints as orbax_lib
from neurst_tpu_torch.utils import compat
from neurst_tpu_torch.utils.configurable import ModelConfigs
from neurst_tpu_torch.utils.flags_core import Flag, ModuleFlag
from neurst_tpu_torch.utils.param_bridge import (flat_to_state_dict,
                                                 state_dict_to_flat,
                                                 to_jax_name)
from neurst_tpu_torch.utils.rng import make_key

__all__ = ["Trainer", "split_microbatches"]


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
                 default="npz", choices=["npz", "orbax"],
                 help="npz = name-keyed, gathered to rank 0 "
                      "(reference-compatible tooling); orbax = sharded "
                      "(OCDBT + zarr), each rank writing its shards."),
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
                 help="Tensor-parallel size: heads, mlp and vocabulary "
                      "sharded over this many ranks."),
            Flag("pipeline_parallel", dtype=Flag.TYPE.INTEGER, default=1,
                 help="Pipeline-parallel size: the ranks of the mesh's "
                      "'stage' axis (the model's pipeline_stages > 1)."),
            Flag("distribution_strategy", dtype=Flag.TYPE.STRING,
                 default=None,
                 help="Kept for recipe compatibility (the process group "
                      "replaces it)."),
            Flag("dtype", dtype=Flag.TYPE.STRING, default=None,
                 help="Computation dtype override for training."),
            Flag("freeze_variables", dtype=Flag.TYPE.STRING,
                 default=None, help="Regex of variables excluded from "
                                    "updates."),
            Flag("experimental_frozen_variables", dtype=Flag.TYPE.STRING,
                 default=None, help="Another name of freeze_variables."),
            Flag("gradient_remat", dtype=Flag.TYPE.BOOLEAN, default=None,
                 help="Recompute the whole forward pass in the backward "
                      "(torch.utils.checkpoint), as the JAX step's "
                      "jax.checkpoint does."),
            Flag("enable_tensorboard", dtype=Flag.TYPE.BOOLEAN,
                 default=True,
                 help="Write TensorBoard scalars under model_dir/train."),
            Flag("enable_profiler", dtype=Flag.TYPE.BOOLEAN, default=None,
                 help="Trace steps 3-5 with torch.profiler into "
                      "model_dir/profile (a Chrome trace)."),
            ModuleFlag("validator", "validator",
                       help="Inline validator run every eval_steps."),
            ModuleFlag("pruning_schedule", "pruning_schedule",
                       help="The weight pruning schedule (enables "
                            "magnitude pruning when set)."),
            Flag("pruning_variable_pattern", dtype=Flag.TYPE.STRING,
                 default=None,
                 help="Regex of variables included in pruning."),
            Flag("nopruning_variable_pattern", dtype=Flag.TYPE.STRING,
                 default=None,
                 help="Regex of variables excluded from pruning."),
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
        jax_orbax = path[:-len(".orbax")] + ".optstate.orbax"
        if orbax_lib.is_orbax_checkpoint(path) and os.path.isdir(jax_orbax):
            # the JAX package's optax state, where it maps onto ours
            self._jax_opt_state = jax_orbax
            return restored["step"] or 0, path, None
        jax_sidecar = os.path.splitext(path)[0] + ckpt_lib.JAX_SIDECAR_SUFFIX
        if os.path.exists(jax_sidecar):
            raise ValueError(
                f"{jax_sidecar} is the JAX package's optimizer state (flax "
                f"msgpack of an optax state), which the port cannot read, "
                f"and there is no port sidecar "
                f"({os.path.basename(sidecar)}) beside it.  To start from "
                f"these parameters with a fresh optimizer, train in a new "
                f"model dir with pretrain_model: {path}")
        return restored["step"] or 0, path, None

    def _build_tx(self, args, model, lr_schedule, norm_fn=None,
                  gather=None):
        optimizer = build_optimizer(args)
        lr = lr_schedule if lr_schedule is not None else (
            (args.get("optimizer.params") or {}).get("learning_rate")
            or 1e-3)
        tx = create_optax_chain(optimizer, lr,
                                clip_value=args.get("clip_value"),
                                clip_norm=args.get("clip_norm"),
                                norm_fn=norm_fn)
        if args.get("pruning_schedule.class"):
            tx = prune_gradients(
                tx, build_pruning_schedule(args),
                make_variable_filter(args.get("pruning_variable_pattern"),
                                     args.get("nopruning_variable_pattern")),
                name_of=to_jax_name, gather=gather)
            logging.info("Enabled magnitude pruning: %s",
                         args["pruning_schedule.class"])
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
        tx = self._wrap_tx(tx)
        if args.get("bf16_params"):
            # outermost: the pruning, freeze and rate masks act on the
            # master's updates inside it, so a frozen weight's master stays
            # put
            tx = with_bf16_params(tx)
            logging.info("bf16 stored params + f32 master enabled")
        return tx

    def run(self):
        args = self._args
        task, model, model_dir = self._task, self._model, self._model_dir
        self._jax_opt_state = None
        if args.get("bf16_params") is None:
            args["bf16_params"] = str(
                model.args.get("dtype") or "").startswith("bf")
        criterion = build_criterion(args)
        seed = int(args.get("seed") or 0)
        model.init_params(torch.Generator().manual_seed(seed))
        logging.info("Model has %.2fM parameters", sum(
            p.numel() for p in model.parameters()) / 1e6)
        init_step, _, opt_flat = self._restore(model, args)
        jax_opt = None
        if self._jax_opt_state is not None:
            # read while every rank holds the whole model
            jax_opt = _jax_opt_state_entries(self._jax_opt_state, model)
        if args.get("initial_global_step") is not None:
            init_step = args["initial_global_step"]
        # a restored optimizer carries its own count (ROADMAP R6)
        compat.register_initial_step(
            0 if opt_flat is not None or jax_opt is not None else init_step)
        # the mesh: every rank holds the whole restored model, then keeps
        # its shards
        mesh = self._mesh = make_mesh(
            model_parallel=int(args.get("num_model_partitions") or 1),
            pipeline_parallel=int(args.get("pipeline_parallel") or 1))
        specs = self._specs = apply_mesh(model, mesh)
        self._rank0 = process_index() == 0
        dp = mesh.shape["data"]
        norm_fn = make_norm_fn(specs, mesh)
        lr_schedule = build_lr_schedule(args) \
            if args.get("lr_schedule.class") else None
        tx = self._build_tx(
            args, model, lr_schedule, norm_fn,
            gather=lambda name, part: gather_tensors({name: part}, specs,
                                                     mesh)[name])
        if args.get("bf16_params"):
            cast_params_bf16(model)
        if model_dir and self._rank0:
            ModelConfigs.dump(task.model_configs(model), model_dir)

        state = TrainState.create(dict(model.named_parameters()), tx)
        if jax_opt is not None:
            opt_flat = _jax_opt_state_flat(
                jax_opt, set(ckpt_lib.opt_state_to_flat(state.opt_state, 0)),
                init_step)
        if opt_flat is not None:
            # the master comes back exactly; the live bf16 params, read
            # from the checkpoint of that master, are already bf16(master)
            opt_state, step = ckpt_lib.load_opt_state(
                state.opt_state, self._shard_opt_flat(opt_flat))
            state = TrainState(step=step, params=state.params,
                               opt_state=opt_state)
            logging.info("Restored optimizer state (step %d)", step)
        update_cycle = int(args.get("update_cycle") or 1)
        extra_loss_fn = None
        if args.get("enable_quant"):
            # the layers quantize themselves (built under run_exp's
            # global_init); the step adds the L2 term on their clips
            extra_loss_fn = clip_l2_penalty
            logging.info("Quantization-aware training enabled (learned "
                         "clip-max fake quantization)")
        train_step = make_train_step(model, criterion, tx,
                                     update_cycle=update_cycle,
                                     lr_schedule=lr_schedule,
                                     extra_loss_fn=extra_loss_fn,
                                     remat=bool(args.get("gradient_remat")),
                                     mesh=mesh, norm_fn=norm_fn,
                                     stage_local=frozenset(specs.owners))

        train_steps = int(args.get("train_steps") or 10_000_000)
        save_every = int(args.get("save_checkpoint_steps") or 1000)
        log_every = int(args.get("summary_steps") or 200)
        writer = SummaryWriterWrapper(
            os.path.join(model_dir, "train") if model_dir else None,
            enabled=bool(args.get("enable_tensorboard", True))
            and self._rank0)
        profiler = TrainingProfiler(model_dir,
                                    bool(args.get("enable_profiler")),
                                    model.device)
        validator = None
        if args.get("validator.class"):
            # every rank keeps the schedule; rank 0 alone keeps the best
            # checkpoints
            validator = build_validator(args)
            if self._validates():
                validator.build(task, model,
                                model_dir if self._rank0 else None)
            logging.info("Inline validator: %s", args["validator.class"])
        # bucket batch sizes must divide dp x the micro-batch count and
        # the pipeline's micro-batches
        multiple = max(8, dp * update_cycle)
        mp_cfg = dict(args.get("model.params") or {})
        for side in ("encoder", "decoder"):
            stages = int(mp_cfg.get(f"{side}.pipeline_stages") or 1)
            if stages > 1:
                micro = int(mp_cfg.get(f"{side}.pipeline_microbatches")
                            or stages)
                multiple = multiple * micro // math.gcd(multiple, micro)
        batch_args = dict(args, batch_size_multiple=multiple)
        batch_iter_fn = task.create_batch_iterator(
            self._custom_dataset, compat.ModeKeys.TRAIN, batch_args,
            num_replicas_in_sync=dp, shard_id=mesh.coords["data"],
            total_shards=dp)
        if mesh.size > 1:
            epochs = _mesh_batches(batch_iter_fn, mesh, update_cycle,
                                   device=model.device)
        else:
            epochs = None
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
                for batch in (_resilient_batches(batch_iter_fn)
                              if epochs is None else epochs):
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
                    if validator is not None \
                            and validator.should_eval(step):
                        stop = self._validate(validator, step, model)
                        if stop:
                            logging.info("Early stop at step %d.", step)
                            train_steps = step
                    if step >= train_steps:
                        break
                if epoch_batches == 0 or epochs is not None:
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

    def _validates(self) -> bool:
        """Whether this rank runs the inline validator: those of rank 0's
        model group (rank 0 alone without tensor parallelism)."""
        coords = self._mesh.coords
        return coords["data"] == 0 and coords["stage"] == 0

    def _validate(self, validator, step, model) -> bool:
        """Validates the live weights (every rank calls it); returns rank
        0's early stop.  Every rank takes part in gathering the weights
        (rank 0's savers keep them whole) and every pipeline layer;
        rank 0's model group decodes, each ring encoder over one rank."""
        mesh, specs = self._mesh, self._specs
        live = gather_tensors(dict(model.named_parameters()), specs, mesh)
        flat = state_dict_to_flat(model, live) if self._rank0 else None
        del live
        stop = False
        with whole_model(model, specs, mesh):
            if self._validates():
                stop = validator.validate(step, flat)
        if mesh.size > 1:
            stop = collectives.broadcast_object(
                stop, 0, torch.distributed.group.WORLD)
        return stop

    def _wrap_tx(self, tx):
        """Subclass hook: wraps the chain inside the bf16 master (the
        PruneTune plug-in masks updates here)."""
        return tx

    @staticmethod
    def _params_for_save(state, args):
        """The float32 master with bf16 params, else the live params."""
        if args.get("bf16_params"):
            return state.opt_state["master"]
        return state.params

    def _save(self, model_dir, step, state, model, args):
        """Rank 0 writes the checkpoint; under tensor or pipeline
        parallelism every rank first takes part in gathering the shards
        and the stages."""
        mesh, specs = self._mesh, self._specs
        params = self._params_for_save(state, args)
        opt_state = state.opt_state
        orbax = args.get("checkpoint_format") == "orbax"
        if self._split() and not orbax:
            params = gather_tensors(params, specs, mesh)
        if self._split():
            opt_state = _map_named_tensors(
                opt_state, lambda name, t: gather_tensors(
                    {name: t}, specs, mesh)[name])
        keep = args.get("checkpoints_max_to_keep") or 8
        if orbax:
            # every rank writes its own hyperslabs of the parameters
            leaves = checkpoint_leaves(model, params, specs, mesh)
            world = torch.distributed.get_world_size() \
                if mesh.size > 1 else 1
            path = orbax_lib.save_checkpoint_orbax(
                model_dir, step, None, max_to_keep=keep, leaves=leaves,
                rank=process_index(), world=world,
                barrier=torch.distributed.barrier if world > 1 else None)
            if self._rank0:
                ckpt_lib.save_opt_sidecar(
                    path, ckpt_lib.opt_state_to_flat(opt_state, state.step))
            return
        if not self._rank0:
            return
        ckpt_lib.save_checkpoint(
            model_dir, step, state_dict_to_flat(model, params),
            max_to_keep=keep,
            opt_state=ckpt_lib.opt_state_to_flat(opt_state, state.step))

    def _split(self) -> bool:
        """Whether a parameter is split over ranks (model shards, pipeline
        stages or experts over "data")."""
        specs = self._specs
        return self._mesh.shape["model"] > 1 or bool(specs.owners) \
            or bool(data_sharded(specs))

    def _shard_opt_flat(self, flat):
        """This rank's parts of a sidecar's moments (named by their
        parameters' names, the last part of their keys)."""
        specs = self._specs
        if not self._split():
            return flat
        out = {}
        for key, value in flat.items():
            name = key.rsplit("/", 1)[-1]
            if specs.get(name) is not None or name in specs.owners:
                value = shard_tensors({name: torch.from_numpy(
                    np.asarray(value))}, self._specs,
                    self._mesh)[name].numpy()
            out[key] = value
        return out


def _jax_opt_state_entries(path, model):
    """The leaves of the JAX package's optax state in
    ``ckpt-N.optstate.orbax`` as (key path, tail, value): a per-parameter
    leaf (a moment) has its parameter's port name as the tail and the
    port's layout (``param_bridge``), any other leaf its last key."""
    jax_names = set(state_dict_to_flat(model))
    groups, out = {}, []
    for keys, value in orbax_lib.read_tree(path).items():
        for j in range(len(keys)):
            if "/".join(keys[j:]) in jax_names:
                groups.setdefault(keys[:j], {})["/".join(keys[j:])] = value
                break
        else:
            out.append((keys[:-1], keys[-1], value))
    for prefix, moments in groups.items():
        for name, value in flat_to_state_dict(moments, model).items():
            out.append((prefix, name, value.numpy()))
    logging.info("Read the JAX optimizer state of %s (%d leaves)", path,
                 len(out))
    return out


def _jax_opt_state_flat(entries, port_keys, step):
    """The port's sidecar mapping of ``_jax_opt_state_entries``: each
    leaf under the key of the port's state (``port_keys``) that its key
    path names, where an optax chain of one live member (``scale_by_adam``
    beside the constant learning rate's empty state) is one level in the
    port's state; the train state's step is the checkpoint's, and so is
    a count of the port's that JAX keeps no state for (the learning-rate
    scale's, which JAX leaves empty for a constant rate).  A leaf that
    names no key of the port's keeps its own, and ``load_opt_state``
    raises on it (another optimizer)."""
    flat = {"step": np.asarray(step, np.int64)}
    for prefix, tail, value in entries:
        digits = [i for i, k in enumerate(prefix) if k.isdigit()]
        candidates = [prefix] + [prefix[:i] + prefix[i + 1:]
                                 for i in digits]
        keys = ["/".join(("opt_state",) + c + (tail,)) for c in candidates]
        flat[next((k for k in keys if k in port_keys), keys[0])] = value
    for key in port_keys - set(flat):
        if key.endswith("/count"):
            flat[key] = np.asarray(step, np.int32)
    return flat


def _map_named_tensors(node, fn, name=None):
    """An optimizer state with every tensor leaf replaced by ``fn(name,
    leaf)``, ``name`` the last dict key above the leaf (the parameter's
    name for a moment)."""
    if isinstance(node, dict):
        return {k: _map_named_tensors(v, fn, k) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(_map_named_tensors(v, fn, name) for v in node)
    if isinstance(node, torch.Tensor):
        return fn(name, node)
    return node


def _mesh_batches(batch_iter_fn, mesh, update_cycle, device):
    """The batches of a mesh of ranks, epoch after epoch: the first stage
    and model rank of each data coordinate reads its shard and hands each
    batch to the other ranks of that coordinate; before each step the
    ranks agree that every data rank has a batch, and all stop together
    when one has none (an epoch of its shard gave no batch).  A data
    error raises: one rank skipping a batch would desynchronize the
    steps."""
    leader = mesh.coords["stage"] == 0 and mesh.coords["model"] == 0
    world = torch.distributed.group.WORLD

    def local():
        while True:
            n = 0
            for batch in batch_iter_fn():
                if update_cycle > 1 and split_microbatches(
                        batch, update_cycle) is None:
                    continue
                n += 1
                yield batch
            if n == 0:
                return

    it = local() if leader else None
    while True:
        batch = next(it, None) if leader else None
        batch = collectives.broadcast_object(batch, 0,
                                             mesh.group("replica"))
        flag = collectives.all_reduce(
            torch.tensor([0 if batch is None else 1], device=device), world,
            torch.distributed.ReduceOp.MIN)
        if int(flag.item()) == 0:
            if batch is None:
                logging.warning("Empty dataset epoch; stopping.")
            return
        yield batch


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
