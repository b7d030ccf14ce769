"""Magnitude pruning of the port (``neurst_tpu_torch/sparsity/``) against
the JAX package's (``neurst_tpu/sparsity/``).

Held: both schedules at steps 0..200 (target sparsity bitwise,
``should_prune`` equal); ``prune_gradients`` over the port's Adam chain
against JAX's over optax for 6 steps with two refreshes (masks bitwise,
parameters within 1e-6); the threshold on 2^24 + 1 elements equal to
``jnp.quantile``'s; the ``train`` entry with the pruning flags against
the JAX trainer from one ``ckpt-0`` (the form of
``tests/test_operational_paths.py``'s pruning test, at a tiny
Transformer, SGD, one batch shape; the JAX side in a subprocess on one
CPU device): zero patterns equal, weights within 1e-5, excluded
variables dense; a run resumed from its checkpoint and sidecar equals an
unbroken one bitwise; and the pruning counter starts at 0 whatever
``--initial_global_step`` says.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import port_test_support  # noqa: F401  (one torch thread per worker)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from neurst_tpu.optimizers import build_optimizer as jax_build_optimizer  # noqa
from neurst_tpu.optimizers import \
    create_optax_chain as jax_chain  # noqa: E402
from neurst_tpu.sparsity import pruning_optimizer as jax_prune  # noqa: E402
from neurst_tpu.sparsity import pruning_schedule as jax_sched  # noqa: E402
from neurst_tpu.tasks.task import build_task as jax_build_task  # noqa: E402
from neurst_tpu.utils import checkpoints as jax_ckpt  # noqa: E402

from neurst_tpu_torch.cli import run_exp as port_run_exp  # noqa: E402
from neurst_tpu_torch.optimizers.optimizers import (  # noqa: E402
    apply_updates, build_optimizer, create_optax_chain)
from neurst_tpu_torch.sparsity import pruning_optimizer  # noqa: E402
from neurst_tpu_torch.sparsity import pruning_schedule  # noqa: E402
from neurst_tpu_torch.utils import checkpoints as port_ckpt  # noqa: E402
from neurst_tpu_torch.utils.param_bridge import to_jax_name  # noqa: E402

from port_test_support import (JAX_CLI_SIDE, REPO,  # noqa: E402
                               start_jax_side)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EXAMPLES = os.path.join(REPO, "tests", "examples")
SCHEDULES = [
    ("polynomial_decay", {"initial_sparsity": 0.1, "final_sparsity": 0.8,
                          "begin_pruning_step": 10, "end_pruning_step": 190,
                          "pruning_frequency": 7, "power": 3.0}),
    ("polynomial_decay", {"final_sparsity": 0.7, "begin_pruning_step": 5,
                          "pruning_frequency": 3, "power": 1.5}),
    ("constant_sparsity", {"target_sparsity": 0.3, "begin_pruning_step": 4,
                           "end_pruning_step": 100, "pruning_frequency": 5})]
# pruned at steps 2, 5, 8 of each 10-step run
PRUNING = ["--pruning_schedule.class", "polynomial_decay",
           "--pruning_schedule.params",
           json.dumps({"initial_sparsity": 0.0, "final_sparsity": 0.6,
                       "begin_pruning_step": 2, "end_pruning_step": 8,
                       "pruning_frequency": 3}),
           "--nopruning_variable_pattern", "(ln|bias|modality)"]
STEPS, LR = 10, 0.1


def _cls_args(cls, args):
    return {"pruning_schedule.class": cls, "pruning_schedule.params": args}


@pytest.mark.parametrize("cls, args", SCHEDULES)
def test_schedules_match_jax(cls, args):
    theirs = jax_sched.build_pruning_schedule(_cls_args(cls, args))
    ours = pruning_schedule.build_pruning_schedule(_cls_args(cls, args))
    steps = jnp.arange(201)
    want_s = np.asarray(jax.vmap(theirs.target_sparsity)(steps), np.float32)
    want_p = np.asarray(jax.vmap(theirs.should_prune)(steps))
    got_s = np.asarray([ours.target_sparsity(int(s)) for s in steps],
                       np.float32)
    got_p = np.asarray([ours.should_prune(int(s)) for s in steps])
    np.testing.assert_array_equal(got_s.view(np.int32),
                                  want_s.view(np.int32))
    np.testing.assert_array_equal(got_p, want_p)
    assert got_p.sum() > 2


def test_prune_gradients_over_adam_matches_optax():
    rng = np.random.RandomState(0)
    shapes = {"layer.weight": (24, 40), "layer.bias": (40,),
              "proj.weight": (16, 24)}
    init = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(6)]
    sched = ("polynomial_decay", {"final_sparsity": 0.7,
                                  "begin_pruning_step": 1,
                                  "end_pruning_step": 3,
                                  "pruning_frequency": 2})
    opt = {"optimizer.class": "adam",
           "optimizer.params": {"beta_2": 0.98, "epsilon": 1e-9}}
    flt = pruning_optimizer.make_variable_filter("weight|kernel", "proj")

    tx = pruning_optimizer.prune_gradients(
        create_optax_chain(build_optimizer(opt), 1e-2),
        pruning_schedule.build_pruning_schedule(_cls_args(*sched)),
        flt, name_of=to_jax_name)
    params = {n: torch.from_numpy(v.copy()) for n, v in init.items()}
    state = tx.init(params)

    def nest(flat):
        out = {}
        for n, v in flat.items():
            mod, leaf = to_jax_name(n).split("/")
            out.setdefault(mod, {})[leaf] = jnp.asarray(v)
        return out

    jtx = jax_prune.prune_gradients(
        jax_chain(jax_build_optimizer(opt), 1e-2),
        jax_sched.build_pruning_schedule(_cls_args(*sched)), flt)
    jparams = nest(init)
    jstate = jtx.init(jparams)
    for g in grads:
        updates, state = tx.update({n: torch.from_numpy(v) for n, v in
                                    g.items()}, state, params)
        apply_updates(params, updates)
        jupdates, jstate = jtx.update(nest(g), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         jupdates)
    assert state["step"] == int(jstate.step) == 6
    assert sorted(state["masks"]) == ["layer.weight"]
    mask = state["masks"]["layer.weight"].numpy()
    np.testing.assert_array_equal(mask, np.asarray(jstate.masks["layer"][
        "kernel"]))
    assert abs(float((mask == 0).mean()) - 0.7) < 0.01
    for n, p in params.items():
        mod, leaf = to_jax_name(n).split("/")
        np.testing.assert_allclose(p.numpy(), np.asarray(jparams[mod][leaf]),
                                   atol=1e-6, err_msg=n)
    assert int((params["layer.weight"] == 0).sum()) == int((mask == 0).sum())


def test_threshold_above_2_24_elements_equals_jnp_quantile():
    """``torch.quantile`` refuses more than 2^24 elements; the port's
    sort-based threshold keeps JAX's float32 index arithmetic there (the
    element count rounds to a float32 number).  The weights are distinct
    squares in ascending order, which both sorts take quickly."""
    n = 2 ** 24 + 1
    w = np.square(np.arange(n, dtype=np.float64) / n).astype(np.float32)
    sparsity = np.float32(0.37)
    want = np.asarray(jnp.quantile(jnp.abs(jnp.asarray(w)), sparsity))
    got = pruning_optimizer.magnitude_threshold(torch.from_numpy(w),
                                                sparsity)
    assert got.item() == float(want)


# ------------------------------- the CLIs ----------------------------- #

def _config(root):
    """The tiny Transformer of ``example_train_seq2seq.yml`` on its first
    80 pairs: five fixed batches of 16, every one [16, 16], SGD at a
    constant rate."""
    for side in ("src", "trg"):
        with open(os.path.join(EXAMPLES, f"train.{side}")) as f:
            lines = f.readlines()[:80]
        with open(os.path.join(root, f"train.{side}"), "w") as f:
            f.writelines(lines)
    import yaml
    with open(os.path.join(EXAMPLES, "example_train_seq2seq.yml")) as f:
        cfg = yaml.safe_load(f)
    text = json.dumps(cfg).replace('"tests/examples/', f'"{EXAMPLES}/')
    cfg = json.loads(text)
    cfg["task.params"].update(batch_by_tokens=False, batch_size=16,
                              shuffle_buffer=0, pad_length_multiple=16)
    cfg["dataset.params"] = {"src_file": os.path.join(root, "train.src"),
                             "trg_file": os.path.join(root, "train.trg")}
    cfg["entry.params"] = {
        "criterion.class": "label_smoothed_cross_entropy",
        "criterion.params": {"label_smoothing": 0.1},
        "optimizer.class": "sgd", "lr_schedule.class": "constant",
        "lr_schedule.params": {"learning_rate": LR},
        "train_steps": STEPS, "summary_steps": 5,
        "save_checkpoint_steps": 5, "enable_tensorboard": False}
    path = os.path.join(root, "prune.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path, cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("prune_cli"))
    path, cfg = _config(root)
    train = ["--entry", "train", "--config_paths", path] + PRUNING
    seeded = os.path.join(root, "seeded")
    names = ("jax", "unbroken", "resumed", "initial_step")
    dirs = {n: os.path.join(root, n) for n in names}
    proc = start_jax_side(JAX_CLI_SIDE, root, "jax_train", [
        ["wait", seeded, None],
        ["train", train + ["--model_dir", dirs["jax"]],
         os.path.join(root, "jax_train.json")]])
    try:
        jtask = jax_build_task(cfg)
        jmodel = jtask.build_model({"model.class": cfg["model.class"],
                                    "model.params": cfg["model.params"]})
        jax_ckpt.save_checkpoint(os.path.join(root, "seed"), 0,
                                 jax.tree_util.tree_map(
                                     np.asarray, jmodel.init_params(
                                         jax.random.PRNGKey(1))))
        for d in dirs.values():
            shutil.copytree(os.path.join(root, "seed"), d)
        open(seeded, "w").close()

        def port(name, *extra):
            port_run_exp.cli_main(train + ["--model_dir", dirs[name],
                                           "--device", "cpu", *extra])

        port("unbroken")
        port("resumed", "--train_steps", "5")
        port("resumed")
        port("initial_step", "--initial_global_step", "100",
             "--train_steps", "105")
        proc[0].wait(timeout=600)
    finally:
        proc[0].kill()
    with open(proc[1]) as f:
        assert proc[0].returncode == 0, f.read()[-4000:]
    return dirs


def _ckpt(d, step):
    return port_ckpt.restore_checkpoint_params(os.path.join(
        d, f"ckpt-{step}.npz"))


def _pruned(name):
    return "kernel" in name and not any(s in name for s in ("ln", "bias",
                                                            "modality"))


def test_train_entry_prunes_as_the_jax_trainer(runs):
    ours = _ckpt(runs["unbroken"], STEPS)
    want = jax_ckpt.restore_checkpoint_params(os.path.join(
        runs["jax"], f"ckpt-{STEPS}.npz"))
    assert sorted(ours) == sorted(want)
    pruned = 0
    for name in want:
        np.testing.assert_allclose(ours[name], want[name], atol=1e-5,
                                   err_msg=name)
        np.testing.assert_array_equal(ours[name] == 0, want[name] == 0,
                                      err_msg=name)
        zeros = float((ours[name] == 0).mean())
        if _pruned(name):
            # the schedule's target at the last refresh (step 8)
            assert abs(zeros - 0.6) < 0.02, (name, zeros)
            pruned += 1
        else:
            assert zeros < 0.05, (name, zeros)
    assert pruned >= 10


def test_resumed_pruning_run_equals_the_unbroken_run(runs):
    sidecar = port_ckpt.sidecar_path(os.path.join(runs["resumed"],
                                                  "ckpt-5.npz"))
    with np.load(sidecar) as data:
        masks = [k for k in data.files if "/masks/" in k]
        counts = [int(data[k]) for k in data.files if k.endswith("/step")]
    assert masks and 5 in counts
    ours, want = _ckpt(runs["resumed"], STEPS), _ckpt(runs["unbroken"], STEPS)
    for name in want:
        np.testing.assert_array_equal(ours[name], want[name], err_msg=name)


def test_pruning_counter_ignores_initial_global_step(runs):
    """Five steps from --initial_global_step 100 prune at the counter's
    step 2, as the first five steps of a run from 0 do: the two
    checkpoints are equal (SGD at a constant rate reads no step)."""
    ours, want = _ckpt(runs["initial_step"], 105), _ckpt(runs["unbroken"], 5)
    zeros = 0
    for name in want:
        np.testing.assert_array_equal(ours[name], want[name], err_msg=name)
        zeros += int((ours[name] == 0).sum())
    assert zeros > 0
