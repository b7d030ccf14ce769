"""One rank of the port's parallel tests (not a test file): a gloo
process group on the CPU that runs a list of scenarios and writes what
each gives.

    python tests/torch_parallel_worker.py RANK WORLD PORT WORK

``WORK/inputs.pkl`` holds {"scenarios": [...], "data": {...}}; the rank
writes ``WORK/rank<RANK>.pkl`` ({scenario id: result}).  Imports torch
and the port only.  ``start_group`` / ``wait_group`` (for the tests)
start the ranks and collect their results; a rank that runs past 240
seconds dumps its stack and exits.
"""

import os
import pickle
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_group(world, work, scenarios, data):
    """Starts ``world`` gloo ranks on ``scenarios``; ``wait_group`` gives
    their results."""
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump({"scenarios": scenarios, "data": data}, f)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    procs = []
    for rank in range(world):
        with open(os.path.join(work, f"rank{rank}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(rank),
                 str(world), str(port), work], cwd=REPO, env=env,
                stdout=log, stderr=subprocess.STDOUT))
    return work, procs


def wait_group(started, timeout=300):
    """Each rank's {scenario id: result} of a ``start_group``; raises
    with the first failing rank's log."""
    work, procs = started
    failed = []
    for rank, proc in enumerate(procs):
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = "timeout"
        if rc != 0:
            failed.append(rank)
            break
    if failed:
        for p in procs:
            if p.poll() is None:
                p.kill()
        with open(os.path.join(work, f"rank{failed[0]}.log")) as f:
            raise RuntimeError(f"rank {failed[0]} failed:\n"
                               f"{f.read()[-6000:]}")
    out = []
    for rank in range(len(procs)):
        with open(os.path.join(work, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def spawn_group(world, work, scenarios, data, timeout=300):
    """Runs ``scenarios`` on ``world`` gloo ranks; returns each rank's
    {scenario id: result}."""
    return wait_group(start_group(world, work, scenarios, data), timeout)


def _batch_of(data, name):
    return {k: v for k, v in data[name].items()}


def _local_batch(batch, mesh, update_cycle):
    """The rank's part of a global batch: its rows over "data" (each
    micro-batch's rows under accumulation, as [update_cycle, B / (uc dp),
    ...])."""
    import numpy as np

    from neurst_tpu_torch.exps.trainer import split_microbatches
    from neurst_tpu_torch.parallel.utils import put_batch
    if update_cycle > 1:
        batch = split_microbatches(batch, update_cycle)
    return put_batch(mesh, {k: np.asarray(v) for k, v in batch.items()},
                     batch_axis=1 if update_cycle > 1 else 0)


def _full_flat(model, tensors, specs, mesh):
    """JAX-named float32 arrays of ``tensors`` gathered whole."""
    from neurst_tpu_torch.parallel.sharding import gather_tensors
    from neurst_tpu_torch.utils.param_bridge import state_dict_to_flat
    return state_dict_to_flat(model, gather_tensors(tensors, specs, mesh))


def run_step(sc, data):
    """Gradients of the first batch, then ``steps`` Adam steps, on the
    scenario's mesh."""
    import torch

    import neurst_tpu_torch
    from neurst_tpu_torch.optimizers.optimizers import create_optax_chain
    from neurst_tpu_torch.parallel import TrainState, make_train_step
    from neurst_tpu_torch.parallel.mesh import make_mesh
    from neurst_tpu_torch.parallel.sharding import (apply_mesh, make_norm_fn,
                                                    whole_model)
    from neurst_tpu_torch.utils.param_bridge import load_flat_params
    from neurst_tpu_torch.utils.rng import fold_in, make_key

    model = neurst_tpu_torch.build_model(
        sc["cfg"], src_meta=data["meta"], trg_meta=data["meta"],
        device="cpu")
    load_flat_params(model, data[sc["params"]])
    mesh = make_mesh(model_parallel=sc.get("tp", 1),
                     pipeline_parallel=sc.get("pp", 1))
    specs = apply_mesh(model, mesh)
    norm_fn = make_norm_fn(specs, mesh)
    tx = create_optax_chain(neurst_tpu_torch.build_optimizer(
        {"optimizer.class": "adam", "optimizer.params": data["opt"]}),
        data["lr"], clip_norm=1.0, norm_fn=norm_fn)
    crit = neurst_tpu_torch.build_criterion(
        {"criterion.class": "label_smoothed_cross_entropy",
         "criterion.params": {"label_smoothing": 0.1}})
    uc = sc.get("update_cycle", 1)
    step = make_train_step(model, crit, tx, update_cycle=uc, mesh=mesh,
                           norm_fn=norm_fn,
                           stage_local=frozenset(specs.owners))
    state = TrainState.create(dict(model.named_parameters()), tx)
    key = make_key(7) if sc.get("dropout") else None
    batches = [_local_batch(_batch_of(data, name), mesh, uc)
               for name in sc["batches"]]
    # the parameters this rank holds (a pipeline stage: its own layers)
    out = {"held": sorted(n for n, p in model.named_parameters()
                          if p.numel())}
    if sc.get("logits"):
        # the inference forward of the global batch, as the trainer's
        # validator runs it on a mesh
        with torch.no_grad(), whole_model(model, specs, mesh):
            out["logits"] = model(_batch_of(data, sc["batches"][0])).numpy()
    loss, _, grads = step.compute_grads(
        state.params, batches[0], None if key is None else fold_in(key, 0))
    out.update(loss=float(loss),
               grads=_full_flat(model, grads, specs, mesh), metrics=[])
    for batch in batches[:sc.get("steps", 2)]:
        state, metrics = step(state, batch, key)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
    out["params"] = _full_flat(model, state.params, specs, mesh)
    return out


def run_ring(sc, data):
    """ring_self_attention over the world on T shards: the output and the
    gradients of sum(out x cot), gathered along time."""
    import torch

    from neurst_tpu_torch.ops.ring_attention import ring_self_attention
    from neurst_tpu_torch.parallel import collectives
    group = torch.distributed.group.WORLD
    p, r = collectives.group_size(group), collectives.group_rank(group)
    inp = data[sc["inputs"]]
    t = inp["q"].shape[1] // p
    q, k, v = (torch.tensor(inp[n][:, r * t:(r + 1) * t],
                            requires_grad=True) for n in "qkv")
    out = ring_self_attention(q, k, v, group,
                              torch.tensor(inp["lengths"]), sc["causal"])
    cot = torch.tensor(inp["cot"][:, r * t:(r + 1) * t])
    (out * cot).sum().backward()
    return {name: collectives.all_gather(x.detach(), 1, group).numpy()
            for name, x in (("out", out), ("dq", q.grad), ("dk", k.grad),
                            ("dv", v.grad))}


SCENARIOS = {"step": run_step, "ring": run_ring}


def main(argv):
    import torch
    import torch.distributed as dist
    rank, world, port, work = int(argv[1]), int(argv[2]), argv[3], argv[4]
    import faulthandler
    faulthandler.dump_traceback_later(240, exit=True)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    results = {}
    for sc in inputs["scenarios"]:
        results[sc["id"]] = SCENARIOS[sc["kind"]](sc, inputs["data"])
        dist.barrier()
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(sys.argv)
