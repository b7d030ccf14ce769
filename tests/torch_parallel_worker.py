"""One rank of the port's parallel tests (not a test file): a gloo
process group on the CPU that runs a list of scenarios and writes what
each gives.

    python tests/torch_parallel_worker.py RANK WORLD PORT WORK

``WORK/inputs.pkl`` holds {"scenarios": [...], "data": {...}}; the rank
writes ``WORK/rank<RANK>.pkl`` ({scenario id: result}).  Imports torch
and the port only.  ``start_group`` / ``wait_group`` (for the tests)
start the ranks and collect their results: a failing rank fails the
group at once (the others are killed), and a group that runs past its
limit (240 s) fails; a rank that runs past 220 seconds dumps its stack
and exits.
"""

import contextlib
import os
import pickle
import socket
import subprocess
import sys
import time

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


def wait_all(procs, logs, timeout):
    """Waits for every process; as soon as one fails (or ``timeout``
    seconds pass) kills the others and raises with its log's tail."""
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        bad = next((i for i, rc in enumerate(codes)
                    if rc is not None and rc != 0), None)
        late = bad is None and time.monotonic() > deadline
        if bad is not None or late:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            i = bad if bad is not None else codes.index(None)
            with open(logs[i]) as f:
                raise RuntimeError(
                    f"{logs[i]} {'timed out' if late else 'failed'} "
                    f"({codes[i]}):\n{f.read()[-6000:]}")
        if all(rc == 0 for rc in codes):
            return
        time.sleep(0.2)


def wait_group(started, timeout=240):
    """Each rank's {scenario id: result} of a ``start_group``; raises
    with the first failing rank's log as soon as one fails."""
    work, procs = started
    wait_all(procs, [os.path.join(work, f"rank{r}.log")
                     for r in range(len(procs))], timeout)
    out = []
    for rank in range(len(procs)):
        with open(os.path.join(work, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def spawn_group(world, work, scenarios, data, timeout=240):
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


@contextlib.contextmanager
def _quantized(sc):
    """QAT (``sc["quant"]``, the global config) or int8 serving
    (``sc["int8"]``, the keyword arguments of ``set_int8_serving``) on
    while the scenario builds and runs its model; both off after."""
    from neurst_tpu_torch.layers.quantization import quant_layers as ql
    if sc.get("quant"):
        ql.global_init(True, **sc["quant"])
    if sc.get("int8") is not None:
        ql.set_int8_serving(True, **sc["int8"])
    try:
        yield
    finally:
        ql.global_init(False)
        ql.set_int8_serving(False)


def run_step(sc, data):
    """Gradients of the first batch, then ``steps`` Adam steps, on the
    scenario's mesh (under QAT with ``sc["quant"]``: the clips' L2 term
    added once a step)."""
    with _quantized(sc):
        return _run_step(sc, data)


def _run_step(sc, data):
    import torch

    import neurst_tpu_torch
    from neurst_tpu_torch.layers.quantization.quant_layers import \
        clip_l2_penalty
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
                           stage_local=frozenset(specs.owners),
                           extra_loss_fn=clip_l2_penalty
                           if sc.get("quant") else None)
    state = TrainState.create(dict(model.named_parameters()), tx)
    key = make_key(7) if sc.get("dropout") else None
    batches = [_local_batch(_batch_of(data, name), mesh, uc)
               for name in sc["batches"]]
    # the parameters this rank holds (a pipeline stage: its own layers)
    out = {"held": sorted(n for n, p in model.named_parameters()
                          if p.numel()),
           "experts": {n: tuple(p.shape) for n, p in model.named_parameters()
                       if "expert_dense" in n}}
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


def run_decode(sc, data):
    """Beam search of each batch on the scenario's data-parallel mesh (the
    rows sharded where they divide the data ranks, else every rank
    decodes them all), the experts serving the other ranks until every
    rank's search has ended; the hypotheses of every rank's rows in
    order."""
    import numpy as np

    import neurst_tpu_torch
    from neurst_tpu_torch.layers.moe import drain_experts
    from neurst_tpu_torch.parallel import collectives
    from neurst_tpu_torch.parallel.mesh import make_mesh
    from neurst_tpu_torch.parallel.sharding import apply_mesh
    from neurst_tpu_torch.parallel.utils import data_slice
    from neurst_tpu_torch.utils.param_bridge import load_flat_params

    model = neurst_tpu_torch.build_model(
        sc["cfg"], src_meta=data["meta"], trg_meta=data["meta"],
        device="cpu")
    load_flat_params(model, data[sc["params"]])
    mesh = make_mesh()
    apply_mesh(model, mesh)
    model.decode_mesh = mesh  # as the predict entry sets it
    search = neurst_tpu_torch.build_search_layer(
        {"search_method.class": "beam_search",
         "search_method.params": sc["search"]})
    search.set_model(model)
    out = {}
    for name in sc["batches"]:
        batch = {k: np.asarray(v) for k, v in data[name].items()
                 if k.startswith("src")}
        rows = batch["src"].shape[0]
        sharded = rows % mesh.shape["data"] == 0
        if sharded:
            sl = data_slice(rows, mesh)
            batch = {k: v[sl] for k, v in batch.items()}
        hyp, _ = search(batch)
        drain_experts(model)
        hyp = hyp.tolist()
        if sharded:
            hyp = [h for part in collectives.all_gather_object(
                hyp, mesh.group("data")) for h in part]
        out[name] = hyp
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


def run_orbax(sc, data):
    """The scenario's weights on its mesh saved as an orbax checkpoint at
    ``sc["dir"]``, each rank writing its hyperslabs; the store keys each
    rank wrote (none, and no store, for a rank that owns no chunk)."""
    import torch

    import neurst_tpu_torch
    from neurst_tpu_torch.parallel.mesh import make_mesh
    from neurst_tpu_torch.parallel.sharding import (apply_mesh,
                                                    checkpoint_leaves)
    from neurst_tpu_torch.utils.ocdbt import OcdbtReader
    from neurst_tpu_torch.utils.orbax_checkpoints import \
        save_checkpoint_orbax
    from neurst_tpu_torch.utils.param_bridge import load_flat_params

    model = neurst_tpu_torch.build_model(
        sc["cfg"], src_meta=data["meta"], trg_meta=data["meta"],
        device="cpu")
    load_flat_params(model, data[sc["params"]])
    mesh = make_mesh(model_parallel=sc.get("tp", 1),
                     pipeline_parallel=sc.get("pp", 1))
    specs = apply_mesh(model, mesh)
    leaves = checkpoint_leaves(model, dict(model.named_parameters()),
                               specs, mesh)
    rank = torch.distributed.get_rank()
    path = save_checkpoint_orbax(
        sc["dir"], 1, None, leaves=leaves, rank=rank,
        world=torch.distributed.get_world_size(),
        barrier=torch.distributed.barrier)
    store = os.path.join(path, f"ocdbt.process_{rank}")
    keys = OcdbtReader(store).keys() if os.path.isdir(store) else []
    return {"path": path, "keys": [k.decode() for k in keys]}


def run_a2a(sc, data):
    """``collectives.all_to_all`` of rank r's ``x + r`` (split dim 0, join
    dim 2) and the gradient of sum(out x (cot + 10 r))."""
    import torch

    from neurst_tpu_torch.parallel import collectives
    group = torch.distributed.group.WORLD
    n, r = collectives.group_size(group), collectives.group_rank(group)
    inp = data[sc["inputs"]]
    x = torch.tensor(inp["x"] + r, requires_grad=True)
    out = collectives.all_to_all(x, 0, 2, group)
    cot = torch.tensor(inp["cot"][:4 // n, :, :6 * n] + 10 * r)
    (out * cot).sum().backward()
    return {"out": out.detach().numpy(), "grad": x.grad.numpy()}


def run_int8_dense(sc, data):
    """A row-parallel ``Int8Dense`` over the world (its input columns and
    the kernel's cut to the rank's) in each int8 mode: its output, and
    the input absmax the static mode's calibration records."""
    import torch

    from neurst_tpu_torch.layers.quantization import quant_layers as ql
    from neurst_tpu_torch.parallel import collectives
    from neurst_tpu_torch.parallel.mesh import ShardSpec
    from neurst_tpu_torch.parallel.sharding import _set_dense, take_shard
    group = torch.distributed.group.WORLD
    n, r = collectives.group_size(group), collectives.group_rank(group)
    inp = data[sc["inputs"]]
    spec = ShardSpec(1, "model", 1)
    x = take_shard(torch.tensor(inp["x"]), ShardSpec(2, "model", 1), r, n)
    out = {}
    for mode, kwargs in sc["modes"].items():
        with _quantized({"int8": kwargs}):
            dense = ql.Int8Dense(*inp["kernel_q"].shape[::-1])
            with torch.no_grad():
                for name in ("kernel_q", "kernel_scale", "bias"):
                    getattr(dense, name).copy_(torch.tensor(inp[name]))
                if dense.act_scale is not None:
                    dense.act_scale.fill_(float(inp["act_scale"]))
                dense.kernel_q.data = take_shard(dense.kernel_q.data, spec,
                                                 r, n)
            _set_dense(dense, group, row=True)
            out[mode] = dense(x).numpy()
            if dense.act_scale is not None:
                ql.set_int8_calibration(True)
                with ql.recording_act_absmax(dense) as found:
                    dense(x)
                ql.set_int8_calibration(False)
                out["absmax"] = found[""]
    return out


def run_int8_calibration(sc, data):
    """Static int8 calibration of the scenario's model on its mesh (every
    rank runs the whole batches): the act scales by JAX name, and the
    local shapes of every ``kernel_q``."""
    import neurst_tpu_torch
    from neurst_tpu_torch.layers.quantization import quant_layers as ql
    from neurst_tpu_torch.parallel.mesh import make_mesh
    from neurst_tpu_torch.parallel.sharding import apply_mesh
    from neurst_tpu_torch.utils.param_bridge import state_dict_to_flat
    from neurst_tpu_torch.utils.param_policy import restore_inference_params
    with _quantized({"int8": {"activations": True,
                              "static_activation_scales": True}}):
        model = neurst_tpu_torch.build_model(
            sc["cfg"], src_meta=data["meta"], trg_meta=data["meta"],
            device="cpu")
        restore_inference_params(model, dict(data[sc["params"]]))
        apply_mesh(model, make_mesh(model_parallel=sc["tp"]))
        ql.calibrate_int8_act_scales(model, [
            _batch_of(data, name) for name in sc["batches"]])
        params = dict(model.named_parameters())
        return {"scales": state_dict_to_flat(model, {
            n: p for n, p in params.items() if n.endswith("act_scale")}),
            "shapes": {n: tuple(p.shape) for n, p in params.items()
                       if n.endswith("kernel_q")}}


def run_cli(sc, data):
    """``run_exp`` with ``sc["argv"]`` on the CPU over the world's ranks:
    the hypotheses and scores it returns."""
    from neurst_tpu_torch.cli import run_exp
    res = run_exp.cli_main(list(sc["argv"]) + ["--device", "cpu"])
    return {"hypotheses": res["hypotheses"], "scores": res["scores"]}


SCENARIOS = {"step": run_step, "ring": run_ring, "decode": run_decode,
             "a2a": run_a2a, "orbax": run_orbax, "int8_dense": run_int8_dense,
             "int8_calibration": run_int8_calibration, "cli": run_cli}


def main(argv):
    import torch
    import torch.distributed as dist
    rank, world, port, work = int(argv[1]), int(argv[2]), argv[3], argv[4]
    import faulthandler
    faulthandler.dump_traceback_later(220, exit=True)
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
