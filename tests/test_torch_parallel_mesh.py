"""The port's cluster bootstrap, mesh, sharding rules and batch placement
against the JAX package's, and the two repairs of the pipeline's model
flags and checkpoint layout.

* ``resolve_cluster`` case by case with the JAX package's (the same
  inputs, the same errors), plus torchrun's environment and
  ``LOCAL_WORLD_SIZE`` / ``LOCAL_RANK``;
* ``make_mesh``'s arithmetic and assertions; ``LOGICAL_AXIS_RULES`` and
  ``logical_to_mesh_spec``;
* ``params_shardings`` for ``transformer_base``, ``speech_transformer_s``
  and a Switch MoE transformer against the JAX ``params_shardings`` of
  ``model.params_spec()`` on a 2-way "model" axis, name by name, in the
  port's layout (the fused projections and transposed kernels move the
  sharded dimension); where the port differs on purpose (the
  column-parallel biases sharded with their kernels, the experts
  replicated) the test says so;
* ``put_batch`` and the backend rule;
* repair 1: ``unstack_scan_layers`` reads the JAX pipeline layout
  ``<stack>/layers/pipeline/stages/layers/layer/`` [S, P, ...] as the JAX
  package's ``_bridge_scan_layouts`` does (stage s, layer j -> layer
  s * P + j);
* repair 2: ``pipeline_stages`` > 1 builds the pipelined stacks (kept by
  ``run_exp`` for training, stripped for the other entries) and raises
  the JAX package's errors with MoE, flash and ring attention.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import port_test_support  # noqa: E402,F401  (one torch thread per worker)
import neurst_tpu_torch  # noqa: E402
from neurst_tpu.models.model import build_model as jax_build  # noqa: E402
from neurst_tpu.parallel import cluster as jax_cluster  # noqa: E402
from neurst_tpu.parallel import mesh as jax_mesh  # noqa: E402
from neurst_tpu.utils.checkpoints import (  # noqa: E402
    _bridge_scan_layouts, flatten_params)
from neurst_tpu.utils.hparams_sets import \
    get_hyper_parameters as jax_hparams  # noqa: E402
from neurst_tpu_torch.parallel import cluster  # noqa: E402
from neurst_tpu_torch.parallel import collectives  # noqa: E402
from neurst_tpu_torch.parallel.mesh import (  # noqa: E402
    LOGICAL_AXIS_RULES, Mesh, ShardSpec, logical_to_mesh_spec, make_mesh,
    params_shardings)
from neurst_tpu_torch.parallel.sharding import (join_shards,  # noqa: E402
                                                take_shard)
from neurst_tpu_torch.parallel.utils import put_batch  # noqa: E402
from neurst_tpu_torch.utils.param_bridge import (  # noqa: E402
    load_flat_params, to_jax_name, unstack_scan_layers)

META = {"vocab_size": 64, "eos_id": 1, "bos_id": 2, "unk_id": 3}

CLUSTER_CASES = [
    ({"env": {}}, {}),
    ({"worker_hosts": "a:1,b:2", "task_index": 1,
      "env": {"WORKER_HOSTS": "x:9,y:9", "TASK_ID": "0"}}, ("a:1", 2, 1)),
    ({"env": {"WORKER_HOSTS": "h1:1234,h2:1234,h3:1234", "TASK_ID": "2"}},
     ("h1:1234", 3, 2)),
    ({"env": {"WORKER_HOSTS": "solo:555"}}, ("solo:555", 1, 0)),
    ({"worker_hosts": "bare-host", "env": {}}, ("bare-host:8476", 1, 0)),
]


@pytest.mark.parametrize("kwargs,want", CLUSTER_CASES)
def test_resolve_cluster_matches_jax(kwargs, want):
    got = cluster.resolve_cluster(**kwargs)
    ref = jax_cluster.resolve_cluster(**kwargs)
    if not want:
        assert got == {} and ref == {}
        return
    address, processes, index = want
    assert ref == {"coordinator_address": address,
                   "num_processes": processes, "process_id": index}
    assert got == {"init_method": f"tcp://{address}",
                   "world_size": processes, "rank": index}


@pytest.mark.parametrize("kwargs,match", [
    ({"env": {"WORKER_HOSTS": "a:1,b:2"}}, "task_index"),
    ({"worker_hosts": "a:1,b:2", "task_index": 5, "env": {}},
     "out of range")])
def test_resolve_cluster_errors_match_jax(kwargs, match):
    for resolve in (cluster.resolve_cluster, jax_cluster.resolve_cluster):
        with pytest.raises(ValueError, match=match):
            resolve(**kwargs)


def test_local_processes_and_torchrun_environment():
    """A host runs LOCAL_WORLD_SIZE processes (rank = task x local +
    LOCAL_RANK); without a spec torchrun's environment is read, and one
    process forms no group."""
    got = cluster.resolve_cluster(
        "a:1,b:2", 1, env={"LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "3"})
    assert got == {"init_method": "tcp://a:1", "world_size": 8, "rank": 7}
    env = {"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1",
           "MASTER_ADDR": "m", "MASTER_PORT": "29500"}
    assert cluster.resolve_cluster(env=env) == {
        "init_method": "tcp://m:29500", "world_size": 8, "rank": 5}
    assert cluster.resolve_cluster(env={"WORLD_SIZE": "1"}) == {}
    assert cluster.local_rank({"LOCAL_RANK": "3"}) == 3


def test_backend_rule():
    """nccl where every local rank has a card of its own, else gloo."""
    assert collectives.choose_backend("cuda", 1, 1) == "nccl"
    assert collectives.choose_backend("cuda:0", 4, 8) == "nccl"
    assert collectives.choose_backend("cuda:0", 2, 1) == "gloo"
    assert collectives.choose_backend("cpu", 1, 0) == "gloo"


@pytest.mark.parametrize("n,dp,tp,pp", [(8, None, 2, 1), (8, None, 2, 2),
                                        (8, 2, 2, 2), (1, None, 1, 1)])
def test_mesh_shapes(n, dp, tp, pp):
    ref = jax_mesh.make_mesh(dp, tp, pp, devices=jax.devices()[:n])
    if n == 1:
        mesh = make_mesh(dp, tp, pp, world_size=1)
        assert mesh.shape == dict(ref.shape)
        assert all(g is None for g in mesh.groups.values())
        return
    # the arithmetic, without forming groups: the JAX shape
    assert dict(ref.shape)["data"] * tp * pp == n


@pytest.mark.parametrize("n,dp,tp,pp", [(8, None, 3, 1), (8, 3, 2, 1)])
def test_mesh_assertions_match_jax(n, dp, tp, pp):
    with pytest.raises(AssertionError) as ref:
        jax_mesh.make_mesh(dp, tp, pp, devices=jax.devices()[:n])
    with pytest.raises(AssertionError) as got:
        make_mesh(dp, tp, pp, world_size=n)
    assert str(got.value) == str(ref.value)


def test_logical_rules_match_jax():
    assert LOGICAL_AXIS_RULES == jax_mesh.LOGICAL_AXIS_RULES
    for spec in [("embed", None, "heads", "head_dim"), ("vocab", "embed"),
                 ("mlp", "embed"), ("expert", "embed", "mlp"), None]:
        ref = jax_mesh.logical_to_mesh_spec(spec)
        assert logical_to_mesh_spec(spec) == tuple(ref)


def _expected_port_spec(jax_name, jax_axes, shape, port_shape):
    """The port's ShardSpec of a JAX parameter sharded as ``jax_axes``
    (mesh axes per JAX dim), in the port's layout."""
    sharded = [i for i, ax in enumerate(jax_axes) if ax == "model"]
    if not sharded:
        return None
    (dim,) = sharded
    parts = jax_name.split("/")
    owner = parts[-2]
    if owner in ("qkv_transform", "q_transform", "kv_transform"):
        return ShardSpec(0, "model", shape[1])
    if owner == "output_transform":
        return ShardSpec(1, "model", 1)
    if len(shape) == 2 and parts[-1] == "kernel":
        return ShardSpec(1 - dim, "model", 1)
    assert len(port_shape) == len(shape)
    return ShardSpec(dim, "model", 1)


def _model_pair(name, overrides=None):
    cfg = jax_hparams(name)
    cfg["model.params"] = dict(cfg["model.params"], **(overrides or {}))
    kwargs = {"trg_meta": META}
    if "speech" not in name:
        kwargs["src_meta"] = META
    jm = jax_build(cfg, **kwargs)
    # the port's shapes alone: no memory for a full-width model
    pm = neurst_tpu_torch.build_model(cfg, device="meta", **kwargs)
    return jm, pm


@pytest.mark.parametrize("name,overrides", [
    ("transformer_base", None),
    ("speech_transformer_s", None),
    ("transformer_toy", {"encoder.moe_num_experts": 4,
                         "decoder.moe_num_experts": 4,
                         "modality.dim": 16, "encoder.hidden_size": 16,
                         "decoder.hidden_size": 16})],
    ids=["transformer_base", "speech_transformer_s", "switch_moe"])
def test_params_shardings_match_jax(name, overrides):
    jm, pm = _model_pair(name, overrides)
    # 2 data x 2 model devices: the experts split over "data"
    mesh_ref = jax_mesh.make_mesh(model_parallel=2,
                                  devices=jax.devices()[:4])
    shapes = jax.eval_shape(lambda: jm._module.init(
        {"params": jax.random.PRNGKey(0)}, **jm.example_inputs()))
    from flax import linen as nn
    shapes = nn.meta.unbox(shapes["params"])
    ref = flatten_params(jax_mesh.params_shardings(
        mesh_ref, jm.params_spec(), shapes))
    jshapes = {k: tuple(v.shape) for k, v in flatten_params(shapes).items()}
    mesh = Mesh({"data": 2, "stage": 1, "model": 2},
                {"data": 0, "stage": 0, "model": 0},
                {"data": None, "stage": None, "model": None})
    got = params_shardings(pm, mesh)
    pshapes = {n: tuple(p.shape) for n, p in pm.named_parameters()}
    assert sorted(to_jax_name(n) for n in got) == sorted(ref)
    differs = []
    for port_name, spec in got.items():
        jname = to_jax_name(port_name)
        axes = tuple(ref[jname].spec) + (None,) * (
            len(jshapes[jname]) - len(ref[jname].spec))
        want = _expected_port_spec(jname, axes, jshapes[jname],
                                   pshapes[port_name])
        if "/expert_dense" in jname:
            # the expert axis over "data", as JAX's; the port keeps the
            # filter axis whole over "model", where JAX splits it
            assert axes[0] == "data", jname
            assert spec == ShardSpec(0, "data", 1), jname
            continue
        if want != spec:
            differs.append(jname)
            # the one difference on purpose: a column-parallel bias
            # sharded with its kernel
            kernel = jname[:-len("bias")] + "kernel"
            assert jname.endswith("/bias") and want is None, jname
            assert spec == _expected_port_spec(
                kernel, tuple(ref[kernel].spec), jshapes[kernel],
                pshapes[port_name[:-len("bias")] + "weight"]), jname
    assert all(n.endswith(("qkv_transform/bias", "q_transform/bias",
                           "kv_transform/bias", "dense1/bias"))
               for n in differs)


def test_params_shardings_replicates_what_does_not_divide(caplog):
    """A vocabulary of 33 on a 2-way model axis stays whole, with a
    warning, as the JAX package's fallback does."""
    cfg = jax_hparams("transformer_toy")
    meta = dict(META, vocab_size=33)
    pm = neurst_tpu_torch.build_model(cfg, src_meta=meta, trg_meta=meta,
                                      device="cpu")
    mesh = Mesh({"data": 1, "stage": 1, "model": 2},
                {"data": 0, "stage": 0, "model": 0},
                {"data": None, "stage": None, "model": None})
    specs = params_shardings(pm, mesh)
    assert specs["target_symbol_modality.weights"] is None
    assert "Replicating" in caplog.text
    assert specs["encoder.layer_0.ffn.dense1.weight"] == ShardSpec(
        0, "model", 1)


@pytest.mark.parametrize("spec,shape", [
    (ShardSpec(0, "model", 3), (12, 5)), (ShardSpec(1, "model", 1), (3, 8)),
    (ShardSpec(0, "model", 1), (8,))])
def test_take_and_join_shards(spec, shape):
    t = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    parts = [take_shard(t, spec, r, 2) for r in range(2)]
    assert torch.equal(join_shards(parts, spec), t)
    if spec.blocks == 3:
        # each block (q, k, v) keeps this rank's half of its rows
        assert torch.equal(parts[1][:2], t[2:4])


def test_put_batch():
    """The rank's rows along ``batch_axis`` over "data"; object fields
    dropped; arrays of ndim <= batch_axis replicated."""
    mesh = Mesh({"data": 2, "stage": 1, "model": 2},
                {"data": 1, "stage": 0, "model": 1},
                {"data": None, "stage": None, "model": None})
    batch = {"a": np.arange(8).reshape(4, 2), "s": np.array(["x"] * 4,
                                                            dtype=object),
             "lag": np.array(3), "m": np.arange(12).reshape(2, 6)}
    out = put_batch(mesh, batch)
    assert sorted(out) == ["a", "lag", "m"]
    assert out["a"].tolist() == [[4, 5], [6, 7]]
    assert int(out["lag"]) == 3
    out = put_batch(mesh, batch, batch_axis=1)
    assert out["m"].tolist() == [[3, 4, 5], [9, 10, 11]]
    assert out["a"].tolist() == [[1], [3], [5], [7]]


PIPE = {"encoder.pipeline_stages": 2, "decoder.pipeline_stages": 2,
        "encoder.pipeline_microbatches": 2,
        "decoder.pipeline_microbatches": 2}


def test_bridge_reads_the_pipeline_layout():
    """The JAX pipelined model's [S, P, ...] leaves unstack to the names
    and values ``_bridge_scan_layouts`` gives its per-layer target, and
    fill every port parameter."""
    cfg = jax_hparams("transformer_toy")
    cfg["model.params"] = dict(cfg["model.params"], **{
        "encoder.num_layers": 4, "decoder.num_layers": 4, **PIPE})
    jm = jax_build(cfg, src_meta=META, trg_meta=META)
    flat = {k: np.asarray(v) for k, v in
            flatten_params(jm.init_params(jax.random.PRNGKey(0))).items()}
    assert any("/layers/pipeline/stages/layers/layer/" in k for k in flat)
    cfg_seq = jax_hparams("transformer_toy")
    cfg_seq["model.params"] = dict(cfg_seq["model.params"], **{
        "encoder.num_layers": 4, "decoder.num_layers": 4})
    target = flatten_params(jax.eval_shape(
        lambda: jax_build(cfg_seq, src_meta=META, trg_meta=META)
        .init_params(jax.random.PRNGKey(1))))
    ref = {k: v for k, v in _bridge_scan_layouts(flat, target).items()
           if k in target}
    got = unstack_scan_layers(flat)
    assert sorted(got) == sorted(ref)
    for name, value in ref.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    pm = neurst_tpu_torch.build_model(cfg_seq, src_meta=META, trg_meta=META,
                                      device="cpu")
    load_flat_params(pm, flat)


def test_pipeline_flags_build_the_pipelined_stacks():
    cfg = jax_hparams("transformer_toy")
    cfg["model.params"] = dict(cfg["model.params"], **PIPE)
    pm = neurst_tpu_torch.build_model(cfg, src_meta=META, trg_meta=META,
                                      device="cpu")
    assert pm.encoder.pipeline_stages == 2
    assert pm.decoder.pipeline_stages == 2
    assert pm.decoder.pipeline_microbatches == 2


@pytest.mark.parametrize("extra", [
    {"encoder.moe_num_experts": 4}, {"decoder.moe_num_experts": 4},
    {"encoder.enable_flash_attention": True},
    {"encoder.enable_ring_attention": True},
    {"decoder.enable_flash_attention": True}],
    ids=["encoder_moe", "decoder_moe", "encoder_flash", "encoder_ring",
         "decoder_flash"])
def test_pipeline_errors_match_jax(extra):
    cfg = jax_hparams("transformer_toy")
    cfg["model.params"] = dict(cfg["model.params"], **PIPE, **extra)
    with pytest.raises(ValueError) as ref:
        jax_build(cfg, src_meta=META, trg_meta=META).init_params(
            jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as got:
        neurst_tpu_torch.build_model(cfg, src_meta=META, trg_meta=META,
                                     device="cpu")
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("entry,stages", [("train", 2), ("predict", 1)])
def test_run_exp_keeps_the_pipeline_for_training_only(monkeypatch, entry,
                                                      stages):
    from neurst_tpu_torch.cli import run_exp
    from neurst_tpu_torch.exps.sequence_generator import SequenceGenerator
    from neurst_tpu_torch.exps.trainer import Trainer
    seen = {}

    def capture(self):
        seen["model"] = self._model

    monkeypatch.setattr(Trainer, "run", capture)
    monkeypatch.setattr(SequenceGenerator, "run", capture)
    params = ",".join(f"{k}: {v}" for k, v in PIPE.items())
    run_exp.cli_main([
        "--entry", entry, "--device", "cpu", "--config_paths",
        "tests/examples/example_train_seq2seq.yml", "--model.params",
        "{" + params + "}"])
    assert seen["model"].encoder.pipeline_stages == stages
    assert seen["model"].decoder.pipeline_stages == stages


def test_r16_a_rank_batches_its_shard_at_batch_size():
    """R16: each data rank batches its own shard at ``batch_size`` (what
    the JAX flag calls the global size), exactly as a JAX process of a
    multi-process run does, so two ranks' step holds both shards' batches:
    twice ``batch_size`` tokens."""
    import yaml

    from neurst_tpu.tasks import build_task as jax_build_task
    from neurst_tpu.data.datasets import build_dataset as jax_build_dataset
    from neurst_tpu.utils.compat import ModeKeys as JaxModeKeys
    from neurst_tpu_torch.data.datasets.dataset import build_dataset
    from neurst_tpu_torch.tasks.task import build_task
    from neurst_tpu_torch.utils.compat import ModeKeys
    with open("tests/examples/example_train_seq2seq.yml") as f:
        cfg = yaml.safe_load(f)
    cfg["task.params"]["shuffle_buffer"] = 0
    tokens = {}
    for shard in range(2):
        got = list(build_task(cfg).create_batch_iterator(
            build_dataset(cfg), ModeKeys.TRAIN, num_replicas_in_sync=2,
            shard_id=shard, total_shards=2)())
        ref = list(jax_build_task(cfg).create_batch_iterator(
            jax_build_dataset(cfg), JaxModeKeys.TRAIN,
            num_replicas_in_sync=2, shard_id=shard, total_shards=2)())
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            for key in ("src", "trg"):
                np.testing.assert_array_equal(g[key], r[key])
        tokens[shard] = [int((b["src"] > 0).sum()) for b in got]
    whole = [int((b["src"] > 0).sum()) for b in build_task(cfg)
             .create_batch_iterator(build_dataset(cfg), ModeKeys.TRAIN)()]
    # a two-rank step holds about twice one process's batch
    steps = min(len(tokens[0]), len(tokens[1]))
    per_step = np.mean([tokens[0][i] + tokens[1][i] for i in range(steps)])
    assert 1.6 < per_step / np.mean(whole) < 2.4
