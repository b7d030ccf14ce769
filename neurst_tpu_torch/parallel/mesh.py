"""The rank mesh and the sharding rules (counterpart of
``neurst_tpu/parallel/mesh.py``).

``make_mesh(data, model, pipeline)`` lays the world's ranks out as
``reshape(dp, pp, tp)`` over the axes ("data", "stage", "model"), as the
JAX package lays out devices, with the same arithmetic and assertions,
and forms one process group per axis line: a rank's "data" group holds
the ranks that share its stage and model coordinates, and so on; its
"replica" group holds the ranks that share its data coordinate.  A size-1
axis has no group (``None``): every collective over it is the identity.

``LOGICAL_AXIS_RULES`` and ``logical_to_mesh_spec`` are the JAX
package's.  ``params_shardings(model, mesh)`` gives, for each of the
port's parameters, how it is split over the mesh in the port's own layout
(``nn.Linear`` kernels are [out, in], and the fused attention projections
stack q, k and v along their rows): a ``ShardSpec(dim, axis, blocks)``
splits ``dim`` into ``blocks`` equal blocks and each block into equal
parts over ``axis``, or None for a replicated parameter.  When a
dimension does not divide its axis the parameter is replicated, with a
warning, as in the JAX package.

The port shards the biases of the column-parallel projections with their
kernels (qkv / q / kv and the FFN's dense1); the JAX package keeps them
replicated and XLA slices them where they are used.  MoE experts are
split over "data" along their expert axis, as the JAX package maps
"expert" to "data" (their filter axis stays whole over "model", where the
JAX spec splits it too: each model rank holds its data rank's experts
whole).
"""

import logging
from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

__all__ = ["Mesh", "ShardSpec", "make_mesh", "LOGICAL_AXIS_RULES",
           "logical_to_mesh_spec", "params_shardings", "single_mesh"]

# logical axis name -> mesh axis (None = replicated)
LOGICAL_AXIS_RULES = (
    ("batch", "data"),
    ("vocab", "model"),
    ("embed", None),
    ("mlp", "model"),
    ("heads", "model"),
    ("head_dim", None),
    ("kv", None),
    ("conv_io", None),
    ("layers", None),
    ("stage", "stage"),
    ("expert", "data"),
    ("expert_logits", None),
)

AXES = ("data", "stage", "model")


class Mesh:
    """The ("data", "stage", "model") layout of the world's ranks, this
    rank's coordinates and one process group per axis line."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int],
                 groups: Dict[str, Optional[object]]):
        self.shape = dict(shape)
        self.coords = dict(coords)
        self.groups = dict(groups)

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["stage"] * self.shape["model"]

    def group(self, axis: str):
        return self.groups[axis]

    def __repr__(self):
        return (f"Mesh(data={self.shape['data']}, stage="
                f"{self.shape['stage']}, model={self.shape['model']}, "
                f"coords={self.coords})")


def single_mesh() -> Mesh:
    """The mesh of one rank."""
    return Mesh({a: 1 for a in AXES}, {a: 0 for a in AXES},
                {a: None for a in AXES + ("replica",)})


def make_mesh(data_parallel: Optional[int] = None, model_parallel: int = 1,
              pipeline_parallel: int = 1,
              world_size: Optional[int] = None) -> Mesh:
    """A ("data", "stage", "model") mesh over the world's ranks; "stage"
    and "model" have size 1 unless pipeline or tensor parallelism is on."""
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    n = world_size
    mp = model_parallel * pipeline_parallel
    if data_parallel is None:
        assert n % mp == 0, (
            f"{n} devices not divisible by "
            f"pp({pipeline_parallel}) x tp({model_parallel})")
        data_parallel = n // mp
    assert data_parallel * mp == n, (
        f"dp({data_parallel}) x pp({pipeline_parallel}) x "
        f"tp({model_parallel}) != devices({n})")
    shape = {"data": data_parallel, "stage": pipeline_parallel,
             "model": model_parallel}
    logging.info("Mesh: data=%d x stage=%d x model=%d over %d devices",
                 data_parallel, pipeline_parallel, model_parallel, n)
    if n == 1:
        return single_mesh()
    rank = dist.get_rank()
    grid = torch.arange(n).reshape(data_parallel, pipeline_parallel,
                                   model_parallel)
    d, s, m = [int(i) for i in (grid == rank).nonzero()[0]]
    coords = {"data": d, "stage": s, "model": m}
    # every rank forms every group, in one order; "replica" holds the
    # ranks that share this rank's data coordinate (they train on one
    # batch)
    groups = {"replica": None}
    if pipeline_parallel * model_parallel > 1:
        for line in grid.reshape(data_parallel, -1).tolist():
            group = dist.new_group(line)
            if rank in line:
                groups["replica"] = group
    for axis, lines in (
            ("data", grid.permute(1, 2, 0).reshape(-1, data_parallel)),
            ("stage", grid.permute(0, 2, 1).reshape(-1, pipeline_parallel)),
            ("model", grid.reshape(-1, model_parallel))):
        groups[axis] = None
        if shape[axis] == 1:
            continue
        for line in lines.tolist():
            group = dist.new_group(line)
            if rank in line:
                groups[axis] = group
    return Mesh(shape, coords, groups)


def logical_to_mesh_spec(logical_spec):
    """A logical spec (a tuple of logical axis names or None) -> the mesh
    axes through ``LOGICAL_AXIS_RULES``, as a tuple."""
    rules = dict(LOGICAL_AXIS_RULES)
    if logical_spec is None:
        return ()
    return tuple(None if ax is None else rules.get(ax)
                 for ax in logical_spec)


class ShardSpec(NamedTuple):
    """``dim`` of the port's tensor split into ``blocks`` equal blocks,
    each split equally over mesh axis ``axis``."""
    dim: int
    axis: str
    blocks: int = 1


# the port's sharded parameters by their last two name parts: (dim,
# logical axis, blocks) in the port's layout
_FUSED_BLOCKS = {"qkv_transform": 3, "q_transform": 1, "kv_transform": 2}
_EXPERT_LEAVES = ("expert_dense1_kernel", "expert_dense1_bias",
                  "expert_dense2_kernel", "expert_dense2_bias")


def _port_rule(name: str):
    parts = name.split(".")
    owner, leaf = (parts[-2] if len(parts) > 1 else ""), parts[-1]
    if owner in _FUSED_BLOCKS and leaf in ("weight", "bias"):
        return 0, "heads", _FUSED_BLOCKS[owner]
    if owner == "output_transform" and leaf == "weight":
        return 1, "heads", 1
    if owner == "dense1" and leaf in ("weight", "bias") \
            and "ffn" in parts[:-2]:
        return 0, "mlp", 1
    if owner == "dense2" and leaf == "weight" and "ffn" in parts[:-2]:
        return 1, "mlp", 1
    if leaf in _EXPERT_LEAVES:
        return 0, "expert", 1
    if owner.endswith("symbol_modality") and leaf == "weights":
        return 0, "vocab", 1
    if owner == "output_linear" and leaf == "weight":
        return 0, "vocab", 1
    return None


def params_shardings(model: torch.nn.Module, mesh: Mesh
                     ) -> Dict[str, Optional[ShardSpec]]:
    """{port parameter name: ShardSpec or None (replicated)} on
    ``mesh``.  A dimension its axis does not divide is replicated, with a
    warning."""
    rules = dict(LOGICAL_AXIS_RULES)
    out = {}
    for name, p in model.named_parameters():
        rule = _port_rule(name)
        spec = None
        if rule is not None:
            dim, logical, blocks = rule
            axis = rules[logical]
            size = mesh.shape.get(axis, 1) if axis else 1
            if axis is not None and size > 1:
                if p.shape[dim] % (blocks * size):
                    logging.warning(
                        "Replicating param %s with shape %s: %s does not "
                        "divide its mesh axis %s (%d)", name,
                        tuple(p.shape), logical, axis, size)
                else:
                    spec = ShardSpec(dim, axis, blocks)
        out[name] = spec
    return out
