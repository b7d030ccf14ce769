"""Puts a model on a mesh: tensor-parallel shards, pipeline and ring
groups, and the gathers and slices that carry whole tensors (checkpoints,
optimizer sidecars) to and from the shards.

``apply_mesh(model, mesh)`` (the port's counterpart of the JAX trainer's
``params_shardings`` + ``device_put``) hands the "stage" group to every
pipelined stack, the ring axis's group to every ring-attention encoder,
the "data" group to every MoE layer (its balance loss; with E divisible
by the data ranks its experts are cut to the rank's E / dp and the layer
dispatches over the group) and, with a "model" axis, cuts each parameter that ``params_shardings``
shards to this rank's part and tells its module (the attention layers
their local heads, the FFNs their filter columns, the word embeddings
their vocabulary rows, an untied softmax its columns, and each quantized
dense of these the model group and whether it is row-parallel).  Over a "stage"
axis of several ranks each layer of a pipelined stack stays on the ranks
of the stage that runs it (the others hold an empty tensor in its place,
and so do its optimizer moments), as the JAX package shards its
``[S, P, ...]`` stacks over "stage"; the embeddings, the output layer
norms and every stack that is not pipelined stay on every stage.  It
returns a ``Placement``: the shard specs by parameter name and the
layers' stages.

``gather_tensors`` rebuilds whole tensors from the shards (over "model"
or, for the experts, "data") and the stages
(every rank takes part; checkpoints are written from rank 0 under the
single-rank names, which the JAX package reads), and ``shard_tensors``
cuts whole tensors (a restored checkpoint, a moment of the optimizer
sidecar) to this rank's part.  ``whole_model`` gives every rank every
layer and whole sequences for an inference forward (the trainer's
validator).  ``make_norm_fn`` is the global gradient norm over the shards
and the stages.  ``checkpoint_leaves`` gives the orbax leaves of a
tree of local tensors: each rank writes the hyperslabs of the JAX-layout
arrays that its shards are.
"""

import contextlib
import logging
from typing import Dict, List, Optional

import torch

from neurst_tpu_torch.layers.attentions.multi_head_attention import \
    MultiHeadAttention
from neurst_tpu_torch.layers.common_layers import (TransformerFFN,
                                                   WordEmbedding)
from neurst_tpu_torch.layers.decoders.transformer_decoder import \
    TransformerDecoder
from neurst_tpu_torch.layers.encoders.transformer_encoder import \
    TransformerEncoder
from neurst_tpu_torch.layers.moe import MoeFFN
from neurst_tpu_torch.layers.quantization.quant_layers import (Int8Dense,
                                                              QuantDense)
from neurst_tpu_torch.optimizers.optimizers import global_norm
from neurst_tpu_torch.parallel import collectives
from neurst_tpu_torch.parallel.mesh import ShardSpec, params_shardings
from neurst_tpu_torch.utils.orbax_checkpoints import Leaf
from neurst_tpu_torch.utils.param_bridge import (jax_layout,
                                                 state_dict_to_flat)
from neurst_tpu_torch.utils.zarr import zarr_dtype

__all__ = ["Placement", "apply_mesh", "take_shard", "join_shards",
           "gather_tensors", "shard_tensors", "whole_model", "make_norm_fn",
           "pipelined", "data_sharded", "checkpoint_leaves"]


class Placement(dict):
    """{parameter name: ShardSpec or None} of the tensor-parallel shards,
    and ``owners``: {name: (stage coordinate, shape on its stage)} of the
    pipelined stacks' layers, each held by the ranks of its stage
    alone."""

    def __init__(self, specs, owners=None):
        super().__init__(specs)
        self.owners = dict(owners or {})


def _blocked(shape, spec: ShardSpec):
    d = spec.dim
    return shape[:d] + [spec.blocks, shape[d] // spec.blocks] + shape[d + 1:]


def take_shard(t: torch.Tensor, spec: Optional[ShardSpec], coord: int,
               n: int) -> torch.Tensor:
    """Part ``coord`` of ``n`` of a whole tensor under ``spec``."""
    if spec is None or n == 1:
        return t
    shape = list(t.shape)
    per = shape[spec.dim] // spec.blocks // n
    v = t.reshape(_blocked(shape, spec)).narrow(spec.dim + 1, coord * per,
                                                per)
    shape[spec.dim] = spec.blocks * per
    return v.reshape(shape).contiguous()


def join_shards(parts, spec: ShardSpec) -> torch.Tensor:
    """The whole tensor of its parts (in rank order) under ``spec``."""
    blocked = [p.reshape(_blocked(list(p.shape), spec)) for p in parts]
    whole = torch.cat(blocked, dim=spec.dim + 1)
    shape = list(parts[0].shape)
    shape[spec.dim] *= len(parts)
    return whole.reshape(shape)


def _model_axis(mesh):
    return _axis(mesh, "model")


def _axis(mesh, axis):
    return (mesh.group(axis), mesh.coords[axis], mesh.shape[axis])


def _axis_of(spec) -> Optional[str]:
    return None if spec is None else spec.axis


def data_sharded(specs) -> frozenset:
    """The names of the parameters split over "data" (the experts)."""
    return frozenset(n for n, s in specs.items() if _axis_of(s) == "data")


def _owners(specs) -> dict:
    return getattr(specs, "owners", {})


def _from_stage(t: torch.Tensor, name: str, specs, mesh) -> torch.Tensor:
    """A pipeline layer's tensor from the ranks of its stage (every rank
    of the stage group gets it); any other tensor as it is."""
    owner = _owners(specs).get(name)
    if owner is None:
        return t
    stage, shape = owner
    buf = t.detach().contiguous() if mesh.coords["stage"] == stage \
        else t.new_empty(shape)
    return collectives.broadcast(buf, stage, mesh.group("stage"))


def gather_tensors(tensors: Dict[str, torch.Tensor], specs, mesh
                   ) -> Dict[str, torch.Tensor]:
    """Whole tensors of {name: local tensor} (every rank calls it with the
    same names; each gets the whole)."""
    out = {}
    for name, t in tensors.items():
        t = _from_stage(t, name, specs, mesh)
        spec = specs.get(name)
        if spec is None or mesh.shape[spec.axis] == 1:
            out[name] = t
            continue
        parts = collectives.all_gather(t.detach().contiguous()[None], 0,
                                       mesh.group(spec.axis))
        out[name] = join_shards(list(parts), spec)
    return out


def shard_tensors(tensors: Dict[str, torch.Tensor], specs, mesh
                  ) -> Dict[str, torch.Tensor]:
    """This rank's parts of {name: whole tensor} (an empty tensor for a
    pipeline layer of another stage)."""
    owners = _owners(specs)
    out = {}
    for name, t in tensors.items():
        spec = specs.get(name)
        if name in owners and owners[name][0] != mesh.coords["stage"]:
            out[name] = t.new_empty(0)
        elif spec is None:
            out[name] = t
        else:
            out[name] = take_shard(t, spec, mesh.coords[spec.axis],
                                   mesh.shape[spec.axis])
    return out


@contextlib.contextmanager
def whole_model(model: torch.nn.Module, specs, mesh):
    """While the block runs, every rank holds every pipeline layer (of
    its model shard) and every expert, and each ring encoder and MoE layer
    runs over its rank alone: an inference forward (the trainer's
    validator) runs every layer over whole sequences.  The placement
    comes back after it (every rank enters)."""
    owners = _owners(specs)
    experts = data_sharded(specs)
    params = dict(model.named_parameters())
    held = {name: params[name].data for name in set(owners) | experts}
    rings = [m for m in model.modules() if isinstance(m, TransformerEncoder)]
    groups = [m.ring_group for m in rings]
    moes = [m for m in model.modules() if isinstance(m, MoeFFN)]
    moe_groups = [m.ep_group for m in moes]
    try:
        with torch.no_grad():
            for name in owners:
                params[name].data = _from_stage(held[name], name, specs,
                                                mesh)
            whole = gather_tensors({n: held[n] for n in sorted(experts)},
                                   specs, mesh)
            for name, t in whole.items():
                params[name].data = t
        for m in rings:
            m.ring_group = None
        for m in moes:
            m.ep_group = None
        yield
    finally:
        for name, t in held.items():
            params[name].data = t
        for m, group in zip(rings, groups):
            m.ring_group = group
        for m, group in zip(moes, moe_groups):
            m.ep_group = group


def make_norm_fn(specs, mesh):
    """The global norm of a {name: gradient} tree whose sharded entries
    are this rank's parts and whose pipeline layers are its stage's:
    their squares are summed over the model group (the data group for the
    experts) and the stage group, the replicated entries counted once
    (None on a mesh with none of these)."""
    owners = _owners(specs)
    axes = (None, "model", "data")
    if mesh.shape["model"] == 1 and not owners and not data_sharded(specs):
        return None

    def norm_fn(tree):
        # squares of [stage-shared, stage-local] x [replicated, over
        # "model", over "data"]
        device = next(iter(tree.values())).device
        sq = torch.zeros((2, 3), dtype=torch.float32, device=device)
        for local in (0, 1):
            for col, axis in enumerate(axes):
                part = [g for k, g in tree.items()
                        if (k in owners) == local
                        and _axis_of(specs.get(k)) == axis]
                if part:
                    sq[local, col] = global_norm(dict(enumerate(part))) ** 2
        sharded = collectives.all_reduce(sq[:, 1].clone(),
                                         mesh.group("model")) \
            + collectives.all_reduce(sq[:, 2].clone(), mesh.group("data"))
        stage_sum = collectives.all_reduce(
            (sharded[1] + sq[1, 0]).clone(), mesh.group("stage")
            if owners else None)
        return torch.sqrt(stage_sum + sharded[0] + sq[0, 0])

    return norm_fn


def checkpoint_leaves(model, tensors: Dict[str, torch.Tensor], specs,
                      mesh) -> List[Leaf]:
    """The orbax leaves of {port name: this rank's tensor}, under the JAX
    package's names and layouts (every rank calls it).  A tensor split
    over "model" or "data" is chunked as its shards are: the rank of each
    shard whose other coordinates are 0 writes its own shard, a hyperslab
    of the JAX-layout array.  A replicated tensor, a column-parallel bias
    (which the JAX spec keeps whole: it is gathered) and a pipeline layer
    are one chunk, written by one rank (of the layer's stage)."""
    owners = _owners(specs)
    out = []
    for name, t in tensors.items():
        spec = specs.get(name)
        stage = owners[name][0] if name in owners else 0
        held = name not in owners or mesh.coords["stage"] == stage
        if _axis_of(spec) == "model" and name.endswith("bias"):
            t, spec, held = gather_tensors({name: t}, specs, mesh)[name], \
                None, True
        n = 1 if spec is None else mesh.shape[spec.axis]
        # the rank's part (of a layer of another stage: the stage's)
        part = list(t.shape if held else owners[name][1])
        whole = list(part)
        if n > 1:
            whole[spec.dim] *= n
        jax_name, shape = jax_layout(model, name, whole)
        chunks = jax_layout(model, name, part, shard=n > 1)[1]
        split = [a for a in range(len(shape)) if chunks[a] != shape[a]]
        if len(split) != (n > 1) or any(chunks[a] * n != shape[a]
                                        for a in split):
            raise ValueError(f"{name}: a part {part} is no hyperslab of "
                             f"the JAX layout {shape}")
        index = [0] * len(shape)
        for a in split:
            index[a] = mesh.coords[spec.axis]
        others = {a: c for a, c in mesh.coords.items()
                  if spec is None or a != spec.axis}
        writes = others.pop("stage") == stage and not any(others.values())
        blocks = {}
        if writes:
            blocks[tuple(index)] = state_dict_to_flat(
                model, {name: t}, shards=n > 1)[jax_name]
        dtype = torch.float32 if t.is_floating_point() else t.dtype
        out.append(Leaf(tuple(jax_name.split("/")), shape,
                        zarr_dtype(torch.empty(0, dtype=dtype).numpy()),
                        chunks, blocks))
    return out


def pipelined(model) -> bool:
    """Whether a stack of ``model`` runs as a pipeline in training."""
    return any(getattr(m, "pipeline_stages", 1) > 1
               for m in model.modules()
               if isinstance(m, (TransformerEncoder, TransformerDecoder)))


def _set_dense(layer, group, row: bool):
    """Tells a dense cut to this rank's output rows (column-parallel) or
    input columns (``row``) its local features, and a quantized dense
    also the model group and its form."""
    kernel = layer.kernel_q if isinstance(layer, Int8Dense) else layer.weight
    layer.out_features, layer.in_features = kernel.shape
    if isinstance(layer, (QuantDense, Int8Dense)):
        layer.tp_group, layer.row_parallel = group, row


def _stage_layers(model, mesh) -> Dict[str, int]:
    """{parameter name: stage coordinate} of the pipelined stacks' layers
    over a "stage" axis of several ranks (rank g runs layers
    [g L / G, (g + 1) L / G))."""
    stages = mesh.shape["stage"]
    out = {}
    if stages == 1:
        return out
    for prefix, module in model.named_modules():
        if not isinstance(module, (TransformerEncoder, TransformerDecoder)) \
                or module.pipeline_stages == 1:
            continue
        for i in range(module.num_layers):
            layer = getattr(module, f"layer_{i}")
            for name, _ in layer.named_parameters():
                out[f"{prefix}.layer_{i}.{name}".lstrip(".")] = \
                    i * stages // module.num_layers
    return out


def apply_mesh(model: torch.nn.Module, mesh) -> Placement:
    """Puts ``model`` (whole, on its device) on ``mesh``; returns the
    shard specs by parameter name (None: replicated) and the pipeline
    layers' stages."""
    stage = mesh.group("stage")
    for module in model.modules():
        if isinstance(module, (TransformerEncoder, TransformerDecoder)):
            module.stage_group = stage
        if isinstance(module, TransformerEncoder) \
                and module.enable_ring_attention:
            axis = module.ring_attention_axis
            if axis not in mesh.groups:
                raise ValueError(f"ring_attention_axis {axis!r} is not a "
                                 f"mesh axis {tuple(mesh.groups)}")
            module.ring_group = mesh.group(axis)
    if mesh.shape["stage"] > 1 and not pipelined(model):
        raise ValueError(
            f"pipeline_parallel {mesh.shape['stage']} needs a stack with "
            f"pipeline_stages > 1 (encoder/decoder.pipeline_stages)")
    specs = params_shardings(model, mesh)
    _cut_model_axis(model, specs, mesh)
    _cut_expert_axis(model, specs, mesh)
    params = dict(model.named_parameters())
    owners = {}
    with torch.no_grad():
        for name, stage in _stage_layers(model, mesh).items():
            p = params[name]
            owners[name] = (stage, tuple(p.shape))
            if stage != mesh.coords["stage"]:
                p.data = p.data.new_empty(0)
    if owners:
        logging.info("Pipeline: stage %d holds %d of the %d layer "
                     "parameters", mesh.coords["stage"],
                     sum(s == mesh.coords["stage"]
                         for s, _ in owners.values()), len(owners))
    return Placement(specs, owners)


def _cut_expert_axis(model, specs, mesh):
    """Hands every MoE layer the "data" group and cuts the experts that
    ``specs`` splits over it to this rank's."""
    group, coord, n = _axis(mesh, "data")
    names = {id(m): name for name, m in model.named_modules()}
    sharded = 0
    for module in model.modules():
        if not isinstance(module, MoeFFN):
            continue
        module.data_group = group
        prefix = names[id(module)]
        spec = specs.get(f"{prefix}.expert_dense1_kernel".lstrip("."))
        if spec is None or n == 1:
            continue
        with torch.no_grad():
            for leaf in ("expert_dense1_kernel", "expert_dense1_bias",
                         "expert_dense2_kernel", "expert_dense2_bias"):
                p = getattr(module, leaf)
                p.data = take_shard(p.data, spec, coord, n)
        module.ep_group, module.ep_rank = group, coord
        sharded += 1
    if sharded:
        logging.info("Expert parallelism: %d MoE layers hold %d of their "
                     "experts a rank over %d data ranks", sharded,
                     next(m for m in model.modules() if isinstance(m, MoeFFN)
                          and m.ep_group is not None
                          ).expert_dense1_kernel.shape[0], n)


def _cut_model_axis(model, specs, mesh):
    """Cuts the parameters that ``specs`` shards to this rank's parts and
    tells their modules."""
    group, coord, n = _model_axis(mesh)
    if n == 1:
        return
    with torch.no_grad():
        for name, p in model.named_parameters():
            spec = specs[name]
            if _axis_of(spec) == "model":
                p.data = take_shard(p.data, spec, coord, n)
    names = {id(m): name for name, m in model.named_modules()}

    def sharded(module, leaf):
        prefix = names[id(module)]
        return specs.get(f"{prefix}.{leaf}" if prefix else leaf) is not None

    def kernel_sharded(layer):
        return sharded(layer, "kernel_q" if isinstance(layer, Int8Dense)
                       else "weight")

    tp = dict(tp_group=group, tp_rank=coord, tp_size=n)
    for module in model.modules():
        if isinstance(module, MultiHeadAttention):
            if not kernel_sharded(module.output_transform):
                continue
            module.__dict__.update(tp)
            module.num_heads //= n
            for c in module.children():
                _set_dense(c, group, row=c is module.output_transform)
        elif isinstance(module, TransformerFFN):
            if not kernel_sharded(module.dense1):
                continue
            module.__dict__.update(tp)
            _set_dense(module.dense1, group, row=False)
            _set_dense(module.dense2, group, row=True)
        elif isinstance(module, WordEmbedding):
            if not sharded(module, "weights_q" if module.int8
                           else "weights"):
                continue
            module.tp_group = group
            module.vocab_start = coord * module.vocab_held
    for module in model.modules():
        if isinstance(module, TransformerDecoder) and module.num_layers:
            # the decode cache holds the layers' (local) heads
            module.num_heads = module.layer_0.self_attention.num_heads
    output = getattr(model, "output_linear", None)
    if output is not None and kernel_sharded(output):
        model.tp_group = group
        _set_dense(output, group, row=False)
    logging.info("Tensor parallelism: %d of %d parameters sharded over %d "
                 "ranks", sum(_axis_of(s) == "model"
                              for s in specs.values()),
                 len(specs), n)
