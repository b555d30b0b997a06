"""The (data, model) mesh, batch sharding and the tensor-parallel parameter
rules (counterpart of vqcpcb_tpu/parallel/mesh.py).

A mesh is the torch.distributed ranks reshaped to (data, model), rank
r = data_index * n_model + model_index, as JAX reshapes its device list. Each
rank holds its own rows of the batch (`shard_batch`; a generation's rows,
with their place in the global batch, `generation_rows`) and, under a model
axis above 1, its own slices of the transformer's matrices (`shard_params`); the
modules then run Megatron's column / row split with the collectives of
`collectives.py`, where GSPMD inserts them in JAX (mesh.py:120-177). A mesh
of one rank is today's single-device path: nothing is sliced, nothing is
reduced.

`simulated_mesh` stands one process in for one rank of a larger mesh: the
coordinates without the process groups, for holding a shard's kernels
against the whole in one process. Any collective on it raises.

TP_RULES restate JAX's rules (first match wins) on the port's parameter
names, the reference's, which convert.py maps to the flax paths. A rule
splits one dimension into n_model contiguous blocks, or, for the fused
projections, each of its `groups` row blocks into n_model blocks:
in_proj_weight's rows are [q; k; v] and kv_proj's [k; v], each heads-major,
so a plain split of the whole would mix q with k. A parameter whose
dimension (or, for the attention, whose head count) does not divide the
model axis stays replicated, as in params_shardings (mesh.py:188-205).
torch.nn.Linear keeps (out, in) where flax keeps (in, out), so JAX's
column split (the output axis) is dimension 0 here and its row split
dimension 1.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) mesh, and the process groups of
    its data axis (the ranks of its model index) and its model axis (the
    ranks of its data index); a group is None where its axis has one rank,
    or on a simulated mesh."""
    n_data: int
    n_model: int
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None
    simulated: bool = False

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def rank(self) -> int:
        """The rank, which is also the shard index K7 offsets its dropout
        seed by (pallas_attention.py:1068-1071)."""
        return self.data_index * self.n_model + self.model_index

    def group(self, axis: str):
        """The process group of `axis`, None where the axis has one rank;
        raises on a simulated mesh with more."""
        n = self.n_data if axis == DATA_AXIS else self.n_model
        if n == 1:
            return None
        if self.simulated:
            raise RuntimeError(f"a collective over the {axis} axis of a "
                               "simulated mesh: it has no process group")
        return self.data_group if axis == DATA_AXIS else self.model_group

    def data_only(self) -> "Mesh":
        """The same data coordinates with the model axis folded away: the
        offsets of a computation every model rank repeats (an attention
        whose heads do not divide the model axis)."""
        return Mesh(self.n_data, 1, self.data_index, 0, self.data_group, None,
                    self.simulated)


def make_mesh(num_model: int = 1) -> Mesh:
    """The (data, model) mesh over every rank of the process group, data =
    world // num_model; a one-rank mesh outside a process group. Every rank
    must call it (it creates the axes' groups, collectively)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_model < 1 or world % num_model:
        raise ValueError(f"{world} ranks do not split into a model axis of "
                         f"{num_model}")
    n_data = world // num_model
    if world == 1:
        return Mesh(1, 1)
    rank = dist.get_rank()
    data_index, model_index = divmod(rank, num_model)
    data_group = model_group = None
    if n_data > 1:
        for m in range(num_model):
            group = dist.new_group([d * num_model + m for d in range(n_data)])
            if m == model_index:
                data_group = group
    if num_model > 1:
        for d in range(n_data):
            group = dist.new_group([d * num_model + m for m in range(num_model)])
            if d == data_index:
                model_group = group
    return Mesh(n_data, num_model, data_index, model_index, data_group,
                model_group)


def simulated_mesh(n_data: int, n_model: int, rank: int) -> Mesh:
    """Rank `rank`'s coordinates in an (n_data, n_model) mesh, in one
    process and without process groups."""
    if not 0 <= rank < n_data * n_model:
        raise ValueError(f"rank {rank} is outside an ({n_data}, {n_model}) mesh")
    data_index, model_index = divmod(rank, n_model)
    return Mesh(n_data, n_model, data_index, model_index, simulated=True)


# ---- batches ---------------------------------------------------------------

def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a host-identical global batch (an array, a
    tensor, or a dict / list of them): the data_index-th of n_data
    contiguous blocks of the leading axis. A leaf whose leading dimension
    does not divide the data axis (a stray last batch, a tiny eval batch)
    is kept whole, replicated, as JAX's shard_batch places it."""
    n = mesh.n_data

    def place(x):
        if np.ndim(x) >= 1 and x.shape[0] % n == 0 and n > 1:
            rows = x.shape[0] // n
            return x[mesh.data_index * rows:(mesh.data_index + 1) * rows]
        return x

    return _map_leaves(place, batch)


def shard_batch_local(batch, mesh: Mesh):
    """Multi-host twin of shard_batch: each rank passes only the rows it
    holds, its data shard of the global batch (the ranks of one data index
    the same rows), so no host builds the global batch. Every leaf must have
    a leading batch axis: a scalar raises, as JAX's does (mesh.py:96-100);
    host-identical leaves belong in shard_batch. One rank: shard_batch.

    CONTRACT, as in JAX: every rank passes the same local row count per
    leaf; the data loaders drop uneven tails (data/dataset.py)."""
    if mesh.size == 1:
        return shard_batch(batch, mesh)

    def place(x):
        if np.ndim(x) < 1:
            raise ValueError(
                "shard_batch_local leaves must have a leading batch axis; "
                "use shard_batch for host-identical scalars")
        return x

    return _map_leaves(place, batch)


@dataclass(frozen=True)
class Rows:
    """This rank's rows [start, stop) of a global batch of `total` rows."""
    start: int
    stop: int
    total: int

    @property
    def split(self) -> bool:
        """Whether the rank holds only a part of the batch."""
        return self.stop - self.start != self.total

    def of(self, x):
        """These rows of a global batch (an array or a tensor)."""
        return x[self.start:self.stop]


def generation_rows(batch_size: int, mesh: Mesh) -> Rows:
    """The rows of a generation batch this rank samples: its block of the
    data axis when the batch divides n_data (shard_batch's), else the whole
    batch on every data rank, replicated, as JAX places a batch that does
    not divide (the CLIs' batch of 3 on 2 or 4 ranks)."""
    n = mesh.n_data
    if n > 1 and batch_size % n == 0:
        local = batch_size // n
        return Rows(mesh.data_index * local, (mesh.data_index + 1) * local,
                    batch_size)
    return Rows(0, batch_size, batch_size)


# ---- tensor-parallel parameter rules ---------------------------------------

@dataclass(frozen=True)
class Split:
    """Split dimension `dim` over the model axis: each of its `groups` equal
    row blocks into n_model contiguous blocks. `by` names what must divide
    the model axis: the owning attention's "heads" or "kv_heads", or None
    for the block length itself."""
    dim: int
    groups: int = 1
    by: Optional[str] = None


# The port's counterparts of JAX's TP_RULES (mesh.py:160-177), in its order:
# linear1 / linear2 the FFN pair; in_proj, q_proj, kv_proj and the relative
# tables by heads; out_proj row-parallel; cross_attn.0 / .2 the aligned
# layer's cross_mlp_1 / cross_mlp_2 pair; the output heads by vocabulary.
# The row-parallel biases (linear2, out_proj, cross_attn.2) are replicated,
# added once after the reduce.
TP_RULES = [
    (re.compile(r".*linear1\.weight$"), Split(0)),
    (re.compile(r".*linear2\.weight$"), Split(1)),
    (re.compile(r".*in_proj_weight$"), Split(0, 3, "heads")),
    (re.compile(r".*in_proj_bias$"), Split(0, 3, "heads")),
    (re.compile(r".*q_proj\.(weight|bias)$"), Split(0, 1, "heads")),
    (re.compile(r".*kv_proj\.(weight|bias)$"), Split(0, 2, "kv_heads")),
    (re.compile(r".*attn_bias\.e[12]$"), Split(0, 1, "heads")),
    (re.compile(r".*linear1\.bias$"), Split(0)),
    (re.compile(r".*out_proj\.weight$"), Split(1)),
    (re.compile(r".*cross_attn\.0\.(weight|bias)$"), Split(0)),
    (re.compile(r".*cross_attn\.2\.weight$"), Split(1)),
    (re.compile(r".*pre_softmax(es\.\d+)?\.(weight|bias)$"), Split(0)),
]


def _owning_attention(module: nn.Module, name: str) -> nn.Module:
    parts = name.split(".")
    for i in range(len(parts) - 1, 0, -1):
        sub = module.get_submodule(".".join(parts[:i]))
        if hasattr(sub, "num_kv_heads"):
            return sub
    raise ValueError(f"{name} lies under no attention module")


def param_spec(module: nn.Module, name: str, shape, num_model: int
               ) -> Optional[Split]:
    """The Split of parameter `name` of `module` over a model axis of
    num_model, or None (replicated)."""
    if num_model == 1:
        return None
    for pattern, split in TP_RULES:
        if pattern.match(name):
            if split.by is None:
                n = shape[split.dim] // split.groups
            else:
                owner = _owning_attention(module, name)
                n = owner.num_heads if split.by == "heads" else owner.num_kv_heads
            return split if n % num_model == 0 else None
    return None


def tp_specs(module: nn.Module, num_model: int) -> Dict[str, Optional[Split]]:
    """Every parameter's Split over a model axis of num_model, by name."""
    return {name: param_spec(module, name, p.shape, num_model)
            for name, p in module.named_parameters()}


def local_slice(x: torch.Tensor, spec: Optional[Split], mesh: Mesh
                ) -> torch.Tensor:
    """This rank's block of a full tensor under `spec` (a contiguous copy),
    or x itself when replicated."""
    if spec is None or mesh.n_model == 1:
        return x
    blocks = x.unflatten(spec.dim, (spec.groups, mesh.n_model, -1))
    return blocks.select(spec.dim + 1, mesh.model_index).flatten(
        spec.dim, spec.dim + 1).contiguous()


def gather_tensor(x: torch.Tensor, spec: Optional[Split], mesh: Mesh
                  ) -> torch.Tensor:
    """The full tensor from every model rank's block (collective over the
    model axis): local_slice's inverse."""
    if spec is None or mesh.n_model == 1:
        return x
    from vqcpcb_tpu_torch.parallel.collectives import all_gather
    blocks = all_gather(x, mesh, MODEL_AXIS)       # (n_model, *x.shape)
    # rank blocks (n, ..., groups * w, ...) -> (..., groups, n, w, ...)
    return blocks.unflatten(spec.dim + 1, (spec.groups, -1)).movedim(
        0, spec.dim + 1).flatten(spec.dim, spec.dim + 2)


def local_state_dict(state: Dict[str, torch.Tensor],
                     specs: Dict[str, Optional[Split]], mesh: Mesh
                     ) -> Dict[str, torch.Tensor]:
    """A full (one-GPU layout) state_dict cut to this rank's blocks."""
    return {k: local_slice(v, specs.get(k), mesh) for k, v in state.items()}


class MeshMember:
    """A mixin for a module that only keeps the mesh shard_params gives it
    (`self.mesh`, None off a mesh), over whose data axis it reduces its
    batch statistics."""

    mesh = None

    def set_mesh(self, mesh, specs) -> None:
        self.mesh = mesh


def shard_params(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep this rank's blocks of `module`'s parameters, in place (the
    Parameter objects stay, so an optimizer built afterwards holds them),
    and give every submodule with a `set_mesh` method the mesh and its own
    parameters' Splits, by which it runs its part of the TP forward. A
    one-rank mesh leaves the module as it is."""
    if mesh.size == 1:
        return module
    specs = tp_specs(module, mesh.n_model)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.data = local_slice(p.data, specs[name], mesh)
    module.mesh_specs = specs
    for prefix, sub in module.named_modules():
        if hasattr(sub, "set_mesh"):
            head = f"{prefix}." if prefix else ""
            sub.set_mesh(mesh, {k[len(head):]: v for k, v in specs.items()
                                if k.startswith(head)})
    return module


def module_specs(module: nn.Module) -> Dict[str, Optional[Split]]:
    """The Splits shard_params applied to `module` (none if it did not)."""
    return getattr(module, "mesh_specs", {})


def gather_params(module: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The module's full state_dict, the layout of a one-GPU checkpoint, on
    every rank (collective over the model axis)."""
    specs = module_specs(module)
    return {k: gather_tensor(v, specs.get(k), mesh)
            for k, v in module.state_dict().items()}
