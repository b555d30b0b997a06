"""The collectives of the tensor-parallel forward and of data-parallel
training, written out where GSPMD inserts them in JAX (parallel/mesh.py:
120-177).

Megatron's pair around every column-then-row block:
  * `copy_to_model`: identity forward, all-reduce over `model` backward, on
    the block's (replicated) input, whose gradient each rank holds a part of;
  * `reduce_from_model`: all-reduce over `model` forward, identity backward,
    on the row-parallel product, the sum of the ranks' partial products.
And for a replicated computation that feeds a row-parallel product, or a
vocabulary-parallel head that feeds a replicated loss:
  * `split_to_model`: this rank's block of the last axis forward, the
    all-gather of the blocks' gradients backward;
  * `gather_from_model`: the all-gather of the blocks along the last axis
    forward (logits, whole before the cross entropy), this rank's block of
    the gradient backward.

An all-gather is all_gather_into_tensor over the axis' group, in the
tensor's own dtype (the blocks are only placed side by side); NCCL takes it
on the card, and gloo on CPU tensors and on CUDA tensors (ranks that share
one card). Sums run in f32 (a bf16 value is exact in f32). Every function
is the identity where its axis has one rank.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from vqcpcb_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from vqcpcb_tpu_torch.utils import dense


def all_reduce_(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum x over `axis`, in place; returns x."""
    group = mesh.group(axis)
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The ranks' x stacked along a new leading axis, in rank order of
    `axis` (n, *x.shape)."""
    n = mesh.n_data if axis == DATA_AXIS else mesh.n_model
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    # all_gather_single is all_gather_into_tensor's name from torch 2.13 on
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x, group=mesh.group(axis))
    return out.unflatten(0, (n, -1))


def all_gather_last(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS
                    ) -> torch.Tensor:
    """The ranks' x concatenated along the last axis in rank order."""
    n = mesh.n_data if axis == DATA_AXIS else mesh.n_model
    if n == 1:
        return x
    return all_gather(x, mesh, axis).movedim(0, -2).flatten(-2)


def _block(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    w = x.shape[-1] // mesh.n_model
    return x[..., mesh.model_index * w:(mesh.model_index + 1) * w]


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        summed = all_reduce_(grad.to(torch.float32, copy=True), ctx.mesh, MODEL_AXIS)
        return summed.to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_(x.contiguous().clone(), mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SplitToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _block(x, mesh).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather_last(grad.contiguous(), ctx.mesh), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather_last(x.contiguous(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.mesh).contiguous(), None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return x if mesh.n_model == 1 else _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return x if mesh.n_model == 1 else _ReduceFromModel.apply(x, mesh)


def split_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return x if mesh.n_model == 1 else _SplitToModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return x if mesh.n_model == 1 else _GatherFromModel.apply(x, mesh)


def row_parallel(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """A row-parallel Linear in the compute dtype (utils.dense): this rank's
    input columns x (..., in / m) times its weight columns (out, in / m),
    the partial products summed over `model` in f32 (a bf16 product is
    rounded once, after the sum; gloo and NCCL both reduce f32), then the
    replicated bias, once."""
    y = dense(x, weight, None)
    y = reduce_from_model(y.float(), mesh).to(y.dtype)
    return y if bias is None else y + bias.to(y.dtype)


def mean_over_data(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mean of a (detached) value over the data axis: the global-batch
    mean of a per-rank mean over equal local batches. x itself without a
    mesh or with one data rank."""
    if mesh is None or mesh.n_data == 1:
        return x
    return all_reduce_(x.detach().clone(), mesh, DATA_AXIS) / mesh.n_data


def sum_over_data_(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum a buffer that takes no gradient (BatchNorm's and the EMA
    quantizer's batch sums, a codebook-usage histogram) over the data axis,
    in place; returns x. The identity without a mesh or with one data
    rank."""
    if mesh is not None and mesh.n_data > 1:
        all_reduce_(x, mesh, DATA_AXIS)
    return x


def gather_over_data(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every data rank's rows of x, concatenated in data order: the global
    batch (the codebook init's, under per-rank feeding). The identity
    without a mesh or with one data rank."""
    if mesh is None or mesh.n_data == 1:
        return x
    return all_gather(x, mesh, DATA_AXIS).flatten(0, 1)


def average_gradients(grads: List[torch.Tensor], mesh: Mesh) -> None:
    """Average gradients over the data axis in place, one all-reduce of
    them flattened: the gradient of the global-batch mean loss."""
    if mesh.n_data == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, mesh, DATA_AXIS).div_(mesh.n_data)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
