"""Product vector quantizers (counterpart of vqcpcb_tpu/ops/quantizer.py):
the commitment quantizer `ProductVectorQuantizer` (:57), its EMA twin
`EMAProductVectorQuantizer` (:144), the pass-through `NoQuantization` (:233)
and the data-dependent codebook init `initialize_codebooks` (:29).

Every nearest-codebook search goes through the quantizer's `search`, which
is `nearest_codebook_indices`: the plain version for CPU tensors, the
hand-written kernel for CUDA tensors. An instance's `search` may be set to
another function of (x (n, K, d), codebooks (K, S, d)) -> (n, K) indices,
as a route comparison does to decode given codes.
Parameters keep the reference layout: `embeddings.{k}` is sub-codebook k of
shape (codebook_size, codebook_dim // num_codebooks). The EMA quantizer
keeps its (K, S, d) `codebooks`, `cluster_size` and `ema_sums` as buffers:
they change in a training forward, not by gradient.

Each forward takes `training` (None: the module's mode), `corrupt_labels`
and `generator`, the torch.Generator of its random draws, and returns
(straight-through quantized (..., codebook_dim), indices
(..., num_codebooks) int32 or None, per-position loss (...,)).

Over a (data, model) mesh (parallel/mesh.py shard_params calls `set_mesh`)
each rank holds its rows of the batch, and what JAX's GSPMD computes over
the global batch is reduced over `data` here: BatchNorm's sums of x and x^2
and its row count, before the variance and the running statistics; and the
EMA quantizer's per-code counts and sums, before the decay. The parameters
are replicated (no TP rule splits them); the trainers run the
data-dependent init on the whole batch on every rank, with one generator.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vqcpcb_tpu_torch.ops.vq_kernels import nearest_codebook_indices
from vqcpcb_tpu_torch.parallel.collectives import sum_over_data_
from vqcpcb_tpu_torch.parallel.mesh import MeshMember

Output = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]
# share of the indices replaced by uniform draws under corrupt_labels
# (quantizer.py:63)
CORRUPTION_RATE = 0.05
# Laplace smoothing of the EMA cluster sizes (quantizer.py:160)
EMA_EPSILON = 1e-5


def initialize_codebooks(flat_input: torch.Tensor, num_codebooks: int,
                         codebook_size: int,
                         generator: Optional[torch.Generator] = None,
                         perms: Optional[Sequence] = None) -> torch.Tensor:
    """Data-dependent codebook init: sub-codebook k takes feature slice k of
    the first `codebook_size` rows of a random permutation of the inputs.

    flat_input (N, codebook_dim), N >= codebook_size; one permutation of N
    per sub-codebook, drawn from `generator` unless `perms` gives them.
    Returns (num_codebooks, codebook_size, codebook_dim // num_codebooks)."""
    n, codebook_dim = flat_input.shape
    if n < codebook_size:
        raise ValueError(f"{n} latents cannot initialise {codebook_size} "
                         "codewords; increase the batch")
    sub_dim = codebook_dim // num_codebooks
    tables = []
    for k in range(num_codebooks):
        perm = (torch.randperm(n, generator=generator, device=flat_input.device)
                if perms is None
                else torch.as_tensor(np.array(perms[k]),
                                     device=flat_input.device).long())
        rows = flat_input[perm[:codebook_size]]
        tables.append(rows[:, k * sub_dim:(k + 1) * sub_dim])
    return torch.stack(tables, dim=0)


class BatchNorm(MeshMember, nn.Module):
    """flax nn.BatchNorm(momentum=0.9, epsilon=1e-5) over the last axis.

    Training normalises by the batch's mean and biased variance
    E[x^2] - E[x]^2 (clipped at 0) and folds them into the running
    statistics as 0.9 running + 0.1 batch; flax keeps the biased variance
    there too, which torch's BatchNorm1d does not, so the statistics are
    computed here, from the sums of x and x^2 and the row count, which a
    mesh sums over `data` first (the global batch's statistics, as flax's
    under GSPMD)."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, training: bool) -> torch.Tensor:
        """x (n, num_features). In training x must take no gradient: the
        quantizer's search reads the output detached, so the statistics'
        reduction over `data` (an in-place all-reduce) needs no autograd."""
        if training:
            if x.requires_grad:
                raise ValueError("BatchNorm's input must take no gradient: its "
                                 "batch statistics are reduced without autograd")
            d = x.shape[-1]
            stats = torch.cat([x.sum(0), (x * x).sum(0),
                               x.new_full((1,), float(x.shape[0]))])
            sum_over_data_(stats, self.mesh)
            mean = stats[:d] / stats[-1]
            var = (stats[d:2 * d] / stats[-1] - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(
                    (1.0 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_(
                    (1.0 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def _lookup(codebooks: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """(K, S, d) codebooks, (n, K) indices -> (n, K, d): the rows the JAX
    one-hot contraction picks, with the same gradient to the codebooks."""
    k = torch.arange(codebooks.shape[0], device=codebooks.device)
    return codebooks[k[None], indices.long()]


class ProductVectorQuantizer(MeshMember, nn.Module):
    """Commitment-loss product quantizer: loss q_latent + cost * e_latent,
    optional BatchNorm of the search input only (the loss and the
    straight-through path use the unnormalised input), optional 5% label
    corruption in training (quantizer.py:109-117)."""

    def __init__(self, codebook_size: int, codebook_dim: int,
                 commitment_cost: float, num_codebooks: int,
                 squared_l2_norm: bool = True, use_batch_norm: bool = False):
        super().__init__()
        if codebook_dim % num_codebooks:
            raise ValueError(f"codebook_dim {codebook_dim} is not a multiple "
                             f"of num_codebooks {num_codebooks}")
        self.codebook_size = codebook_size
        self.codebook_dim = codebook_dim
        self.commitment_cost = commitment_cost
        self.num_codebooks = num_codebooks
        self.squared_l2_norm = squared_l2_norm
        sub_dim = codebook_dim // num_codebooks
        # randn * 4, as the reference and the JAX init (quantizer.py:69-72)
        self.embeddings = nn.ParameterList(
            nn.Parameter(torch.randn(codebook_size, sub_dim) * 4.0)
            for _ in range(num_codebooks))
        self.batch_norm = BatchNorm(codebook_dim) if use_batch_norm else None
        self.search = nearest_codebook_indices

    @property
    def codebooks(self) -> torch.Tensor:
        """(K, S, d) stacked sub-codebooks."""
        return torch.stack(list(self.embeddings), dim=0)

    @torch.no_grad()
    def set_codebooks(self, codebooks: torch.Tensor) -> None:
        for table, rows in zip(self.embeddings, codebooks):
            table.copy_(rows)

    def forward(self, inputs: torch.Tensor, training: Optional[bool] = None,
                corrupt_labels: bool = False,
                generator: Optional[torch.Generator] = None) -> Output:
        training = self.training if training is None else training
        input_shape = inputs.shape
        flat = inputs.reshape(-1, self.codebook_dim)
        search = (flat if self.batch_norm is None
                  else self.batch_norm(flat.detach(), training))
        n = flat.shape[0]
        e = self.codebooks                                       # (K, S, d)
        x = search.reshape(n, self.num_codebooks, -1)
        indices = self.search(x.detach().contiguous(),
                              e.detach().contiguous())               # (n, K)
        if training and corrupt_labels:
            random_indices = torch.randint(
                0, self.codebook_size, indices.shape, generator=generator,
                device=indices.device, dtype=indices.dtype)
            keep = torch.rand(indices.shape, generator=generator,
                              device=indices.device) > CORRUPTION_RATE
            indices = torch.where(keep, indices, random_indices)
        quantized = _lookup(e, indices).reshape(n, self.codebook_dim)
        quantized = quantized.to(inputs.dtype)
        if self.squared_l2_norm:
            e_latent = ((quantized.detach() - flat) ** 2).sum(-1)
            q_latent = ((quantized - flat.detach()) ** 2).sum(-1)
        else:
            eps = 1e-5
            e_latent = torch.linalg.norm((quantized.detach() - flat) + eps, dim=-1)
            q_latent = torch.linalg.norm((quantized - flat.detach()) + eps, dim=-1)
        loss = q_latent + self.commitment_cost * e_latent
        quantized_sg = flat + (quantized - flat).detach()
        return (quantized_sg.reshape(input_shape),
                indices.reshape(input_shape[:-1] + (self.num_codebooks,)),
                loss.reshape(input_shape[:-1]))


class EMAProductVectorQuantizer(MeshMember, nn.Module):
    """Product quantizer whose codebooks follow an exponential moving
    average of their assigned inputs (quantizer.py:144): in a training
    forward the per-code counts and input sums are folded in with decay
    `ema_decay`, and the codewords become the sums over the Laplace-smoothed
    counts. Only the e-latent (commitment) term enters the loss.

    At init ema_sums == codebooks and cluster_size == 1, the invariant the
    data-dependent init restores (`set_codebooks`)."""

    def __init__(self, codebook_size: int, codebook_dim: int,
                 commitment_cost: float, num_codebooks: int,
                 ema_decay: float = 0.99):
        super().__init__()
        if codebook_dim % num_codebooks:
            raise ValueError(f"codebook_dim {codebook_dim} is not a multiple "
                             f"of num_codebooks {num_codebooks}")
        self.codebook_size = codebook_size
        self.codebook_dim = codebook_dim
        self.commitment_cost = commitment_cost
        self.num_codebooks = num_codebooks
        self.ema_decay = ema_decay
        shape = (num_codebooks, codebook_size, codebook_dim // num_codebooks)
        codebooks = torch.randn(shape) * 4.0
        self.register_buffer("codebooks", codebooks)
        self.register_buffer("cluster_size",
                             torch.ones((num_codebooks, codebook_size)))
        self.register_buffer("ema_sums", codebooks.clone())
        self.search = nearest_codebook_indices

    @torch.no_grad()
    def set_codebooks(self, codebooks: torch.Tensor) -> None:
        self.codebooks.copy_(codebooks)
        self.ema_sums.copy_(codebooks)
        self.cluster_size.fill_(1.0)

    @torch.no_grad()
    def _update(self, x: torch.Tensor, indices: torch.Tensor) -> None:
        """EMA step from the searched inputs x (n, K, d) and their codes."""
        one_hot = torch.nn.functional.one_hot(
            indices.long(), self.codebook_size).float()           # (n, K, S)
        counts = one_hot.sum(0)
        sums = torch.einsum("nks,nkd->ksd", one_hot, x.float())
        n = counts.numel()
        both = sum_over_data_(torch.cat([counts.reshape(-1), sums.reshape(-1)]),
                              self.mesh)
        counts, sums = both[:n].view_as(counts), both[n:].view_as(sums)
        d = self.ema_decay
        cluster = d * self.cluster_size + (1 - d) * counts
        ema_sums = d * self.ema_sums + (1 - d) * sums
        total = cluster.sum(1, keepdim=True)
        smoothed = ((cluster + EMA_EPSILON)
                    / (total + self.codebook_size * EMA_EPSILON) * total)
        self.cluster_size.copy_(cluster)
        self.ema_sums.copy_(ema_sums)
        self.codebooks.copy_(ema_sums / smoothed[..., None])

    def forward(self, inputs: torch.Tensor, training: Optional[bool] = None,
                corrupt_labels: bool = False,
                generator: Optional[torch.Generator] = None) -> Output:
        if corrupt_labels:
            # corrupted assignments would also corrupt the codebook
            # statistics (quantizer.py:189)
            raise NotImplementedError(
                "corrupt_labels is not supported by the EMA quantizer; use "
                "quantizer_type 'commitment'")
        training = self.training if training is None else training
        input_shape = inputs.shape
        flat = inputs.reshape(-1, self.codebook_dim)
        n = flat.shape[0]
        x = flat.reshape(n, self.num_codebooks, -1).detach()
        indices = self.search(x.contiguous(), self.codebooks)
        quantized = _lookup(self.codebooks, indices).reshape(n, self.codebook_dim)
        quantized = quantized.to(inputs.dtype)
        if training:
            self._update(x, indices)
        loss = self.commitment_cost * ((quantized - flat) ** 2).sum(-1)
        quantized_sg = flat + (quantized - flat).detach()
        return (quantized_sg.reshape(input_shape),
                indices.reshape(input_shape[:-1] + (self.num_codebooks,)),
                loss.reshape(input_shape[:-1]))


class NoQuantization(nn.Module):
    """Pass-through (quantizer.py:233): the input, no indices, zero loss."""

    def __init__(self, codebook_dim: int):
        super().__init__()
        self.codebook_dim = codebook_dim
        self.codebook_size = 0
        self.num_codebooks = 1

    def forward(self, inputs: torch.Tensor, training: Optional[bool] = None,
                corrupt_labels: bool = False,
                generator: Optional[torch.Generator] = None) -> Output:
        return inputs, None, inputs.new_zeros(inputs.shape[:-1],
                                              dtype=torch.float32)
