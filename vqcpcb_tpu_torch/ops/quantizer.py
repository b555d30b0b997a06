"""Product vector quantizer, inference forward (counterpart of
vqcpcb_tpu/ops/quantizer.py:ProductVectorQuantizer).

Parameters keep the reference layout: `embeddings.{k}` is sub-codebook k of
shape (codebook_size, codebook_dim // num_codebooks). BatchNorm, label
corruption and the EMA variant are training features of a later slice.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from vqcpcb_tpu_torch.ops.vq_kernels import nearest_codebook_indices


class ProductVectorQuantizer(nn.Module):
    def __init__(self, codebook_size: int, codebook_dim: int,
                 commitment_cost: float, num_codebooks: int,
                 squared_l2_norm: bool = True):
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

    @property
    def codebooks(self) -> torch.Tensor:
        """(K, S, d) stacked sub-codebooks."""
        return torch.stack(list(self.embeddings), dim=0)

    def forward(self, inputs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """inputs (..., codebook_dim) -> (straight-through quantized
        (..., codebook_dim), indices (..., num_codebooks) int32, commitment
        loss (...,))."""
        input_shape = inputs.shape
        flat = inputs.reshape(-1, self.codebook_dim)
        n = flat.shape[0]
        e = self.codebooks                                       # (K, S, d)
        x = flat.reshape(n, self.num_codebooks, -1)
        indices = nearest_codebook_indices(x.detach().contiguous(),
                                           e.detach().contiguous())   # (n, K)
        # the lookup picks rows exactly as the JAX one-hot contraction does
        quantized = e[torch.arange(self.num_codebooks, device=e.device)[None],
                      indices.long()].reshape(n, self.codebook_dim)
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
