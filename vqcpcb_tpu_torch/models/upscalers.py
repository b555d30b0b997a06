"""Upscaler: quantized z -> CPC feature space (counterpart of
vqcpcb_tpu/models/upscalers.py; reference layout mlp.0 / mlp.3 of
Linear, Dropout, SELU, Linear).

The dropout reads its rate from mlp.1 and draws its mask from the
generator the caller passes."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vqcpcb_tpu_torch.utils import dropout


class MlpUpscaler(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, hidden_size: int,
                 dropout: float):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(input_dim, hidden_size),
                                 nn.Dropout(dropout), nn.SELU(),
                                 nn.Linear(hidden_size, output_dim))

    def forward(self, inputs: torch.Tensor, training: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        training = self.training if training is None else training
        h = dropout(self.mlp[0](inputs), self.mlp[1].p, training, generator)
        return self.mlp[3](F.selu(h))
