"""Upscaler: quantized z -> CPC feature space (counterpart of
vqcpcb_tpu/models/upscalers.py; reference layout mlp.0 / mlp.3 of
Linear, Dropout, SELU, Linear)."""
from __future__ import annotations

import torch
from torch import nn


class MlpUpscaler(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, hidden_size: int,
                 dropout: float):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(input_dim, hidden_size),
                                 nn.Dropout(dropout), nn.SELU(),
                                 nn.Linear(hidden_size, output_dim))

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        return self.mlp(inputs)
