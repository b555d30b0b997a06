"""GRUs of the encoder's downscaler (counterpart of vqcpcb_tpu/ops/gru.py).

torch.nn.GRU has the same gate order (r, z, n) and update equations as the
JAX scan, so `GRU` is torch's own (cuDNN on the card; the GRU is no Pallas
kernel). The JAX "bidirectional" GRU (gru.py:106 BiGRU) is NOT torch's
bidirectional GRU: it is two independent multi-layer GRUs, the backward one
run on the time-reversed block, whose last hidden states are concatenated
[forward, backward]. torch.nn.GRU(bidirectional=True) would feed both
directions into every upper layer, so `bigru_last_hidden` runs two
unidirectional GRUs instead.
"""
from __future__ import annotations

import torch
from torch import nn


class GRU(nn.GRU):
    """Multi-layer unidirectional GRU, batch-first (gru.py:40); returns the
    output sequence (batch, time, hidden_size)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 dropout: float = 0.0):
        super().__init__(input_size, hidden_size, num_layers=num_layers,
                         batch_first=True,
                         dropout=dropout if num_layers > 1 else 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x)[0]


def bigru_last_hidden(fwd: GRU, bwd: GRU, x: torch.Tensor) -> torch.Tensor:
    """The JAX BiGRU: x (batch, time, in) -> (batch, 2*hidden) =
    [last state of fwd(x), last state of bwd(x reversed in time)]."""
    return torch.cat([fwd(x)[:, -1], bwd(torch.flip(x, dims=(1,)))[:, -1]],
                     dim=-1)
