"""GRUs of the encoder's downscaler (counterpart of vqcpcb_tpu/ops/gru.py).

torch.nn.GRU has the same gate order (r, z, n) and update equations as the
JAX scan, so `GRU` is torch's own (cuDNN on the card; the GRU is no Pallas
kernel). The JAX "bidirectional" GRU (gru.py:106 BiGRU) is NOT torch's
bidirectional GRU: it is two independent multi-layer GRUs, the backward one
run on the time-reversed block, whose last hidden states are concatenated
[forward, backward]. torch.nn.GRU(bidirectional=True) would feed both
directions into every upper layer, so `bigru_last_hidden` runs two
unidirectional GRUs instead.

In training, dropout between the layers (not after the last one, as in
torch's GRU and gru.py:59-60) draws its mask from an explicit generator, so
a training GRU with dropout runs its layers one call each.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vqcpcb_tpu_torch.utils import dropout


class GRU(nn.GRU):
    """Multi-layer unidirectional GRU, batch-first (gru.py:40); returns the
    output sequence (batch, time, hidden_size). `training` None means the
    module's mode."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 dropout: float = 0.0):
        super().__init__(input_size, hidden_size, num_layers=num_layers,
                         batch_first=True)
        self.layer_dropout = dropout if num_layers > 1 else 0.0

    def forward(self, x: torch.Tensor, training: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        training = self.training if training is None else training
        if not (training and self.layer_dropout > 0.0):
            return super().forward(x)[0]
        h0 = x.new_zeros((1, x.shape[0], self.hidden_size))
        for layer in range(self.num_layers):
            if layer:
                x = dropout(x, self.layer_dropout, True, generator)
            # one layer of torch's own GRU (cuDNN on the card): its four
            # weights, one layer, no dropout, train mode, unidirectional,
            # batch-first
            x = torch._VF.gru(x, h0, self._flat_weights[4 * layer:4 * layer + 4],
                              True, 1, 0.0, True, False, True)[0]
        return x


def bigru_last_hidden(fwd: GRU, bwd: GRU, x: torch.Tensor,
                      training: Optional[bool] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """The JAX BiGRU: x (batch, time, in) -> (batch, 2*hidden) =
    [last state of fwd(x), last state of bwd(x reversed in time)]."""
    return torch.cat([fwd(x, training, generator)[:, -1],
                      bwd(torch.flip(x, dims=(1,)), training, generator)[:, -1]],
                     dim=-1)
