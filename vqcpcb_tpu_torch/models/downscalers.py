"""Downscalers: embedded token sequence -> per-block latent z (counterpart of
vqcpcb_tpu/models/downscalers.py; the GRU downscaler only -- the transformer
downscalers come with a later slice)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from vqcpcb_tpu_torch.ops.gru import GRU, bigru_last_hidden


class GruDownscaler(nn.Module):
    """(batch, num_blocks*block, emb) -> (batch, num_blocks, output_dim).

    Each block runs through a forward GRU and, when bidirectional, an
    independent GRU over the reversed block; the last hidden state(s) feed a
    linear head (downscalers.py:25). Reference names: g_enc_fwd, g_enc_bwd,
    output_linear."""

    def __init__(self, input_dim: int, output_dim: int,
                 downscale_factors: Sequence[int], hidden_size: int,
                 num_layers: int, dropout: float, bidirectional: bool):
        super().__init__()
        if len(downscale_factors) != 1:
            raise ValueError("the GRU downscaler takes one downscale factor")
        self.downscale_factors = list(downscale_factors)
        self.bidirectional = bidirectional
        self.g_enc_fwd = GRU(input_dim, hidden_size, num_layers, dropout)
        if bidirectional:
            self.g_enc_bwd = GRU(input_dim, hidden_size, num_layers, dropout)
        self.output_linear = nn.Linear(
            hidden_size * (2 if bidirectional else 1), output_dim)

    def forward(self, inputs: torch.Tensor, training: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`training` (None: the module's mode) applies the GRUs' dropout
        between layers, drawn from `generator`."""
        block = self.downscale_factors[0]
        b, seq_len, dim = inputs.shape
        if seq_len % block:
            raise ValueError(f"length {seq_len} is not a multiple of {block}")
        num_blocks = seq_len // block
        x = inputs.reshape(b * num_blocks, block, dim)
        if self.bidirectional:
            z = bigru_last_hidden(self.g_enc_fwd, self.g_enc_bwd, x, training,
                                  generator)
        else:
            z = self.g_enc_fwd(x, training, generator)[:, -1]
        return self.output_linear(z).reshape(b, num_blocks, -1)
