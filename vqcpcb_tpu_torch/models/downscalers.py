"""Downscalers: embedded token sequence -> per-block latent z (counterpart of
vqcpcb_tpu/models/downscalers.py): the GRU downscaler and the two
relative-transformer downscalers, strided and linear-aggregation.

Each takes (inputs, training, generator), as Encoder.downscale calls it;
`training` None means the module's mode."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from vqcpcb_tpu_torch.ops.gru import GRU, bigru_last_hidden
from vqcpcb_tpu_torch.ops.transformer import TransformerEncoder, train_mode


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


class RelativeTransformerDownscaler(nn.Module):
    """(batch, num_blocks*block, emb) -> (batch, num_blocks, output_dim), a
    block being prod(downscale_factors) tokens, voices fastest
    (downscalers.py:63).

    Each block is embedded to d_model - 2p features, then the channel and the
    event features (p each) are appended; stage i runs a relative-attention
    encoder of list_of_num_layers[i] layers over the block, then shortens it
    by downscale_factors[i]: every factor-th token is kept, or groups of
    factor tokens are merged by `linear_aggs.{i}`
    (RelativeTransformerDownscalerLinear). A stage's attention geometry is
    its token count as num_events x num_channels; after the first stage
    num_channels is 1. The one token left of each block feeds the output
    linear. Reference names: input_linear, target_channel_embeddings,
    events_positioning_embeddings, transformers.{i}, linear_aggs.{i},
    output_linear.

    Dropout draws from the generators set on the layers
    (ops/transformer.py:wire_generators), the trainer's; `generator` is the
    Encoder's argument, taken for its signature."""

    linear_aggregation = False

    def __init__(self, input_dim: int, output_dim: int,
                 downscale_factors: Sequence[int], num_channels: int,
                 d_model: int, n_head: int, list_of_num_layers: Sequence[int],
                 dim_feedforward: int, dropout: float,
                 positional_embedding_size: int = 8):
        super().__init__()
        if len(downscale_factors) != len(list_of_num_layers):
            raise ValueError("one number of layers per downscale factor")
        self.downscale_factors = list(downscale_factors)
        self.num_channels = num_channels
        self.d_model = d_model
        self.block = math.prod(self.downscale_factors)
        if self.block % num_channels:
            raise ValueError(f"a block of {self.block} tokens does not hold "
                             f"whole events of {num_channels} channels")
        num_events = self.block // num_channels
        p = positional_embedding_size
        self.input_linear = nn.Linear(input_dim, d_model - 2 * p)
        self.target_channel_embeddings = nn.Parameter(
            torch.randn(1, 1, num_channels, p))
        self.events_positioning_embeddings = nn.Parameter(
            torch.randn(1, 1, num_events, p))
        transformers = []
        channels = num_channels
        for factor, num_layers in zip(self.downscale_factors, list_of_num_layers):
            transformers.append(TransformerEncoder(
                num_layers, d_model, n_head, "relative_attention", channels,
                num_events, dim_feedforward, dropout))
            num_events = num_events * channels // factor
            if channels > 1:
                if channels > factor:
                    raise ValueError(f"the first factor {factor} must cover "
                                     f"the {channels} channels")
                channels = 1
        if num_events != 1:
            raise ValueError(f"the stages leave {num_events} tokens a block, "
                             "not 1")
        self.transformers = nn.ModuleList(transformers)
        if self.linear_aggregation:
            self.linear_aggs = nn.ModuleList(
                nn.Linear(factor * d_model, d_model)
                for factor in self.downscale_factors)
        self.output_linear = nn.Linear(d_model, output_dim)

    def forward(self, inputs: torch.Tensor, training: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, seq_len, dim = inputs.shape
        if seq_len % self.block:
            raise ValueError(f"length {seq_len} is not a multiple of {self.block}")
        num_blocks = seq_len // self.block
        events = self.events_positioning_embeddings.shape[2]
        with train_mode(self, training):
            x = self.input_linear(inputs.reshape(b, num_blocks, self.block, dim))
            ch = self.target_channel_embeddings.repeat(b, num_blocks, events, 1)
            ev = self.events_positioning_embeddings.repeat_interleave(
                self.num_channels, dim=2).expand(b, num_blocks, -1, -1)
            out = torch.cat([x, ch, ev], dim=3).reshape(
                b * num_blocks, self.block, self.d_model)
            for i, (factor, transformer) in enumerate(
                    zip(self.downscale_factors, self.transformers)):
                out = transformer(out)
                n, length, d = out.shape
                if self.linear_aggregation:
                    out = self.linear_aggs[i](
                        out.reshape(n, length // factor, factor * d))
                else:
                    out = out[:, ::factor]
            return self.output_linear(out[:, 0].reshape(b, num_blocks, self.d_model))


class RelativeTransformerDownscalerLinear(RelativeTransformerDownscaler):
    """Groups of `factor` tokens merged by a linear layer at each stage."""

    linear_aggregation = True
