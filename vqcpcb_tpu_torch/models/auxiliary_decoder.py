"""The student trainer's auxiliary decoders: bidirectional transformers that
upscale the quantized latents back to per-channel logits (counterpart of
vqcpcb_tpu/models/auxiliary_decoder.py: upscale :22, AuxiliaryDecoder and
AuxiliaryDecoderRelative :30-97)."""
from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from vqcpcb_tpu_torch.models.heads import VocabParallelHeads
from vqcpcb_tpu_torch.ops.transformer import TransformerEncoder


def upscale(x: torch.Tensor, factor: int, embeddings: torch.Tensor
            ) -> torch.Tensor:
    """x (batch, L, d), embeddings (factor, d) -> (batch, L*factor, d):
    out[t] = x[t // factor] + embeddings[t % factor]."""
    return (x.repeat_interleave(factor, dim=1)
            + embeddings.repeat(x.shape[1], 1)[None])


class AuxiliaryDecoder(VocabParallelHeads, nn.Module):
    """z (batch, num_tokens_bottleneck, codebook_dim) -> per channel, logits
    (batch, num_events, vocab_c).

    A linear to d_model, then per stage i a transformer encoder of
    list_of_num_layers[i] layers and an upscaling by upscale_factors[i].
    This absolute variant adds learned positional embeddings at the
    bottleneck and its attention carries no bias. Train mode (the
    module's) takes the attention's training route and applies dropout.
    Reference names: linear, positional_embeddings, transformers.{i},
    upscale_embeddings.{i}, pre_softmaxes.{c}. Under a model axis the
    heads are vocabulary-parallel (models/heads.py) and each comes out
    whole."""

    relative = False

    def __init__(self, num_tokens_per_channel: Sequence[int], codebook_dim: int,
                 upscale_factors: Sequence[int],
                 list_of_num_layers: Sequence[int], n_head: int, d_model: int,
                 dim_feedforward: int, num_tokens_bottleneck: int,
                 dropout: float):
        super().__init__()
        if len(upscale_factors) != len(list_of_num_layers):
            raise ValueError("one number of layers per upscale factor")
        num_channels = len(num_tokens_per_channel)
        self.upscale_factors = list(upscale_factors)
        self.num_channels = num_channels
        self.d_model = d_model
        self.linear = nn.Linear(codebook_dim, d_model)
        if not self.relative:
            self.positional_embeddings = nn.Parameter(
                torch.randn(1, num_tokens_bottleneck, d_model))
        transformers = []
        num_tokens = num_tokens_bottleneck
        for factor, num_layers in zip(self.upscale_factors, list_of_num_layers):
            # the relative geometry divides the stage's tokens by the
            # channels even below event resolution, as the reference does
            # (auxiliary_decoder.py:65)
            transformers.append(TransformerEncoder(
                num_layers, d_model, n_head,
                "relative_attention" if self.relative else None, num_channels,
                num_tokens // num_channels if self.relative else num_tokens,
                dim_feedforward, dropout))
            num_tokens *= factor
        if num_tokens % num_channels:
            raise ValueError(f"{num_tokens} output tokens do not split into "
                             f"{num_channels} channels")
        self.transformers = nn.ModuleList(transformers)
        self.upscale_embeddings = nn.ParameterList(
            nn.Parameter(torch.randn(factor, d_model))
            for factor in self.upscale_factors)
        self.pre_softmaxes = nn.ModuleList(
            nn.Linear(d_model, v) for v in num_tokens_per_channel)

    def forward(self, z: torch.Tensor) -> List[torch.Tensor]:
        out = self.linear(z)
        if not self.relative:
            out = out + self.positional_embeddings
        for factor, transformer, emb in zip(
                self.upscale_factors, self.transformers, self.upscale_embeddings):
            out = upscale(transformer(out), factor, emb)
        b, num_tokens, _ = out.shape
        out = out.reshape(b, num_tokens // self.num_channels, self.num_channels,
                          self.d_model)
        return self.head_logits(out, per_channel=True)


class AuxiliaryDecoderRelative(AuxiliaryDecoder):
    """Relative-attention layers, no positional embeddings."""

    relative = True
