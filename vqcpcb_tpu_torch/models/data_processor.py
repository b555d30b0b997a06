"""Token-to-embedding processors (counterpart of
vqcpcb_tpu/models/data_processor.py).

Each channel has its own table of vocab + 1 rows, the extra row being the
mask token (reference layout `embeddings.{c}.weight`).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class DataProcessor(nn.Module):
    """embed: (..., num_channels) int -> (..., num_channels, embedding_size)."""

    def __init__(self, embedding_size: int, num_events: int,
                 num_tokens_per_channel: Sequence[int],
                 add_mask_token: bool = True):
        super().__init__()
        self.embedding_size = embedding_size
        self.num_events = num_events
        self.num_tokens_per_channel = list(num_tokens_per_channel)
        extra = 1 if add_mask_token else 0
        self.embeddings = nn.ModuleList(
            nn.Embedding(v + extra, embedding_size)
            for v in self.num_tokens_per_channel)

    @property
    def num_channels(self) -> int:
        return len(self.num_tokens_per_channel)

    @property
    def num_tokens(self) -> int:
        return self.num_events * self.num_channels

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack([emb(x[..., i].long())
                            for i, emb in enumerate(self.embeddings)], dim=-2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.embed(x)


class BachDataProcessor(DataProcessor):
    """Decoder-side processor."""


class BachCPCDataProcessor(DataProcessor):
    """CPC-side processor: tick x voice grids cut into blocks of
    `num_tokens_per_block` tokens, voices interleaved within a block."""

    def __init__(self, embedding_size: int, num_events: int,
                 num_tokens_per_channel: Sequence[int],
                 num_tokens_per_block: int = 16, add_mask_token: bool = True):
        super().__init__(embedding_size, num_events, num_tokens_per_channel,
                         add_mask_token)
        self.num_tokens_per_block = num_tokens_per_block

    @staticmethod
    def block_preprocess(x: torch.Tensor, num_tokens_per_block: int
                         ) -> torch.Tensor:
        """(..., num_ticks, num_voices) -> (..., num_blocks, tokens_per_block),
        voices fastest (data_processor.py:71)."""
        num_ticks, num_voices = x.shape[-2:]
        total = num_ticks * num_voices
        if total % num_tokens_per_block:
            raise ValueError(f"{total} tokens do not split into blocks of "
                             f"{num_tokens_per_block}")
        return x.reshape(x.shape[:-2] + (total // num_tokens_per_block,
                                         num_tokens_per_block))

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        return self.block_preprocess(x, self.num_tokens_per_block)

    def embed_block(self, block: torch.Tensor) -> torch.Tensor:
        """(..., tokens_per_block) -> (..., tokens_per_block, emb); token i of
        a block is voice i % num_voices (data_processor.py:86)."""
        lead = block.shape[:-1]
        tokens_per_block = block.shape[-1]
        grouped = block.reshape(lead + (tokens_per_block // self.num_channels,
                                        self.num_channels))
        return self.embed(grouped).reshape(
            lead + (tokens_per_block, self.embedding_size))
