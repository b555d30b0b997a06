"""The student trainer's teacher, a masked language model over chorales
(counterpart of vqcpcb_tpu/models/teacher.py, TeacherRelative :21)."""
from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from vqcpcb_tpu_torch.models.data_processor import DataProcessor
from vqcpcb_tpu_torch.models.heads import VocabParallelHeads
from vqcpcb_tpu_torch.ops.transformer import TransformerEncoder
from vqcpcb_tpu_torch.utils import flatten


class TeacherRelative(VocabParallelHeads, nn.Module):
    """Embedded tokens (batch, num_events, num_channels, emb) -> per channel,
    logits (batch, num_events, vocab_c).

    A bidirectional relative-attention encoder over the num_events x
    num_channels tokens (voices fastest): each token's embedding goes to
    d_model - p features, its channel's p features are appended, and one
    head per channel reads the encoder's output. `data_processor` (its own
    tables, each with the mask token's row) embeds the masked chorales the
    trainer feeds it. Train mode (the module's) takes the attention's
    training route and applies dropout. Reference names: data_processor,
    linear_to_input_transformer, channel_embeddings, transformer,
    pre_softmaxes.{c}. Under a model axis the heads are
    vocabulary-parallel (models/heads.py) and each comes out whole."""

    def __init__(self, data_processor: DataProcessor, num_layers: int,
                 num_tokens_per_channel: Sequence[int],
                 positional_embedding_size: int, d_model: int,
                 dim_feedforward: int, n_head: int, num_tokens: int,
                 dropout: float):
        super().__init__()
        num_channels = len(num_tokens_per_channel)
        if num_tokens % num_channels:
            raise ValueError(f"{num_tokens} tokens do not split into "
                             f"{num_channels} channels")
        self.data_processor = data_processor
        self.num_channels = num_channels
        self.d_model = d_model
        p = positional_embedding_size
        self.linear_to_input_transformer = nn.Linear(
            data_processor.embedding_size, d_model - p)
        self.channel_embeddings = nn.Parameter(torch.randn(1, num_channels, p))
        self.transformer = TransformerEncoder(
            num_layers, d_model, n_head, "relative_attention", num_channels,
            num_tokens // num_channels, dim_feedforward, dropout)
        self.pre_softmaxes = nn.ModuleList(
            nn.Linear(d_model, v) for v in num_tokens_per_channel)

    def forward(self, x_embedded: torch.Tensor) -> List[torch.Tensor]:
        seq = flatten(self.linear_to_input_transformer(x_embedded))
        b, num_tokens, _ = seq.shape
        num_events = num_tokens // self.num_channels
        seq = torch.cat([seq, self.channel_embeddings.repeat(b, num_events, 1)],
                        dim=2)
        out = self.transformer(seq).reshape(b, num_events, self.num_channels,
                                            self.d_model)
        return self.head_logits(out, per_channel=True)
