"""Encoder: data_processor -> downscaler -> quantizer -> upscaler (counterpart
of vqcpcb_tpu/models/encoder.py)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vqcpcb_tpu_torch.models.data_processor import (BachCPCDataProcessor,
                                                    DataProcessor)
from vqcpcb_tpu_torch.utils import flatten


class Encoder(nn.Module):
    """x: int token grid, (batch, num_ticks, num_voices) for the CPC
    processor. Returns (z_quantized, encoding_indices, quantization_loss), one
    position per downscaled block (encoder.py:18). `training` (None: the
    module's mode) turns on dropout and the quantizer's training behaviour
    (BatchNorm statistics, EMA updates, label corruption when
    `corrupt_labels`); their random draws come from `generator`."""

    def __init__(self, data_processor: DataProcessor, downscaler: nn.Module,
                 quantizer: nn.Module, upscaler: Optional[nn.Module] = None):
        super().__init__()
        self.data_processor = data_processor
        self.downscaler = downscaler
        self.quantizer = quantizer
        self.upscaler = upscaler

    def forward(self, x: torch.Tensor, training: Optional[bool] = None,
                corrupt_labels: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        training = self.training if training is None else training
        z = self.downscale(x, training, generator)
        z_quantized, encoding_indices, quantization_loss = self.quantizer(
            z, training=training, corrupt_labels=corrupt_labels,
            generator=generator)
        if self.upscaler is not None:
            z_quantized = self.upscaler(z_quantized, training, generator)
        return z_quantized, encoding_indices, quantization_loss

    def downscale(self, x: torch.Tensor, training: Optional[bool] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Pre-quantization latents (the data-dependent codebook init reads
        them, encoder.py:55)."""
        return self.downscaler(self.embed_tokens(x), training, generator)

    def embed_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Tokens -> flat embedded sequence (batch, num_tokens, emb)."""
        if isinstance(self.data_processor, BachCPCDataProcessor):
            embedded = self.data_processor.embed_block(
                self.data_processor.preprocess(x))
            b, nb, tpb, e = embedded.shape
            return embedded.reshape(b, nb * tpb, e)
        return flatten(self.data_processor.embed(x))


def merge_codes(codes: torch.Tensor, codebook_size: int) -> torch.Tensor:
    """(batch, seq_len, num_codebooks) -> (batch, seq_len): one
    base-`codebook_size` integer per position (encoder.py:60)."""
    ret = codes[..., 0]
    for k in range(1, codes.shape[-1]):
        ret = ret + codes[..., k] * (codebook_size ** k)
    return ret
