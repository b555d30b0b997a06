"""The CPC context and scorer networks and the VQ-CPC training model
(counterpart of vqcpcb_tpu/models/cpc.py): `CModule` (:25), `FksModule`
(:42) and `VQCPCModel` (:58), whose forward is the whole loss of one batch:
encode the negatives, the left and the right windows, the context of the
left codes, the bilinear scores of the right codes and of the negatives,
InfoNCE plus the weighted quantization loss, per-k accuracy and the
codebook-usage metrics.

The negatives go through the encoder as one batch of b * num_neg * k
windows, so each encoder call searches its codebook once: on the card, one
nearest-codebook kernel launch each for the negatives, the left and the
right windows (and the backward negatives when bidirectional).

Over a (data, model) mesh (parallel/mesh.py shard_params calls `set_mesh`)
each rank scores its rows; the metrics are those of the global batch, as
JAX's under GSPMD: the losses and the per-k accuracy averaged over `data`
(equal local batches), the codebook-usage histograms summed over `data`
before the perplexity and the count of used codewords. The InfoNCE terms
are per example; the loss this rank returns for its backward is its rows'
mean (the optimizer averages the gradients over `data`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from vqcpcb_tpu_torch.models.encoder import Encoder, merge_codes
from vqcpcb_tpu_torch.ops.gru import GRU
from vqcpcb_tpu_torch.ops.losses import nce_loss, quantization_loss_aggregate
from vqcpcb_tpu_torch.parallel.collectives import mean_over_data, sum_over_data_
from vqcpcb_tpu_torch.parallel.mesh import MeshMember

# merged codebooks larger than this get no usage histogram (cpc.py:153)
MAX_HISTOGRAM_VOCAB = 65536


class CModule(nn.Module):
    """GRU over the left z-sequence; its last step -> linear context c.
    Reference names: g_ar_fwd, output_linear."""

    def __init__(self, input_dim: int, hidden_size: int, output_dim: int,
                 num_layers: int, dropout: float):
        super().__init__()
        self.g_ar_fwd = GRU(input_dim, hidden_size, num_layers, dropout)
        self.output_linear = nn.Linear(hidden_size, output_dim)

    def forward(self, zs: torch.Tensor, training: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.output_linear(self.g_ar_fwd(zs, training, generator)[:, -1])


class FksModule(nn.Module):
    """Bilinear scorers f_k(c, z) = z^T W_k c, W (z_dim, c_dim, k_max) drawn
    from N(0, 1)."""

    def __init__(self, z_dim: int, c_dim: int, k_max: int):
        super().__init__()
        self.W = nn.Parameter(torch.randn(z_dim, c_dim, k_max))

    def forward(self, c_t: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
        """c_t (batch, c_dim), zs (batch, k_max, z_dim) -> (batch, k_max)."""
        return torch.einsum("bc,zck,bkz->bk", c_t, self.W, zs)


def codebook_usage(codes: torch.Tensor, vocab: int, mesh=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merged codes (any shape) of a `vocab`-word codebook -> (codewords
    used, codebook perplexity: exp of the entropy of the usage histogram),
    the histogram summed over the data axis of `mesh` first."""
    hist = torch.bincount(codes.reshape(-1).long(), minlength=vocab).float()
    sum_over_data_(hist, mesh)
    p = hist / hist.sum().clamp_min(1.0)
    return (hist > 0).sum(), torch.exp(-torch.xlogy(p, p).sum())


class VQCPCModel(MeshMember, nn.Module):
    """Encoder + context / scorer networks (+ their backward twins when
    bidirectional); forward(batch) -> (loss, metrics)."""

    def __init__(self, encoder: Encoder, c_module: CModule,
                 fks_module: FksModule, c_module_back: Optional[CModule] = None,
                 fks_module_back: Optional[FksModule] = None,
                 quantization_weighting: float = 0.5):
        super().__init__()
        if (c_module_back is None) != (fks_module_back is None):
            raise ValueError("the backward branch needs both c_module_back "
                             "and fks_module_back")
        self.encoder = encoder
        self.c_module = c_module
        self.fks_module = fks_module
        self.c_module_back = c_module_back
        self.fks_module_back = fks_module_back
        self.quantization_weighting = quantization_weighting

    @property
    def bidirectional(self) -> bool:
        return self.c_module_back is not None

    def _scores(self, c_module, fks_module, zs_context, z_positive, z_neg,
                training, generator):
        """(positive scores (B, k), negative scores (B, k, N)) of one
        direction; z_neg (B, N, k, blocks, z) scores its first block."""
        c = c_module(zs_context, training, generator)
        positive = fks_module(c, z_positive)
        b, num_neg, k_dim = z_neg.shape[:3]
        negative = fks_module(
            c[:, None].expand(b, num_neg, c.shape[-1]).reshape(b * num_neg, -1),
            z_neg[:, :, :, 0].reshape(b * num_neg, k_dim, -1),
        ).reshape(b, num_neg, k_dim).transpose(1, 2)
        return positive, negative

    def forward(self, batch: Dict[str, torch.Tensor],
                training: Optional[bool] = None, corrupt_labels: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: x_left (B, ticks_left, voices), x_right (B, ticks_right,
        voices), negative_samples (B, num_neg, k, ticks_block, voices) and,
        when bidirectional, negative_samples_back of the same shape.
        `training` (None: the module's mode) turns on dropout and the
        quantizer's training behaviour; `corrupt_labels` applies to the
        negatives only; random draws come from `generator`."""
        training = self.training if training is None else training
        negatives = batch["negative_samples"]
        b, num_neg, k_dim, ticks, voices = negatives.shape

        def encode_negatives(neg):
            z, idx, qloss = self.encoder(
                neg.reshape(b * num_neg * k_dim, ticks, voices), training,
                corrupt_labels, generator)
            nb = z.shape[1]
            z = z.reshape(b, num_neg, k_dim, nb, z.shape[2])
            idx = None if idx is None else idx.reshape(b, num_neg, k_dim, nb, -1)
            return z, idx, qloss.reshape(b, num_neg, k_dim, nb)

        z_neg, idx_neg, qloss_neg = encode_negatives(negatives)
        z_neg_back = qloss_neg_back = None
        if self.bidirectional:
            z_neg_back, _, qloss_neg_back = encode_negatives(
                batch["negative_samples_back"])
        z_left, idx_left, qloss_left = self.encoder(
            batch["x_left"], training, False, generator)
        z_right, idx_right, qloss_right = self.encoder(
            batch["x_right"], training, False, generator)

        positive, negative = self._scores(self.c_module, self.fks_module,
                                          z_left, z_right, z_neg, training,
                                          generator)
        score_matrix = positive > negative.amax(2)
        contrastive_loss = nce_loss(positive, negative)
        accuracy = score_matrix.float().mean(0)
        if self.bidirectional:
            # the right zs run backwards in time; the left ones are not
            # flipped (cpc.py:124-137)
            positive_back, negative_back = self._scores(
                self.c_module_back, self.fks_module_back,
                torch.flip(z_right, dims=(1,)), z_left, z_neg_back, training,
                generator)
            contrastive_loss = contrastive_loss + nce_loss(positive_back,
                                                           negative_back)
            accuracy = (accuracy + (positive_back > negative_back.amax(2))
                        .float().mean(0)) / 2.0

        q_loss = quantization_loss_aggregate(qloss_left, qloss_neg,
                                             qloss_right, qloss_neg_back)
        loss = contrastive_loss + self.quantization_weighting * q_loss
        means = mean_over_data(torch.cat([
            torch.stack([loss, q_loss, contrastive_loss]).detach(), accuracy]),
            self.mesh)
        metrics = dict(zip(("loss", "loss_quantize", "loss_contrastive"), means[:3]),
                       accuracy=means[3:])
        quant = self.encoder.quantizer
        if quant.codebook_size:
            vocab = quant.codebook_size ** quant.num_codebooks
            if vocab <= MAX_HISTOGRAM_VOCAB:
                size = quant.codebook_size
                (metrics["num_codewords"],
                 metrics["codebook_perplexity"]) = codebook_usage(
                    merge_codes(torch.cat([idx_left, idx_right], dim=1), size),
                    vocab, self.mesh)
                metrics["num_codewords_negative"] = codebook_usage(
                    merge_codes(idx_neg.reshape(-1, idx_neg.shape[-1]), size),
                    vocab, self.mesh)[0]
        return loss, metrics
