"""The VQ-CPC encoder of configs/encoder_random_config.py and its training
loss, in plain PyTorch (arXiv:2004.10120, Sections 3.1-3.2; the reference
VQCPCB code's layer order and names).

Encoder: per-voice token embeddings; the grid cut into blocks of 16 tokens
(4 ticks x 4 voices, voices fastest); two independent 2-layer GRUs of 512,
the second over the block reversed in time, whose last states feed a linear
map to the 3-wide latent z; the nearest of 32 codewords (squared distance,
ties to the lower index) with the commitment loss q + 0.25 e and the
straight-through estimator; an MLP (3 -> 512, dropout, SELU, -> 32) above.
The CPC head: a 2-layer GRU of 512 over the left blocks' codes, a linear map
to the context c, bilinear scores z^T W_k c of the 6 right blocks and of 15
negatives each, InfoNCE plus 0.5 x the mean commitment loss."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.nets import Draws, Precision, gru_layer

TOKENS_PER_BLOCK = 16


def _gru(w: Dict[str, torch.Tensor], name: str, x: torch.Tensor, layers: int,
         prec: Precision, draws: Optional[Draws], rate: float) -> torch.Tensor:
    for layer in range(layers):
        if layer and draws is not None:
            x = draws.dropout(x, rate, time_major=True)
        x = gru_layer(x, w[f"{name}.weight_ih_l{layer}"], w[f"{name}.weight_hh_l{layer}"],
                      w[f"{name}.bias_ih_l{layer}"], w[f"{name}.bias_hh_l{layer}"], prec)
    return x


def latents(w, x: torch.Tensor, cfg: dict, prec: Precision,
            draws: Optional[Draws] = None, prefix: str = "") -> torch.Tensor:
    """Token grid (B, ticks, voices) -> z (B, blocks, codebook_dim)."""
    p = prefix
    voices = x.shape[-1]
    emb = torch.stack([w[f"{p}data_processor.embeddings.{c}.weight"][x[..., c].long()]
                       for c in range(voices)], dim=-2)             # (B, T, V, E)
    b = x.shape[0]
    blocks = emb.reshape(-1, TOKENS_PER_BLOCK, emb.shape[-1])
    layers, rate = cfg["downscaler_layers"], cfg["dropout"]
    fwd = _gru(w, f"{p}downscaler.g_enc_fwd", blocks, layers, prec, draws, rate)
    bwd = _gru(w, f"{p}downscaler.g_enc_bwd", torch.flip(blocks, dims=(1,)),
               layers, prec, draws, rate)
    z = prec.linear(torch.cat([fwd[:, -1], bwd[:, -1]], -1),
                    w[f"{p}downscaler.output_linear.weight"],
                    w[f"{p}downscaler.output_linear.bias"])
    return z.reshape(b, -1, z.shape[-1])


def distances(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Squared distances (..., S) of latents (..., d) to the codewords (S, d)."""
    return ((z * z).sum(-1, keepdim=True) - 2.0 * z @ codebook.t()
            + (codebook * codebook).sum(-1))


class Pins:
    """The program's codes of each encoder call of its first steps, in call
    order. Where the reference's two nearest codewords lie within TIE of
    each other (relative to the row's mean distance) the two arithmetics may
    round either way, and the reference takes the program's code there;
    everywhere else its own. `pinned` counts the codes taken."""

    TIE = 1e-5

    def __init__(self, codes):
        self.codes = list(codes)
        self.pinned = 0

    def resolve(self, dist: torch.Tensor, own: torch.Tensor) -> torch.Tensor:
        program = self.codes.pop(0) if self.codes else None
        if program is None or program.numel() != own.numel():
            return own
        program = program.reshape(own.shape).to(own.device).long()
        two = dist.topk(2, dim=-1, largest=False).values
        tie = (two[..., 1] - two[..., 0]) <= self.TIE * dist.mean(-1)
        self.pinned += int((tie & (program != own)).sum())
        return torch.where(tie, program, own)


def encode(w, x: torch.Tensor, cfg: dict, prec: Precision,
           draws: Optional[Draws] = None, prefix: str = "",
           pins: Optional[Pins] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(upscaled quantized z (B, blocks, 32), codes (B, blocks), commitment
    loss (B, blocks)); draws: a training step's dropout draws, or None;
    pins: the program's codes at near ties, or None."""
    p = prefix
    z = latents(w, x, cfg, prec, draws, prefix)
    codebook = w[f"{p}quantizer.embeddings.0"]
    dist = distances(z.detach(), codebook.detach())
    codes = torch.argmin(dist, dim=-1)
    if pins is not None:
        codes = pins.resolve(dist, codes)
    quantized = codebook[codes]
    e_latent = ((quantized.detach() - z) ** 2).sum(-1)
    q_latent = ((quantized - z.detach()) ** 2).sum(-1)
    loss = q_latent + cfg["commitment_cost"] * e_latent
    zq = z + (quantized - z).detach()
    h = prec.linear(zq, w[f"{p}upscaler.mlp.0.weight"], w[f"{p}upscaler.mlp.0.bias"])
    if draws is not None:
        h = draws.dropout(h, cfg["dropout"])
    out = prec.linear(F.selu(h), w[f"{p}upscaler.mlp.3.weight"],
                      w[f"{p}upscaler.mlp.3.bias"])
    return out, codes, loss


def cpc_loss(w, batch: Dict[str, torch.Tensor], cfg: dict, prec: Precision,
             draws: Optional[Draws] = None, pins: Optional[Pins] = None
             ) -> torch.Tensor:
    """The VQ-CPC training loss of one batch: x_left, x_right (B, ticks, 4),
    negative_samples (B, negatives, k, ticks_block, 4)."""
    neg = batch["negative_samples"]
    b, n, k = neg.shape[:3]
    z_neg, _, q_neg = encode(w, neg.reshape((b * n * k,) + neg.shape[3:]), cfg,
                             prec, draws, "encoder.", pins)
    z_left, _, q_left = encode(w, batch["x_left"], cfg, prec, draws, "encoder.", pins)
    z_right, _, q_right = encode(w, batch["x_right"], cfg, prec, draws, "encoder.", pins)
    ctx = _gru(w, "c_module.g_ar_fwd", z_left, cfg["context_layers"], prec,
               draws, cfg["dropout"])[:, -1]
    c = prec.linear(ctx, w["c_module.output_linear.weight"],
                    w["c_module.output_linear.bias"])
    fk = w["fks_module.W"]                                          # (z, c, k)
    positive = torch.einsum("bc,zck,bkz->bk", c, fk, z_right)
    z_first = z_neg.reshape(b, n, k, -1, z_neg.shape[-1])[:, :, :, 0]   # (B, N, k, z)
    negative = torch.einsum("bc,zck,bnkz->bkn", c, fk, z_first)
    stacked = torch.cat([negative, positive[..., None]], dim=2)
    nce = -(positive - torch.logsumexp(stacked, dim=2)).sum(1).mean(0)
    q_loss = torch.cat([q_left.sum(1), q_right.sum(1),
                        q_neg.reshape(b, -1).sum(1)]).mean()
    return nce + cfg["quantization_weighting"] * q_loss


def weight_spec(cfg: dict, vocab_sizes, prefix: str = ""):
    """The encoder's leaves, their shapes and initial distributions."""
    from portbench.harness.weights import linear
    p, e, h = prefix, cfg["embedding_size"], cfg["hidden_size"]
    spec = [(f"{p}data_processor.embeddings.{c}.weight", (v + 1, e), "normal", 1.0)
            for c, v in enumerate(vocab_sizes)]
    std = (3.0 * h) ** -0.5
    for gru in ("g_enc_fwd", "g_enc_bwd"):
        for layer in range(cfg["downscaler_layers"]):
            width = e if layer == 0 else h
            name = f"{p}downscaler.{gru}"
            spec += [(f"{name}.weight_ih_l{layer}", (3 * h, width), "normal", std),
                     (f"{name}.weight_hh_l{layer}", (3 * h, h), "normal", std),
                     (f"{name}.bias_ih_l{layer}", (3 * h,), "normal", std),
                     (f"{name}.bias_hh_l{layer}", (3 * h,), "normal", std)]
    spec += linear(f"{p}downscaler.output_linear", 2 * h, cfg["codebook_dim"])
    spec.append((f"{p}quantizer.embeddings.0",
                 (cfg["codebook_size"], cfg["codebook_dim"]), "normal", 0.1))
    spec += linear(f"{p}upscaler.mlp.0", cfg["codebook_dim"], cfg["upscaler_hidden_size"])
    spec += linear(f"{p}upscaler.mlp.3", cfg["upscaler_hidden_size"],
                   cfg["upscaler_output_dim"])
    return spec


def cpc_weight_spec(cfg: dict, vocab_sizes):
    """The VQ-CPC model's leaves: the encoder, the context GRU and its
    linear map, the scorers."""
    from portbench.harness.weights import linear
    h, z = cfg["context_hidden_size"], cfg["upscaler_output_dim"]
    std = (3.0 * h) ** -0.5
    spec = weight_spec(cfg, vocab_sizes, "encoder.")
    for layer in range(cfg["context_layers"]):
        width = z if layer == 0 else h
        spec += [(f"c_module.g_ar_fwd.weight_ih_l{layer}", (3 * h, width), "normal", std),
                 (f"c_module.g_ar_fwd.weight_hh_l{layer}", (3 * h, h), "normal", std),
                 (f"c_module.g_ar_fwd.bias_ih_l{layer}", (3 * h,), "normal", std),
                 (f"c_module.g_ar_fwd.bias_hh_l{layer}", (3 * h,), "normal", std)]
    spec += linear("c_module.output_linear", h, cfg["context_output_dim"])
    spec.append(("fks_module.W", (z, cfg["context_output_dim"],
                                  cfg["num_blocks_right"]), "normal", 1.0))
    return spec
