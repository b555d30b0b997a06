"""Losses (counterpart of vqcpcb_tpu/ops/losses.py): the CPC losses of the
encoder, nce_loss :16 and quantization_loss_aggregate :33, and the decoder's
cross entropies, categorical_crossentropy :54 and
stacked_categorical_crossentropy :91, and the student's soft-target
distilled_categorical_crossentropy :141.

All accumulate in f32. The cross entropies normalise each channel by its own
count of masked positions. The JAX versions contract with a one-hot because a
TPU executes the gather's transpose as a serial scatter; a GPU gathers, so
these pick the target's log-probability with `gather`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def nce_loss(positive: torch.Tensor, negatives: torch.Tensor) -> torch.Tensor:
    """InfoNCE: -(positive - logsumexp([negatives, positive])), summed over
    the prediction steps k and averaged over the batch.

    positive (B, k); negatives (B, k, num_negatives)."""
    positive = positive.float()
    stacked = torch.cat([negatives.float(), positive[..., None]], dim=2)
    return -(positive - torch.logsumexp(stacked, dim=2)).sum(1).mean(0)


def quantization_loss_aggregate(loss_left: torch.Tensor,
                                loss_negative: torch.Tensor,
                                loss_right: torch.Tensor,
                                loss_negative_back: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Mean over the streams and the batch of each window's summed
    commitment loss: loss_left (B, blocks_l), loss_right (B, blocks_r),
    loss_negative[_back] (B, num_neg, k, blocks_neg)."""
    parts = [loss_left.sum(1), loss_right.sum(1), loss_negative.sum((1, 2, 3))]
    if loss_negative_back is not None:
        parts.append(loss_negative_back.sum((1, 2, 3)))
    return torch.cat(parts, dim=0).mean()


def _nll(logp: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    return -logp.gather(-1, index.long()[..., None])[..., 0]


def categorical_crossentropy(value: Sequence[torch.Tensor],
                             target: torch.Tensor,
                             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum over channels c of sum_masked CE(value[c], target[..., c]) /
    max(count of masked positions of c, 1).

    value: per channel, logits (B, E, vocab_c); target (B, E, C) ints;
    mask (B, E, C) of {0, 1}, all ones by default."""
    mask = torch.ones_like(target, dtype=torch.float32) if mask is None else mask.float()
    total = 0.0
    for c, logits in enumerate(value):
        nll = _nll(F.log_softmax(logits.float(), dim=-1), target[..., c])
        m = mask[..., c]
        total = total + (nll * m).sum() / m.sum().clamp_min(1.0)
    return total


def stacked_categorical_crossentropy(stacked_logits: torch.Tensor,
                                     target: torch.Tensor,
                                     vocab_sizes: Sequence[int],
                                     mask: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    """categorical_crossentropy over channel-stacked logits
    (B, E, C, sum(vocab_sizes)), where channel c's logits live in columns
    [offset_c, offset_c + vocab_c) of its slot; the other columns of the slot
    are masked to -inf, so the log-softmax over the stacked axis is the
    per-channel one."""
    mask = torch.ones_like(target, dtype=torch.float32) if mask is None else mask.float()
    device = stacked_logits.device
    sizes = torch.tensor(list(vocab_sizes), device=device)
    offsets = torch.cumsum(sizes, 0) - sizes
    cols = torch.arange(int(sizes.sum()), device=device)
    valid = (cols >= offsets[:, None]) & (cols < (offsets + sizes)[:, None])
    logits = stacked_logits.float().masked_fill(~valid, float("-inf"))
    nll = _nll(F.log_softmax(logits, dim=-1), target.long() + offsets)  # (B, E, C)
    per_channel = (nll * mask).sum((0, 1))
    return (per_channel / mask.sum((0, 1)).clamp_min(1.0)).sum()


def distilled_categorical_crossentropy(value: Sequence[torch.Tensor],
                                       target: Sequence[torch.Tensor],
                                       mask: torch.Tensor) -> torch.Tensor:
    """Soft-target cross entropy -softmax(target) . log_softmax(value),
    summed over channels and over the events whose batch-mean mask exceeds
    0.5 (the reference masks whole events), averaged over the batch. The
    teacher's logits `target` give the distribution.

    value, target: per channel, logits (B, E, vocab_c); mask (B, E, C)."""
    total = 0.0
    for c, (v_logits, t_logits) in enumerate(zip(value, target)):
        p = torch.softmax(t_logits.float(), dim=-1)
        ce = -(p * F.log_softmax(v_logits.float(), dim=-1)).sum(-1)   # (B, E)
        event_mask = (mask[..., c].float().mean(0) > 0.5).float()     # (E,)
        total = total + (ce * event_mask).sum(1)
    return total.mean()
