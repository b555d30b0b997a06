"""Cross-entropy losses of the decoder (counterpart of
vqcpcb_tpu/ops/losses.py:categorical_crossentropy :54 and
stacked_categorical_crossentropy :91).

Both accumulate in f32 and normalise each channel by its own count of
masked positions. The JAX versions contract with a one-hot because a TPU
executes the gather's transpose as a serial scatter; a GPU gathers, so these
pick the target's log-probability with `gather`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


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
