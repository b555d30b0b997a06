"""Batched top-k / top-p filtering and categorical sampling (counterpart of
vqcpcb_tpu/ops/sampling.py). Draws come from an explicit torch.Generator."""
from __future__ import annotations

import os
from typing import Optional

import torch


def top_k_top_p_filtering(logits: torch.Tensor, top_k: int = 0,
                          top_p: float = 0.0,
                          exact_ties: Optional[bool] = None) -> torch.Tensor:
    """logits (..., vocab) with the filtered entries set to -inf.

    top_k keeps the k highest logits (0 disables). top_p keeps the smallest
    prefix of the sorted distribution whose cumulative probability exceeds
    top_p, always keeping the first token above the threshold (0 or >= 1
    disables). Tie rule at the nucleus boundary: by default every token whose
    logit equals the smallest kept one stays (the JAX default); with
    exact_ties the boundary is by sorted position, ties ordered by index
    (the reference's rule, sampling.py:54-76). exact_ties=None reads
    VQCPCB_EXACT_TOPP_TIES ('1' turns it on), as JAX does
    (sampling.py:41-42)."""
    if exact_ties is None:
        exact_ties = os.environ.get("VQCPCB_EXACT_TOPP_TIES", "0") == "1"
    neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype,
                           device=logits.device)
    if top_k > 0:
        k = min(top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if 0.0 < top_p < 1.0:
        if exact_ties:
            order = torch.argsort(-logits, dim=-1, stable=True)
            finite = torch.clamp(logits, min=-1e30)
            sorted_logits = torch.gather(finite, -1, order)
            cum_probs = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
            remove_sorted = _shift_right(cum_probs > top_p)
            remove = torch.zeros_like(remove_sorted).scatter(-1, order,
                                                             remove_sorted)
            logits = torch.where(remove, neg_inf, logits)
        else:
            sorted_logits = torch.sort(logits, dim=-1, descending=True).values
            cum_probs = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
            keep_sorted = ~_shift_right(cum_probs > top_p)
            inf = torch.tensor(float("inf"), dtype=logits.dtype,
                               device=logits.device)
            min_keep = torch.where(keep_sorted, sorted_logits, inf).amin(
                dim=-1, keepdim=True)
            logits = torch.where(logits < min_keep, neg_inf, logits)
    return logits


def _shift_right(remove: torch.Tensor) -> torch.Tensor:
    """Shift the removal mask one place right: the first token above the
    threshold is kept."""
    return torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]],
                     dim=-1)


def sample_categorical(generator: torch.Generator, logits: torch.Tensor,
                       temperature: float = 1.0, top_k: int = 0,
                       top_p: float = 0.0,
                       exact_ties: Optional[bool] = None) -> torch.Tensor:
    """Temperature + top-k/top-p sampling over the last axis by the Gumbel-max
    rule, argmax(logits - log E) with E ~ Exp(1) from `generator` (the rule
    of jax.random.categorical; the two generators' numbers differ)."""
    logits = logits / temperature
    logits = top_k_top_p_filtering(logits, top_k=top_k, top_p=top_p,
                                   exact_ties=exact_ties)
    noise = torch.empty_like(logits).exponential_(generator=generator)
    return torch.argmax(logits - noise.log(), dim=-1)
