"""The comparisons that decide `correct`, general to every configuration.

Training: the reference follows the program's first three steps from the
same weights and batches; compared are each step's loss, each leaf's norm
of the first clipped gradient (the program's read from Adam's first moment
after one step), and each leaf's norm of the change of the parameters
after three steps. Norm gaps are taken by the worst leaf, each measured
against the larger of the reference's norm of that leaf and of the median
leaf. Entries whose reference first gradient is under a thousandth of the
median leaf's root-mean-square entry move under Adam by round-off alone
(a key's bias under the softmax): they are left out of the change.

Serving: the reference's teacher-forced logits judge each served token:
a greedy token by how far its logit lies below the best allowed one, a
sampled token by the probability mass (at the temperature) of the allowed
tokens ranked strictly above it beyond top-p; a code by how much farther
its codeword lies from the reference's latent than the nearest one, over
the mean distance."""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from portbench.reference.optim import Adam

B1 = 0.9
EXCLUDE_BELOW = 1e-3


def follow(weights: Dict[str, torch.Tensor], batches: Sequence,
           loss_fn: Callable, opt_cfg: dict) -> dict:
    """The reference's steps from `weights` (the trainable leaves) over
    `batches`: {'losses', 'first_grads', 'change'}. loss_fn(params, batch)
    -> the step's loss; it draws its own dropout."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    opt = Adam(params, opt_cfg)
    losses, first = [], None
    for batch in batches:
        loss = loss_fn(params, batch)
        loss.backward()
        grads = opt.step()
        losses.append(float(loss.detach()))
        if first is None:
            first = grads
    change = {k: (p.detach() - weights[k]) for k, p in params.items()}
    return {"losses": losses, "first_grads": first, "change": change}


def _median(values: List[float]) -> float:
    s = sorted(values)
    return s[len(s) // 2] if len(s) % 2 else 0.5 * (s[len(s) // 2 - 1] + s[len(s) // 2])


def worst_gap(prog: Dict[str, float], ref: Dict[str, float]) -> tuple:
    """(gap, leaf): max over leaves of |prog - ref| / max(ref, median ref)."""
    med = _median(list(ref.values()))
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def train_numbers(program: dict, reference: dict) -> Dict[str, float]:
    """program: {'losses': [3 floats], 'first_grads': {leaf: tensor},
    'change': {leaf: tensor}}; reference: follow()'s result."""
    ref_g = reference["first_grads"]
    rms = _median([float(g.float().pow(2).mean().sqrt()) for g in ref_g.values()])
    keep = {k: g.abs() >= EXCLUDE_BELOW * rms for k, g in ref_g.items()}
    norm = lambda x: float(x.double().norm())                      # noqa: E731
    grad_gap, grad_leaf = worst_gap(
        {k: norm(program["first_grads"][k]) for k in ref_g},
        {k: norm(g) for k, g in ref_g.items()})
    change_gap, change_leaf = worst_gap(
        {k: norm(program["change"][k] * keep[k]) for k in ref_g},
        {k: norm(reference["change"][k] * keep[k]) for k in ref_g})
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program["losses"],
                                                       reference["losses"]))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "_grad_leaf": grad_leaf,
            "_change_leaf": change_leaf}


def first_grads_from_adam(names: Sequence[str], mu: Sequence[torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """The clipped gradient of the first step from Adam's first moment after
    it: mu = (1 - b1) g."""
    return {k: m.detach().float() / (1.0 - B1) for k, m in zip(names, mu)}


# ---- serving -----------------------------------------------------------------

def token_numbers(ref_logits: List[torch.Tensor], tokens: torch.Tensor,
                  forbidden: List[Sequence[int]], greedy: torch.Tensor,
                  temperature: float, top_p: float) -> Dict[str, float]:
    """ref_logits: per voice (R, events, vocab_c); tokens (R, events,
    voices); greedy (R,) bool, which rows were served greedily. Returns
    greedy_gap (max best - served logit over greedy rows) and
    nucleus_excess (max over the other rows of the mass above the served
    token minus top_p, at least 0). A forbidden served token counts as a gap
    of 1e30 and an excess of 1."""
    greedy_gap, excess = 0.0, 0.0
    for c, lg in enumerate(ref_logits):
        lg = lg.double()
        banned = torch.zeros(lg.shape[-1], dtype=torch.bool, device=lg.device)
        banned[list(forbidden[c])] = True
        lg = lg.masked_fill(banned, float("-inf"))
        tok = tokens[..., c].long().to(lg.device)
        served = lg.gather(-1, tok[..., None])[..., 0]
        bad = banned[tok]
        g_rows, s_rows = greedy.to(lg.device), ~greedy.to(lg.device)
        if g_rows.any():
            gap = lg.amax(-1) - served
            gap = torch.where(bad, torch.full_like(gap, 1e30), gap)
            greedy_gap = max(greedy_gap, float(gap[g_rows].max()))
        if s_rows.any():
            p = torch.softmax(lg / temperature, dim=-1)
            above = (p * (lg > served[..., None])).sum(-1)
            ex = torch.where(bad, torch.ones_like(above), above - top_p)
            excess = max(excess, float(ex[s_rows].max()))
    return {"greedy_gap": greedy_gap, "nucleus_excess": max(excess, 0.0)}


def code_gap(dist: torch.Tensor, codes: torch.Tensor) -> float:
    """dist (N, S) reference distances, codes (N,) the program's codes."""
    dist = dist.double()
    chosen = dist.gather(-1, codes.long()[:, None])[:, 0]
    return float(((chosen - dist.amin(-1)) / dist.mean(-1)).max())


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when every compared number is at or under its limit (a NaN
    is not)."""
    return all(numbers[k] <= limits[k] for k in limits)
