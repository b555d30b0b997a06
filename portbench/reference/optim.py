"""The training step's update in plain PyTorch: gradients clipped to a
global norm of 5 (scaled by 5 / norm when the norm reaches 5), then Adam
(b1 0.9, b2 0.999, eps 1e-8, bias-corrected), the learning rate read at the
step count before the update: constant, or the trapezoid schedule (from a
tenth of lr up to lr over the warm-up steps, then down at a tenth of that
slope, never under a tenth of lr)."""
from __future__ import annotations

from typing import Dict

import torch

B1, B2, EPS, CLIP = 0.9, 0.999, 1e-8, 5.0


def learning_rate(cfg: dict, count: int) -> float:
    lr = cfg["lr"]
    if not cfg.get("schedule_lr"):
        return lr
    warm = cfg["warmup_steps"]
    up = 0.1 + 0.9 / warm * count
    down = 1.0 - 0.09 / warm * (count - warm)
    return lr * max(min(up, down), 0.1)


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict):
        self.params = params
        self.cfg = cfg
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """One update from the parameters' .grad; returns the clipped
        gradients."""
        grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
                 for k, p in self.params.items()}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        if norm >= CLIP:
            grads = {k: g * (CLIP / norm.float()) for k, g in grads.items()}
        lr = learning_rate(self.cfg, self.count)
        self.count += 1
        c1, c2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k].mul_(B1).add_(g, alpha=1 - B1)
            self.nu[k].mul_(B2).addcmul_(g, g, value=1 - B2)
            p.sub_(lr * (self.mu[k] / c1) / ((self.nu[k] / c2).sqrt() + EPS))
            p.grad = None
        return grads
