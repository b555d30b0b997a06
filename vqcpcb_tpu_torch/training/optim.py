"""Optimizer: global-norm clipping, then Adam, with an optional trapezoid
learning-rate schedule (counterpart of vqcpcb_tpu/training/optim.py, which
chains optax.clip_by_global_norm(5) and optax.adam).

The arithmetic follows optax so one step matches the JAX trainer's:
  * clip: with n = ||g|| over all gradients, g <- g / n * 5 when n >= 5
    (optax.clip_by_global_norm; torch's clip_grad_norm_ adds 1e-6 to n);
  * Adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0): m <- b1 m + (1-b1) g,
    v <- b2 v + (1-b2) g^2, u = m_hat / (sqrt(v_hat) + eps) with the bias
    corrections of step count k = 1, 2, ...;
  * p <- p - lr(k-1) * u: the first update reads the schedule at 0, as
    optax's step count does.
Parameters are updated in place; nothing is read back to the host, so a step
does not wait for the device.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Union

import torch

WARMUP_STEPS = 10_000
MIN_SCALING = 0.1
MAX_SCALING = 1.0
GRAD_CLIP = 5.0
B1, B2, EPS = 0.9, 0.999, 1e-8       # optax.adam's defaults


def trapezoid_schedule(lr: float, warmup_steps: int = WARMUP_STEPS
                       ) -> Callable[[int], float]:
    """Warmup from 0.1 lr to lr over `warmup_steps`, then decay at a tenth of
    the warmup slope, floored at 0.1 lr (optim.py:20-36; the JAX version reads
    the warmup from VQCPCB_WARMUP_STEPS)."""
    slope_1 = (MAX_SCALING - MIN_SCALING) / warmup_steps
    slope_2 = -slope_1 * 0.1

    def schedule(step: int) -> float:
        up = MIN_SCALING + slope_1 * step
        down = MAX_SCALING + (step - warmup_steps) * slope_2
        return lr * max(min(up, down), MIN_SCALING)

    return schedule


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float = GRAD_CLIP) -> torch.Tensor:
    """Scale `grads` in place as optax.clip_by_global_norm does; returns the
    global norm (a device scalar)."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class Adam:
    """optax.adam over a list of parameters, with the global-norm clip in
    front; `lr` is a float or a schedule of the step count."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr: Union[float, Callable[[int], float]]):
        self.params = [p for p in params if p.requires_grad]
        self.lr = lr
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' .grad (a missing grad counts as
        zeros, as a JAX gradient of an unused parameter is). Returns the
        gradients' global norm before clipping (a device scalar)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        norm = clip_by_global_norm(grads)
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        c1 = 1.0 - B1 ** self.count
        c2 = 1.0 - B2 ** self.count
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - B1)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_addcmul_(self.nu, grads, grads, 1.0 - B2)
        denom = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        update = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(update, denom)
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(self.params, update)
        return norm
