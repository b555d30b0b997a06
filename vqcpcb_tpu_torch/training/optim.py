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
does not wait for the device. A step, clip included, is the span
vqcpcb.optimizer under a profiler (training/profiling.py).

Under a mesh (parallel/mesh.py) the gradients are first averaged over
`data` (the gradient of the global-batch mean loss: the data loaders drop
uneven tails, so the local batches are equal); the clip's norm sums the
squares of the gradients the model axis splits over `model` and counts each
replicated gradient once, so it is the norm of the whole gradient, as JAX
computes it; Adam then updates this rank's blocks. Its state_dict holds
the moments in the one-GPU layout (gathered over `model`), and
load_state_dict takes that layout and keeps this rank's blocks.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union

import torch

from vqcpcb_tpu_torch.parallel.collectives import all_reduce_, average_gradients
from vqcpcb_tpu_torch.parallel.mesh import MODEL_AXIS, gather_tensor, local_slice
from vqcpcb_tpu_torch.training.profiling import span

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


def warmup_steps_from_env() -> int:
    """The schedule's warmup as the JAX package reads it:
    VQCPCB_WARMUP_STEPS, else WARMUP_STEPS (optim.py:22-26)."""
    return int(os.environ.get("VQCPCB_WARMUP_STEPS", str(WARMUP_STEPS)))


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float = GRAD_CLIP, mesh=None,
                        sharded: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scale `grads` in place as optax.clip_by_global_norm does; returns the
    global norm (a device scalar). Under a mesh with a model axis, `sharded`
    (a 0 / 1 float tensor on the gradients' device, one entry a gradient)
    flags the gradients that are this rank's blocks: their squares are
    summed over `model`, the replicated ones counted once."""
    norms = torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    if mesh is None or mesh.n_model == 1:
        norm = torch.linalg.vector_norm(norms)
    else:
        squares = norms * norms
        split = all_reduce_((squares * sharded).sum(), mesh, MODEL_AXIS)
        norm = torch.sqrt((squares * (1.0 - sharded)).sum() + split)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class Adam:
    """optax.adam over a list of parameters, with the global-norm clip in
    front; `lr` is a float or a schedule of the step count. mesh: the mesh
    the parameters are trained over, with `specs` their Splits in order
    (parallel/mesh.module_specs; None where replicated); None for one
    rank."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr: Union[float, Callable[[int], float]], mesh=None,
                 specs: Optional[Sequence] = None):
        params = list(params)
        specs = list(specs) if specs is not None else [None] * len(params)
        kept = [(p, sp) for p, sp in zip(params, specs) if p.requires_grad]
        self.params = [p for p, _ in kept]
        self.specs = [sp for _, sp in kept]
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.sharded = None
        if self.mesh is not None and self.params:
            self.sharded = torch.tensor([float(sp is not None) for sp in self.specs],
                                        device=self.params[0].device)
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
        with span("vqcpcb.optimizer"):
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in self.params]
            if self.mesh is not None:
                average_gradients(grads, self.mesh)
            norm = clip_by_global_norm(grads, mesh=self.mesh, sharded=self.sharded)
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

    def _gather(self, moments: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.mesh is None:
            return list(moments)
        return [gather_tensor(x, sp, self.mesh)
                for x, sp in zip(moments, self.specs)]

    def state_dict(self) -> Dict:
        """The moments and the step count, which is also the schedule's
        position: an optimizer built by the same init_state and given this
        state takes the step, at the learning rate, that this one would.
        The moments are in the one-GPU layout (collective under a model
        axis)."""
        return {"count": self.count, "mu": self._gather(self.mu),
                "nu": self._gather(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Copy a state_dict() in place (onto this optimizer's devices),
        keeping this rank's blocks of the one-GPU layout."""
        if len(state["mu"]) != len(self.mu) or len(state["nu"]) != len(self.nu):
            raise ValueError(f"optimizer state for {len(state['mu'])} "
                             f"parameters, not {len(self.mu)}")
        if self.mesh is not None:
            state = dict(state, **{
                key: [local_slice(x, sp, self.mesh)
                      for x, sp in zip(state[key], self.specs)]
                for key in ("mu", "nu")})
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            if dst.shape != src.shape:
                raise ValueError(f"optimizer moment of shape {tuple(src.shape)}, "
                                 f"not {tuple(dst.shape)}")
            dst.copy_(src)
        self.count = int(state["count"])
