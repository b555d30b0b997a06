"""Seeded weights and the seeds of a run's parts.

A configuration's system names every leaf with its shape and its initial
distribution (N(0, std^2) or a constant); `make` draws all normal leaves in
one call on the device from the run's seed and cuts them into the leaves.
The program and the reference are both handed these tensors."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# the parts of a run that draw from the seed, each from its own stream
WEIGHTS, TRAFFIC, PROGRAM, SAMPLE = range(4)

Spec = List[Tuple[str, Tuple[int, ...], str, float]]


def stream_seed(seed: int, part: int) -> int:
    """One seed a part, distinct for every (seed, part)."""
    return int(seed) * 4 + part


def make(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor} for spec entries (name, shape, 'normal', std) or
    (name, shape, 'const', value)."""
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, WEIGHTS))
    sizes = [int(torch.Size(shape).numel()) for _, shape, kind, _ in spec
             if kind == "normal"]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, parts = {}, iter(torch.split(flat, sizes))
    for name, shape, kind, value in spec:
        if kind == "normal":
            out[name] = next(parts).view(shape).mul_(value)
        elif kind == "const":
            out[name] = torch.full(shape, float(value), device=device)
        else:
            raise ValueError(f"{name}: unknown init {kind!r}")
    return out


def linear(name: str, fan_in: int, fan_out: int, bias: bool = True) -> Spec:
    """torch's nn.Linear init as a normal of the same variance."""
    std = (3.0 * fan_in) ** -0.5
    spec = [(f"{name}.weight", (fan_out, fan_in), "normal", std)]
    if bias:
        spec.append((f"{name}.bias", (fan_out,), "normal", std))
    return spec


def layer_norm(name: str, width: int) -> Spec:
    return [(f"{name}.weight", (width,), "const", 1.0),
            (f"{name}.bias", (width,), "const", 0.0)]
