"""Cross-cutting helpers (counterpart of vqcpcb_tpu/utils.py)."""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch


def flatten(x: torch.Tensor) -> torch.Tensor:
    """(batch, num_events, num_channels, ...) -> (batch, num_events*num_channels, ...)

    with channels varying fastest (vqcpcb_tpu/utils.py:16)."""
    b, e, c = x.shape[:3]
    return x.reshape((b, e * c) + tuple(x.shape[3:]))


def unflatten(sequence: torch.Tensor, num_channels: int) -> torch.Tensor:
    """(batch, num_events*num_channels, ...) -> (batch, num_events, num_channels, ...)
    (vqcpcb_tpu/utils.py:25)."""
    b, s = sequence.shape[:2]
    if s % num_channels:
        raise ValueError(f"length {s} is not a multiple of {num_channels}")
    return sequence.reshape((b, s // num_channels, num_channels)
                            + tuple(sequence.shape[2:]))


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout whose mask is drawn from `generator` (torch's default
    generator of x's device when None): each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate), as flax's nn.Dropout
    does. The identity outside training or at rate 0."""
    if not training or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep / (1.0 - rate)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """Entry-point device rule: the card unless the caller names another.

    None means CUDA; without CUDA that raises rather than falling back to
    the CPU, so a run that was meant for the card cannot silently measure
    the CPU. Pass device="cpu" to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def to_device(x, device: torch.device) -> torch.Tensor:
    """A tensor, or anything numpy reads (array, list), as a tensor on device."""
    if torch.is_tensor(x):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def kv_cache_dtype(device: torch.device) -> Optional[torch.dtype]:
    """Sampler KV-cache dtype policy (None = keep f32).

    Mirrors vqcpcb_tpu/utils.py:35-64: int8 on the accelerator (one int8 row
    plus one f32 scale per cached position, ops/kv_cache.py), f32 on the CPU
    so greedy KV-cached decoding stays comparable with the full forward.
    VQCPCB_KV_DTYPE=bfloat16|float32|int8 overrides."""
    env = os.environ.get("VQCPCB_KV_DTYPE")
    if env in ("bfloat16", "bf16"):
        return torch.bfloat16
    if env in ("float32", "f32", "fp32"):
        return None
    if env in ("int8", "i8"):
        return torch.int8
    if env:
        raise ValueError(
            f"VQCPCB_KV_DTYPE={env!r}: use 'bfloat16'/'bf16', "
            "'float32'/'f32' or 'int8'")
    return torch.int8 if torch.device(device).type == "cuda" else None


def relbias_in_kernel() -> bool:
    """Whether a relative-bias attention layer computes its bias inside the
    relative-bias kernels (the default) or builds the (B*H, T, S) bias in
    PyTorch and passes it to the fused-attention kernels (K4 at inference,
    K6 in training), where autograd carries it back to e1 and e2.

    Reads VQCPCB_PALLAS_RELBIAS as the JAX package does
    (vqcpcb_tpu/ops/pallas_attention.py:use_pallas_relbias): "1" (default)
    is the in-kernel route, "0" the explicit-bias route."""
    return os.environ.get("VQCPCB_PALLAS_RELBIAS", "1") == "1"
