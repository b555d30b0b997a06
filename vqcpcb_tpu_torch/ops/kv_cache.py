"""KV-cache helpers of the sampler (counterpart of vqcpcb_tpu/ops/kv_cache.py).

Formats: an f32 or bf16 cache is a plain (B, H, S, hd) tensor; an int8
cache is a (data int8 (B, H, S, hd), scale f32 (B, H, S, 1)) tuple, one
symmetric scale per cached row. Unlike the JAX helpers, which return new
arrays, `cache_update` writes the row in place: the sampler owns its caches.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

Cache = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: (..., S, hd) -> ((..., S, hd) int8,
    (..., S, 1) f32 scale); rounding half to even, as jnp.round."""
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8).float()
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(cache: Cache) -> torch.Tensor:
    """Inverse of quantize_kv for tuple caches; plain tensors pass through."""
    if isinstance(cache, tuple):
        data, scale = cache
        return data.float() * scale
    return cache


def new_cache(x: torch.Tensor, cache_dt: Optional[torch.dtype]) -> Cache:
    """A freshly captured (B, H, S, hd) K or V in the format for `cache_dt`
    (None keeps f32, a float dtype casts, int8 quantizes)."""
    if cache_dt == torch.int8:
        return quantize_kv(x)
    if cache_dt is not None:
        return x.to(cache_dt)
    return x


def cache_update(cache: Cache, new: torch.Tensor, t: int) -> Cache:
    """Write one position `new` (B, H, 1, hd) at row t, in format and in
    place; returns the cache."""
    if isinstance(cache, tuple):
        data, scale = cache
        q_t, s_t = quantize_kv(new)
        data[:, :, t:t + 1] = q_t
        scale[:, :, t:t + 1] = s_t
        return cache
    cache[:, :, t:t + 1] = new.to(cache.dtype)
    return cache


def cache_prefix(cache: Cache, n: int) -> Cache:
    """Rows [0, n) of the cached-positions axis (2), as views."""
    if isinstance(cache, tuple):
        return tuple(part[:, :, :n] for part in cache)
    return cache[:, :, :n]


def cache_resize(cache: Cache, n: int) -> Cache:
    """Grow (zero rows) or truncate the cached-positions axis to n rows, in
    format (kv_cache.py:61)."""
    if isinstance(cache, tuple):
        return tuple(cache_resize(part, n) for part in cache)
    if cache.shape[2] > n:
        return cache[:, :, :n]
    if cache.shape[2] < n:
        pad = cache.new_zeros(cache.shape[:2] + (n - cache.shape[2],)
                              + cache.shape[3:])
        return torch.cat([cache, pad], dim=2)
    return cache
