"""Additive attention masks (counterpart of vqcpcb_tpu/ops/masks.py):
0 where attention is allowed, -inf where it is blocked."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = float("-inf")


def causal_mask(sz: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Lower triangle (diagonal included) allowed (ops/masks.py:14)."""
    allowed = torch.ones(sz, sz, dtype=torch.bool, device=device).tril()
    return torch.zeros(sz, sz, dtype=dtype, device=device).masked_fill(
        ~allowed, NEG_INF)


def anticausal_mask(sz: int, sz_tgt: Optional[int] = None, device=None,
                    dtype=torch.float32) -> torch.Tensor:
    """Upper triangle (diagonal included) allowed; with sz_tgt the rows are
    repeated so each group of sz_tgt/sz target tokens sees its code block
    (ops/masks.py:23)."""
    allowed = torch.ones(sz, sz, dtype=torch.bool, device=device).triu()
    mask = torch.zeros(sz, sz, dtype=dtype, device=device).masked_fill(
        ~allowed, NEG_INF)
    if sz_tgt is not None:
        if sz_tgt % sz:
            raise ValueError(f"target length {sz_tgt} not a multiple of {sz}")
        mask = mask.repeat_interleave(sz_tgt // sz, dim=0)
    return mask
