"""Subsampled relative attention bias (counterpart of
vqcpcb_tpu/ops/relative_attention.py).

For source length S, target length T = r*S and block b(t) = t // r:

    bias[b,h,t,s] = valid1[t,s] * <q[b,h,t], e1[h, S-1 - b(t) + s]>
                  + valid2[t,s] * <q[b,h,t], e2[h, s - b(t)]>

with valid1 = (s <= b(t)), valid2 = (s > b(t)). The port computes it by an
indexed gather of q.e1^T and q.e2^T (a GPU gathers as cheaply as it slices);
the plain attention path and the KV-cached decode step use it, the CUDA
kernel computes the same bias in-kernel.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def relative_bias_index_maps(seq_len_src: int, seq_len_tgt: int
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Static (tgt, src) index/validity maps for the causal (e1) and
    anticausal (e2) halves of the bias (relative_attention.py:34)."""
    if seq_len_src > seq_len_tgt or seq_len_tgt % seq_len_src:
        raise ValueError(f"target length {seq_len_tgt} must be a multiple of "
                         f"source length {seq_len_src}")
    ratio = seq_len_tgt // seq_len_src
    t = np.arange(seq_len_tgt)[:, None] // ratio
    s = np.arange(seq_len_src)[None, :]
    valid1 = s <= t
    valid2 = s > t
    idx1 = np.where(valid1, (seq_len_src - 1) - t + s, 0)
    idx2 = np.where(valid2, s - t, 0)
    return idx1.astype(np.int32), valid1, idx2.astype(np.int32), valid2


def subsampled_relative_bias(q: torch.Tensor, e1: torch.Tensor,
                             e2: torch.Tensor) -> torch.Tensor:
    """q: (B, H, T, hd), already scaled by hd**-0.5; e1, e2: (H, S, hd).
    Returns the (B, H, T, S) bias (relative_attention.py:72)."""
    seq_len_src = e1.shape[1]
    seq_len_tgt = q.shape[2]
    idx1, valid1, idx2, valid2 = (
        torch.as_tensor(a, device=q.device)
        for a in relative_bias_index_maps(seq_len_src, seq_len_tgt))
    r1 = torch.einsum("bhtd,hmd->bhtm", q, e1)
    r2 = torch.einsum("bhtd,hmd->bhtm", q, e2)
    b, h = r1.shape[:2]
    a1 = torch.gather(r1, 3, idx1.long().expand(b, h, -1, -1))
    a2 = torch.gather(r2, 3, idx2.long().expand(b, h, -1, -1))
    zero = torch.zeros((), dtype=a1.dtype, device=a1.device)
    return torch.where(valid1, a1, zero) + torch.where(valid2, a2, zero)


def subsampled_relative_bias_row(q_t: torch.Tensor, e1: torch.Tensor,
                                 e2: torch.Tensor, t: int,
                                 seq_len_tgt: int) -> torch.Tensor:
    """Bias row of one target position t for the KV-cached sampler.

    q_t: (B, H, hd) scaled query at position t; e1, e2: (H, S, hd).
    Returns (B, H, S) (relative_attention.py:104). Both halves are slices:
    row t reads e1[S-1-b(t) : S] and e2[0 : S-b(t)] shifted into place."""
    seq_len_src = e1.shape[1]
    block = t // (seq_len_tgt // seq_len_src)
    n1 = min(block, seq_len_src - 1) + 1                 # columns s <= block
    bias = torch.zeros(q_t.shape[:2] + (seq_len_src,), dtype=q_t.dtype,
                       device=q_t.device)
    bias[..., :n1] = torch.einsum(
        "bhd,hmd->bhm", q_t, e1[:, seq_len_src - 1 - block:seq_len_src - 1 - block + n1])
    if n1 < seq_len_src:
        bias[..., n1:] = torch.einsum(
            "bhd,hmd->bhm", q_t, e2[:, n1 - block:seq_len_src - block])
    return bias
