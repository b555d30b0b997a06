"""Plain building blocks of the references: products at a stated precision,
LayerNorm, the GRU cell loop, relative-bias attention, the dropout draws of
a training step, and the ops of the KV caches' rounding.

`Precision` is where a control steps the arithmetic down: 'f32' (the
reference; TF32 is off), 'bf16', 'fp8' (e4m3 with one scale a tensor), and
for the decode caches 'int8' / 'int4' (one symmetric scale a row)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def round_to(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x with its values rounded to `kind`, in f32."""
    if kind == "f32":
        return x
    if kind == "bf16":
        return x.to(torch.bfloat16).float()
    if kind == "fp8":
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(kind)


def round_rows(x: torch.Tensor, kind: Optional[str]) -> torch.Tensor:
    """Symmetric integer rounding with one scale a row of the last axis
    (the caches' rule), or x itself for None."""
    if kind is None:
        return x
    levels = {"int8": 127.0, "int4": 7.0}[kind]
    scale = (x.abs().amax(-1, keepdim=True) / levels).clamp_min(1e-8)
    return torch.clamp(torch.round(x / scale), -levels, levels) * scale


class _Matmul(torch.autograd.Function):
    """a @ b with both factors rounded, and the backward's factors too."""

    @staticmethod
    def forward(ctx, a, b, kind):
        ctx.save_for_backward(a, b)
        ctx.kind = kind
        return round_to(a, kind) @ round_to(b, kind)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = lambda x: round_to(x, ctx.kind)          # noqa: E731
        return r(g) @ r(b).transpose(-1, -2), r(a).transpose(-1, -2) @ r(g), None


class Precision:
    """The products' precision of one reference run."""

    def __init__(self, kind: str = "f32"):
        self.kind = kind

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a (..., m, k) @ b (..., k, n), both of the same leading shape."""
        if self.kind == "f32":
            return a @ b
        return _Matmul.apply(a, b, self.kind)

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.matmul(x.reshape(-1, x.shape[-1]), w.t())
        y = y.reshape(x.shape[:-1] + (w.shape[0],))
        return y if b is None else y + b


def layer_norm(x, w, b, eps: float = 1e-6):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def gru_layer(x, w_ih, w_hh, b_ih, b_hh, prec: Precision) -> torch.Tensor:
    """x (N, T, in) -> the hidden states (N, T, H); gates (r, z, n) in
    torch's order and equations."""
    n, t_len, _ = x.shape
    gi = prec.linear(x, w_ih, b_ih)
    h = x.new_zeros(n, w_hh.shape[1])
    out = []
    for t in range(t_len):
        gh = prec.linear(h, w_hh, b_hh)
        i_r, i_z, i_n = gi[:, t].chunk(3, -1)
        h_r, h_z, h_n = gh.chunk(3, -1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        cand = torch.tanh(i_n + r * h_n)
        h = (1 - z) * cand + z * h
        out.append(h)
    return torch.stack(out, 1)


# ---- attention -------------------------------------------------------------

MASK32 = 0xFFFFFFFF


def _mul32(x, c):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _hash32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def attention_keep(b: int, h: int, t: int, s: int, rate: float, seed: int,
                   device) -> torch.Tensor:
    """The attention weights' dropout mask, True = kept, (B, H, T, S): plane
    (b, h) keeps (t, s) when lowbias32((t*S + s) ^ lowbias32((seed + h*B +
    b) * 0x9E3779B9)) reaches min(round(rate * 2^32), 2^32 - 1)."""
    streams = (int(seed) + torch.arange(h, device=device)[None, :] * b
               + torch.arange(b, device=device)[:, None]) & MASK32
    mixed = _hash32(_mul32(streams.long(), 0x9E3779B9))[..., None, None]
    idx = (torch.arange(t, device=device)[:, None] * s
           + torch.arange(s, device=device)[None, :]) & MASK32
    threshold = min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)
    return _hash32(idx.long() ^ mixed) >= threshold


def relbias_attention(q, k, v, mask, e1, e2, prec: Precision,
                      keep: Optional[torch.Tensor] = None,
                      rate: float = 0.0) -> torch.Tensor:
    """softmax(q.k + mask + bias) . v per head, q already scaled, with
    bias[t, s] = q_t . E[s + (S-1) - t // (T/S)] over E = [e1; e2[1:]] (the
    relative table, e1 causal and e2 anticausal offsets); q (B, H, T, d),
    k, v (B, H, S, d), e1, e2 (H, S, d), mask (T, S) additive or None;
    keep: the weights' dropout mask, kept weights scaled by 1/(1 - rate)."""
    b, h, t, d = q.shape
    s = k.shape[2]
    scores = prec.matmul(q, k.transpose(-1, -2))
    table = torch.cat([e1, e2[:, 1:]], dim=1)                      # (H, 2S-1, d)
    c = prec.matmul(q.transpose(0, 1).reshape(h, b * t, d), table.transpose(1, 2))
    c = c.reshape(h, b, t, 2 * s - 1).transpose(0, 1)
    cols = (torch.arange(s, device=q.device)[None, :] + (s - 1)
            - torch.arange(t, device=q.device)[:, None] // (t // s))
    scores = scores + torch.gather(c, 3, cols.expand(b, h, t, s))
    if mask is not None:
        scores = scores + mask
    w = torch.softmax(scores, dim=-1)
    if keep is not None:
        w = torch.where(keep, w / (1.0 - rate), torch.zeros((), device=w.device))
    return prec.matmul(w, v)


def additive_mask(allowed: torch.Tensor) -> torch.Tensor:
    return torch.zeros(allowed.shape, device=allowed.device).masked_fill(
        ~allowed, float("-inf"))


def causal(n: int, device) -> torch.Tensor:
    """Position t sees s <= t."""
    i = torch.arange(n, device=device)
    return additive_mask(i[None, :] <= i[:, None])


def anticausal(n: int, device) -> torch.Tensor:
    """Position t sees s >= t."""
    i = torch.arange(n, device=device)
    return additive_mask(i[None, :] >= i[:, None])


# ---- a training step's random draws ------------------------------------------

class Draws:
    """The dropout draws of the program's training steps, replayed: the
    elementwise masks from a device generator seeded with the program's
    seed, drawn by the same torch operation on tensors of the same shape and
    dtype in the same order (on CUDA torch's fused dropout, on the CPU a
    uniform draw), and each attention layer's seed of its weights' mask from
    a host generator with that seed."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.masks = torch.Generator(device=self.device).manual_seed(seed)
        self.seeds = torch.Generator().manual_seed(seed)

    def dropout(self, x: torch.Tensor, rate: float,
                dtype: torch.dtype = torch.float32,
                time_major: bool = False) -> torch.Tensor:
        """x with the next mask applied, kept entries scaled by 1/(1-rate);
        `dtype` is the dtype of the program's tensor at this point and
        `time_major` whether it lies in memory as (T, N, ...) though shaped
        (N, T, ...), as a batch-first GRU's output does: the fused kernel
        draws in memory order, so the mask follows the layout."""
        if rate <= 0.0:
            return x
        if self.device.type == "cuda":
            shape = ((x.shape[1], x.shape[0]) + tuple(x.shape[2:]) if time_major
                     else tuple(x.shape))
            ones = torch.ones(shape, dtype=dtype, device=self.device)
            if time_major:
                ones = ones.transpose(0, 1)
            keep = torch._fused_dropout(ones, 1.0 - rate, self.masks)[1].bool()
        else:
            keep = torch.rand(x.shape, generator=self.masks,
                              device=self.device) >= rate
        return x * keep / (1.0 - rate)

    def attention_seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.seeds))
