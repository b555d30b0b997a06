"""What the attention kernels' wrappers share (attention_kernels.py for the
relative-bias kernels, fused_attention_kernels.py for the fused ones): the
(B, H, L, d) and packed (B, L, H*d) layouts, the input checks, the ctypes
typing of the C entry points, their argument encoding, and the mapping of
their status codes to exceptions.

Every attention entry point in csrc/ takes n data pointers, one array of
element strides, seven ints (B, H, T, S, D, in_bf16, bf16_dots), then the
dropout seed, threshold, keep scale and flag, and the stream; it returns 0
when launched, one of ERRORS' codes, or a cudaError_t.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from vqcpcb_tpu_torch.ops import _build

NEG_BIG = -1e30
MASK32 = 0xFFFFFFFF

ERRORS = {-1: "head dim must be one of 8, 16, 32, 64, 128",
          -2: "K and V (and the bias table) do not fit in shared memory "
              "at this source length and dot dtype",
          -3: "bf16 inputs need bf16 dots",
          -4: "the bf16-dot backward reads rows that start on 16 bytes: "
              "strides must be multiples of 16 bytes",
          -5: "the backward's w_drop scratch must follow its ds scratch"}

# The bf16-dot backward kernels (csrc/attention_bwd_mma.cuh) keep ds and
# w_drop in (B, H, T, Sp) scratch rows of whole 64-key blocks, and sum the
# relative-bias table gradient over at most TABLE_GROUPS groups of the batch.
KEY_BLOCK = 64
TABLE_GROUPS = 8


def scratch_cols(s: int) -> int:
    """Sp: the source length rounded up to whole key blocks."""
    return -(-s // KEY_BLOCK) * KEY_BLOCK


def bwd_scratch(b, h, t, s, dot_dtype, device):
    """The scratch of one backward call: ds and w_drop, B*H*T*Sp elements of
    the dot type each, w_drop right after ds in one allocation (the
    bf16-dot kernels first keep B*H*T*Sp f32 products dw * w there); and
    with bf16 dots the f32 scores and dropped do . v^T, B*H*T*Sp each, plus
    three B*H*T row statistics, else None."""
    n = b * h * t * scratch_cols(s)
    ds_wd = torch.empty(2 * n, dtype=dot_dtype, device=device)
    scores = (torch.empty(2 * n + 3 * b * h * t, dtype=torch.float32, device=device)
              if dot_dtype == torch.bfloat16 else None)
    return ds_wd[:n], ds_wd[n:], scores


def scratch_planes(x: torch.Tensor, b, h, t, s) -> torch.Tensor:
    """The (B, H, T, S) values of a ds or w_drop scratch of (B, H, T, Sp) rows."""
    return x.view(b, h, t, scratch_cols(s))[..., :s]


# The plain versions' f32 products ahead of a bf16 rounding point (the
# scores, the relative-bias columns, do . v^T) run on at most PLAIN_BATCH
# sequences at a time. On the card cuBLAS picks its kernel, and with it the
# order of each dot's sum, by the shape: on whole batches of 1,440 x 8
# heads and more at T = S = 4 it summed in another order than at the
# batches the kernels' chains were matched at, and softmax weights landed
# one bf16 step from the kernel's (chip_smoke.py phase 5 holds the
# forwards' weights bit for bit at every batch it times).
PLAIN_BATCH = 192


def batch_einsum(equation: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """torch.einsum(equation, x, y) over slices of at most PLAIN_BATCH along
    x's leading (batch) dimension, and y's where its subscripts start with
    the same letter."""
    b = x.shape[0]
    if b <= PLAIN_BATCH:
        return torch.einsum(equation, x, y)
    shared = equation.split(",")[1][0] == equation[0]
    return torch.cat([torch.einsum(equation, x[i:i + PLAIN_BATCH],
                                   y[i:i + PLAIN_BATCH] if shared else y)
                      for i in range(0, b, PLAIN_BATCH)])


def score_grads_plain(w, dod, vd, keep, inv):
    """The backward's f32 dropped weights w_drop and score gradient
    ds = w * (dw - sum_s dw * w), dw = keep * (do . v^T) * inv, from the f32
    softmax w and do, v already rounded to the dot type."""
    dw = batch_einsum("bhtd,bhsd->bhts", dod, vd)
    w_drop = w
    if keep is not None:
        w_drop = torch.where(keep, w * inv, 0.0)
        dw = torch.where(keep, dw * inv, 0.0)
    return w_drop, w * (dw - (dw * w).sum(-1, keepdim=True))


# ---- layouts ----------------------------------------------------------------

def heads(x: torch.Tensor, num_heads: Optional[int]) -> torch.Tensor:
    """A (B, H, L, d) view of x: x itself, or a view of packed (B, L, H*d)."""
    if num_heads is None:
        if x.dim() != 4:
            raise ValueError(f"expected (B, H, L, d), got {tuple(x.shape)}")
        return x
    if x.dim() != 3 or x.shape[-1] % num_heads:
        raise ValueError(f"expected packed (B, L, H*d) with H = {num_heads}, "
                         f"got {tuple(x.shape)}")
    return x.unflatten(-1, (num_heads, -1)).transpose(1, 2)


def unheads(x4: torch.Tensor, num_heads: Optional[int]) -> torch.Tensor:
    """Inverse of heads for a (B, H, L, d) result, contiguous."""
    if num_heads is None:
        return x4.contiguous()
    b, h, n, d = x4.shape
    return x4.transpose(1, 2).reshape(b, n, h * d)


def empty_like_layout(x: torch.Tensor, num_heads: Optional[int]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A contiguous tensor of x's shape and dtype, and its (B, H, L, d) view."""
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    return out, heads(out, num_heads)


def finite_mask(mask, t, s, device):
    """-inf becomes -1e30 so a fully masked row gives no NaN (the TPU
    wrapper's clamp, pallas_attention.py:60); None becomes zeros."""
    if mask is None:
        return torch.zeros((t, s), dtype=torch.float32, device=device)
    return torch.clamp(mask.float(), min=NEG_BIG)


# ---- launching ----------------------------------------------------------------

def check_inputs(q4, k4, v4, mask, dot_dtype, extra=()):
    """Shapes, devices, dtypes and strides every attention kernel takes;
    raises otherwise. `extra` holds further (name, view) pairs."""
    b, h, t, d = q4.shape
    s = k4.shape[2]
    if k4.shape != (b, h, s, d) or v4.shape != (b, h, s, d):
        raise ValueError(f"k {tuple(k4.shape)} / v {tuple(v4.shape)} do not "
                         f"match q {tuple(q4.shape)}")
    if dot_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dot_dtype must be bfloat16 or float32, not {dot_dtype}")
    if q4.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q, k, v must be float32 or bfloat16, not {q4.dtype}")
    for name, x in (("q", q4), ("k", k4), ("v", v4), *extra):
        if not x.is_cuda or x.device != q4.device:
            raise ValueError(f"{name} must lie on {q4.device} (got {x.device})")
        if x.dtype != q4.dtype or x.stride(-1) != 1:
            raise ValueError(f"{name} must be {q4.dtype} with a contiguous last "
                             f"axis (got {x.dtype}, strides {x.stride()})")
    if k4.stride() != v4.stride():
        raise ValueError("k and v must share one set of strides")
    if mask is not None and (mask.shape != (t, s) or mask.device != q4.device):
        raise ValueError(f"mask must be ({t}, {s}) on {q4.device}")


def typed(name: str, fn: str, n_ptrs: int) -> ctypes.CDLL:
    """The built library `name`, its entry point `fn` typed once."""
    lib = _build.library(name)
    if not getattr(lib, "_typed", False):
        f = getattr(lib, fn)
        f.argtypes = ([ctypes.c_void_p] * n_ptrs
                      + [ctypes.POINTER(ctypes.c_longlong)]
                      + [ctypes.c_int] * 7
                      + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
                         ctypes.c_int, ctypes.c_void_p])
        f.restype = ctypes.c_int
        lib._typed = True
    return lib


def strides(*views: Optional[torch.Tensor]) -> ctypes.Array:
    """The first three element strides of each view, in order: (batch, head,
    row) of a (B, H, L, d) view, (plane, row, column) of a (B*H, T, S) one;
    zeros for None."""
    vals = [x for v in views
            for x in (v.stride()[:3] if v is not None else (0, 0, 0))]
    return (ctypes.c_longlong * len(vals))(*vals)


def dropout_threshold(rate: float) -> int:
    """The uint32 keep threshold min(round(rate * 2**32), 2**32 - 1)."""
    return min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def kernel_args(q4, dot_dtype, dropout):
    """(in_bf16, bf16_dots, threshold, keep scale, dropout flag)."""
    inv = 1.0 / (1.0 - dropout) if dropout > 0.0 else 1.0
    return (int(q4.dtype == torch.bfloat16), int(dot_dtype == torch.bfloat16),
            dropout_threshold(dropout) if dropout > 0.0 else 0, inv,
            int(dropout > 0.0))


def raise_status(status: int, what: str, q4, s, dot_dtype) -> None:
    if status in ERRORS:
        raise ValueError(f"{what} (T={q4.shape[2]}, S={s}, d={q4.shape[3]}, "
                         f"{q4.dtype} inputs, {dot_dtype} dots): {ERRORS[status]}")
    _build.check(status, what)
