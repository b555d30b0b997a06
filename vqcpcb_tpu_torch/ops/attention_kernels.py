"""Relative-bias attention forward (counterpart of the relbias forward in
vqcpcb_tpu/ops/pallas_attention.py: fused_attention_train_relbias at
dropout 0, the route fused_attention takes for inference with e1 set).

    out = softmax(q.k^T + mask + bias) . v,
    bias[t, s] = q_t . E[s + (S-1) - t//r],  E = [e1; e2[1:]],  r = T/S

`relbias_attention_fwd` routes by device: a CPU tensor takes the plain
PyTorch version, a CUDA tensor launches csrc/relbias_attention.cu or raises.
Both round q, k, v and E to `dot_dtype` before the products (f32
accumulation), keep the softmax in f32, round the weights to `dot_dtype`
before w.v and return q's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from vqcpcb_tpu_torch.ops import _build

NEG_BIG = -1e30

# Launches of the CUDA kernel since the last reset.
launches = 0

_ERRORS = {-1: "head dim must be one of 8, 16, 32, 64, 128",
           -2: "K, V and the bias table do not fit in shared memory at this "
               "source length and dot dtype"}


def combined_table(e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """(H, S, d) x2 -> (H, 2S-1, d): row j of head h is e1[h, j] for j < S and
    e2[h, j - (S-1)] above (pallas_attention.py:_relbias_pack_e, unpadded)."""
    return torch.cat([e1, e2[:, 1:]], dim=1)


def relbias_attention_fwd_plain(q, k, v, mask, e1, e2,
                                dot_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: q (B, H, T, d) already scaled;
    k, v (B, H, S, d); mask (T, S) additive or None; e1, e2 (H, S, d).
    Returns (B, H, T, d) in q.dtype (pallas_attention.py:_relbias_fwd_head)."""
    b, h, t, d = q.shape
    s = k.shape[2]
    ratio = t // s
    mask = _finite_mask(mask, t, s, q.device)
    rd = lambda x: x.to(dot_dtype).float()                 # noqa: E731
    qd, kd, vd = rd(q), rd(k), rd(v)
    table = rd(combined_table(e1, e2))                       # (H, 2S-1, d)
    scores = torch.einsum("bhtd,bhsd->bhts", qd, kd)
    c = torch.einsum("bhtd,hjd->bhtj", qd, table)            # (B, H, T, 2S-1)
    cols = (torch.arange(s, device=q.device)[None, :]
            + (s - 1) - torch.arange(t, device=q.device)[:, None] // ratio)
    bias = torch.gather(c, 3, cols.expand(b, h, t, s))
    w = torch.softmax(scores + mask + bias, dim=-1)
    out = torch.einsum("bhts,bhsd->bhtd", rd(w), vd)
    return out.to(q.dtype)


def _finite_mask(mask, t, s, device):
    """-inf becomes -1e30 so a fully masked row gives no NaN (the TPU
    wrapper's clamp, pallas_attention.py:60)."""
    if mask is None:
        return torch.zeros((t, s), dtype=torch.float32, device=device)
    return torch.clamp(mask.float(), min=NEG_BIG)


def _lib():
    lib = _build.library("relbias_attention")
    if not getattr(lib, "_typed", False):
        lib.relbias_attention_fwd.argtypes = ([ctypes.c_void_p] * 6
                                              + [ctypes.c_int] * 6
                                              + [ctypes.c_void_p])
        lib.relbias_attention_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def relbias_attention_fwd_cuda(q, k, v, mask, e1, e2,
                               dot_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch csrc/relbias_attention.cu on contiguous f32 CUDA tensors."""
    global launches
    b, h, t, d = q.shape
    s = k.shape[2]
    if k.shape != (b, h, s, d) or v.shape != (b, h, s, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if e1.shape != (h, s, d) or e2.shape != (h, s, d):
        raise ValueError(f"e1/e2 must be (H, S, d) = {(h, s, d)}")
    if t % s:
        raise ValueError(f"target length {t} is not a multiple of {s}")
    if dot_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dot_dtype must be bfloat16 or float32, not {dot_dtype}")
    for name, x in (("q", q), ("k", k), ("v", v), ("e1", e1), ("e2", e2)):
        if (not x.is_cuda or x.device != q.device or x.dtype != torch.float32
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{q.device} (got {x.dtype} on {x.device})")
    if mask is not None and (mask.shape != (t, s) or mask.device != q.device):
        raise ValueError(f"mask must be ({t}, {s}) on {q.device}")
    mask = _finite_mask(mask, t, s, q.device).contiguous()
    table = combined_table(e1, e2).contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _lib().relbias_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        table.data_ptr(), out.data_ptr(), b, h, t, s, d,
        int(dot_dtype == torch.bfloat16), stream)
    if status in _ERRORS:
        raise ValueError(f"relbias_attention (T={t}, S={s}, d={d}, "
                         f"{dot_dtype}): {_ERRORS[status]}")
    _build.check(status, "relbias_attention")
    launches += 1
    return out


def relbias_attention_fwd(q, k, v, mask, e1, e2,
                          dot_dtype=torch.bfloat16) -> torch.Tensor:
    """Relative-bias attention forward; see the module docstring. The plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return relbias_attention_fwd_plain(q, k, v, mask, e1, e2, dot_dtype)
    return relbias_attention_fwd_cuda(q, k, v, mask, e1, e2, dot_dtype)
