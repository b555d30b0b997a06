"""Fused attention with an explicit bias, forward and backward, with
in-kernel dropout (counterpart of vqcpcb_tpu/ops/pallas_attention.py: the
inference kernel `_kernel` behind `fused_attention` (K4), and the kernels
`_train_fwd_kernel`, `_train_bwd_kernel` and `_train_bwd_kernel_nobias`
behind the custom VJP `fused_attention_train` (K6)).

    w   = softmax(q.k^T + mask + bias)
    out = dropout(w) . v

q is already scaled; mask is an additive (T, S) mask or None (zeros),
clamped to -1e30 so a fully masked row gives no NaN; bias is None (no
bias), the (B*H, 1, 1) placeholder, or a real (B*H, T, S) f32 bias (JAX
builds it by the skew of the relative embeddings when the in-kernel relbias
is off, pallas_attention.py:66-67, attention.py:305-306). Layouts are those
of attention_kernels.py: (B, H, L, d) with `num_heads=None`, else packed
(B, L, H*d); the CUDA kernels read any view whose last axis is contiguous
through (batch, head, row) strides.

Rounding: K4 (`fused_attention`) is f32 throughout, as the TPU kernel
(pallas_attention.py:33-41). K6 (`fused_attention_train_*`) rounds q, k, v
and do to `dot_dtype` (bf16 on the card, f32 on the CPU, as RelbiasAttention
does), keeps the scores, the softmax, the dropout and
ds = w * (dw - sum(dw * w)) in f32, and rounds w_drop before dv and ds
before dq and dk (:196-241). Dropout is the relbias kernels' hash
(attention_kernels.dropout_keep_plain) on K6's flat grid: the (b, h) plane
uses stream seed + b*H + h (:203-204), not the relbias kernels'
seed + h*B + b.

Each wrapper routes by device: a CPU tensor takes the plain PyTorch version,
a CUDA tensor launches csrc/fused_attention.cu (K4, and K6-fwd with f32
dots: the 3xTF32 tensor-core kernel of csrc/attention_fwd_f32.cuh; K6-fwd
with bf16 dots, the kernel of csrc/attention_fwd_mma.cuh) or
csrc/fused_attention_bwd.cu (K6-bwd with a real bias, K6-bwd-nobias
otherwise: tensor-core kernels with bf16 dots; with f32 dots the streamed
rows kernel of csrc/attention_bwd_f32.cuh and a CUDA-core cols kernel) or
raises. `FusedAttentionTrain` is the autograd Function pairing
the K6 forward and backward.
"""
from __future__ import annotations

from typing import Optional

import torch

from vqcpcb_tpu_torch.ops._kernel_io import (
    MASK32, batch_einsum, bwd_scratch, check_inputs, empty_like_layout,
    finite_mask, heads, kernel_args, raise_status, score_grads_plain, strides,
    typed, unheads)
from vqcpcb_tpu_torch.ops.attention_kernels import dropout_keep_plain, shard_seed

# Launches since the last reset: K4; K6's forward; K6's backward with a real
# bias, and with the placeholder (each launches a rows and a cols kernel);
# K6's forward and backward calls (either bias) with f32 dots among them.
launches = 0
train_fwd_launches = 0
train_bwd_launches = 0
train_bwd_nobias_launches = 0
train_fwd_launches_f32 = 0
train_bwd_launches_f32 = 0


def flat_stream_seeds(seed: int, b: int, h: int, device) -> torch.Tensor:
    """(B, H) stream indices seed + b*H + h: K6's program_id over the flat
    (B*H,) grid (pallas_attention.py:203-204)."""
    bi = torch.arange(b, dtype=torch.int64, device=device)[:, None]
    hi = torch.arange(h, dtype=torch.int64, device=device)[None, :]
    return int(seed) + bi * h + hi


def is_real_bias(bias: Optional[torch.Tensor], t: int, s: int) -> bool:
    """A (B*H, T, S) bias, whose cotangent is the score gradient; anything
    else is the placeholder, whose cotangent is zero (pallas_attention.py:357)."""
    return bias is not None and tuple(bias.shape[1:]) == (t, s)


# ---- plain versions -----------------------------------------------------------

def _plain_weights(qd, kd, mask, bias):
    """f32 softmax of (q.k^T + mask) + bias from inputs already rounded."""
    b, h, t, _ = qd.shape
    s = kd.shape[2]
    scores = batch_einsum("bhtd,bhsd->bhts", qd, kd) + finite_mask(mask, t, s, qd.device)
    if bias is not None:
        scores = scores + bias.float().reshape(b, h, bias.shape[1], bias.shape[2])
    return torch.softmax(scores, dim=-1)


def _plain_keep(b, h, t, s, dropout, seed, device):
    if dropout <= 0.0:
        return None, 1.0
    keep = dropout_keep_plain((t, s), dropout, flat_stream_seeds(seed, b, h, device))
    return keep, torch.tensor(1.0 / (1.0 - dropout), dtype=torch.float32)


def fused_attention_train_fwd_plain(q, k, v, mask, bias=None,
                                    dot_dtype=torch.bfloat16, *,
                                    num_heads: Optional[int] = None,
                                    dropout: float = 0.0, seed: int = 0
                                    ) -> torch.Tensor:
    """K6's forward in PyTorch (pallas_attention.py:_train_fwd_kernel).
    Returns q's layout and dtype."""
    q4, k4, v4 = (heads(x, num_heads) for x in (q, k, v))
    b, h, t, _ = q4.shape
    s = k4.shape[2]
    rd = lambda x: x.to(dot_dtype).float()                 # noqa: E731
    w = _plain_weights(rd(q4), rd(k4), mask, bias)
    keep, inv = _plain_keep(b, h, t, s, dropout, seed, q.device)
    if keep is not None:
        w = torch.where(keep, w * inv, 0.0)
    out = torch.einsum("bhts,bhsd->bhtd", rd(w), rd(v4))
    return unheads(out.to(q.dtype), num_heads)


def fused_attention_plain(q, k, v, mask, bias=None) -> torch.Tensor:
    """K4 in PyTorch (pallas_attention.py:_kernel): q, k, v (B, H, L, d),
    f32 throughout, the result in q's dtype."""
    return fused_attention_train_fwd_plain(q, k, v, mask, bias, torch.float32)


def fused_attention_train_bwd_weights_plain(q, k, v, mask, bias, dout,
                                            dot_dtype=torch.bfloat16, *,
                                            num_heads: Optional[int] = None,
                                            dropout: float = 0.0, seed: int = 0):
    """The f32 (B, H, T, S) dropped weights w_drop and score gradient ds of
    fused_attention_train_bwd_plain, which the bf16-dot kernels round to
    bf16 into their scratch before dv and dq, dk."""
    q4, k4, v4, do4 = (heads(x, num_heads) for x in (q, k, v, dout))
    b, h, t, _ = q4.shape
    rd = lambda x: x.to(dot_dtype).float()                 # noqa: E731
    w = _plain_weights(rd(q4), rd(k4), mask, bias)
    keep, inv = _plain_keep(b, h, t, k4.shape[2], dropout, seed, q.device)
    return score_grads_plain(w, rd(do4), rd(v4), keep, inv)


def fused_attention_train_bwd_plain(q, k, v, mask, bias, dout,
                                    dot_dtype=torch.bfloat16, *,
                                    num_heads: Optional[int] = None,
                                    dropout: float = 0.0, seed: int = 0,
                                    need_dmask: bool = True):
    """K6's backward in PyTorch (pallas_attention.py:_train_bwd_kernel and
    _train_bwd_kernel_nobias). Returns (dq, dk, dv, dmask, dbias): dq, dk, dv
    in the inputs' layout and dtype; dmask (T, S) f32 summed over (b, h), or
    None; dbias the f32 (B*H, T, S) score gradient for a real bias, None for
    the placeholder."""
    q4, k4, do4 = (heads(x, num_heads) for x in (q, k, dout))
    b, h, t, _ = q4.shape
    s = k4.shape[2]
    rd = lambda x: x.to(dot_dtype).float()                 # noqa: E731
    qd, kd, dod = rd(q4), rd(k4), rd(do4)
    w_drop, ds = fused_attention_train_bwd_weights_plain(
        q, k, v, mask, bias, dout, dot_dtype, num_heads=num_heads,
        dropout=dropout, seed=seed)
    dv = torch.einsum("bhts,bhtd->bhsd", rd(w_drop), dod)
    ds_d = rd(ds)
    dq = torch.einsum("bhts,bhsd->bhtd", ds_d, kd)
    dk = torch.einsum("bhts,bhtd->bhsd", ds_d, qd)
    dmask = ds.sum((0, 1)) if need_dmask else None
    dbias = ds.reshape(b * h, t, s) if is_real_bias(bias, t, s) else None
    return (unheads(dq.to(q.dtype), num_heads),
            unheads(dk.to(k.dtype), num_heads),
            unheads(dv.to(v.dtype), num_heads), dmask, dbias)


# ---- CUDA launchers -----------------------------------------------------------

def _check_cuda(q4, k4, v4, mask, bias, dot_dtype, extra=()):
    """What the fused kernels take (check_inputs, a non-empty source, and
    the bias); raises otherwise. Returns the bias as a (B*H, T, S) view
    (zero strides where it broadcasts), or None."""
    check_inputs(q4, k4, v4, mask, dot_dtype, extra)
    b, h, t, _ = q4.shape
    s = k4.shape[2]
    if s == 0:
        raise ValueError("empty source")
    if bias is None:
        return None
    if (bias.dim() != 3 or bias.shape[0] != b * h or bias.shape[1] not in (1, t)
            or bias.shape[2] not in (1, s)):
        raise ValueError(f"bias must be (B*H, T, S) = {(b * h, t, s)} or "
                         f"(B*H, 1, 1), not {tuple(bias.shape)}")
    if bias.dtype != torch.float32 or bias.device != q4.device:
        raise ValueError(f"bias must be float32 on {q4.device}")
    return bias.expand(b * h, t, s)


def _fwd_cuda(q, k, v, mask, bias, dot_dtype, num_heads, dropout, seed):
    q4, k4, v4 = (heads(x, num_heads) for x in (q, k, v))
    bias3 = _check_cuda(q4, k4, v4, mask, bias, dot_dtype)
    b, h, t, d = q4.shape
    s = k4.shape[2]
    mask = finite_mask(mask, t, s, q.device).contiguous()
    out, out4 = empty_like_layout(q, num_heads)
    in_bf16, bf16_dots, threshold, inv, drop = kernel_args(q4, dot_dtype, dropout)
    lib = typed("fused_attention", "fused_attention_fwd", 6)
    status = lib.fused_attention_fwd(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), mask.data_ptr(),
        0 if bias3 is None else bias3.data_ptr(), out.data_ptr(),
        strides(q4, k4, out4, bias3), b, h, t, s, d, in_bf16, bf16_dots,
        int(seed) & MASK32, threshold, inv, drop,
        torch.cuda.current_stream(q.device).cuda_stream)
    raise_status(status, "fused_attention_fwd", q4, s, dot_dtype)
    return out


def fused_attention_cuda(q, k, v, mask, bias=None) -> torch.Tensor:
    """K4: launch csrc/fused_attention.cu with f32 dots and no dropout."""
    global launches
    out = _fwd_cuda(q, k, v, mask, bias, torch.float32, None, 0.0, 0)
    launches += 1
    return out


def fused_attention_train_fwd_cuda(q, k, v, mask, bias=None,
                                   dot_dtype=torch.bfloat16, *,
                                   num_heads: Optional[int] = None,
                                   dropout: float = 0.0, seed: int = 0
                                   ) -> torch.Tensor:
    """K6's forward: launch csrc/fused_attention.cu."""
    global train_fwd_launches, train_fwd_launches_f32
    out = _fwd_cuda(q, k, v, mask, bias, dot_dtype, num_heads, dropout, seed)
    train_fwd_launches += 1
    train_fwd_launches_f32 += dot_dtype == torch.float32
    return out


def fused_attention_train_bwd_cuda(q, k, v, mask, bias, dout,
                                   dot_dtype=torch.bfloat16, *,
                                   num_heads: Optional[int] = None,
                                   dropout: float = 0.0, seed: int = 0,
                                   need_dmask: bool = True, scratch=None):
    """K6's backward: launch csrc/fused_attention_bwd.cu; returns what
    fused_attention_train_bwd_plain returns. `scratch` is bwd_scratch's
    triple for these shapes, or None to allocate one; with bf16 dots its ds
    and w_drop hold the bf16 values of
    fused_attention_train_bwd_weights_plain's results afterwards (with f32
    dots, the f32 values, row stride S)."""
    global train_bwd_launches, train_bwd_nobias_launches, train_bwd_launches_f32
    q4, k4, v4, do4 = (heads(x, num_heads) for x in (q, k, v, dout))
    bias3 = _check_cuda(q4, k4, v4, mask, bias, dot_dtype, extra=(("dout", do4),))
    b, h, t, d = q4.shape
    s = k4.shape[2]
    if do4.shape != q4.shape:
        raise ValueError(f"dout {tuple(dout.shape)} does not match q {tuple(q.shape)}")
    real = is_real_bias(bias, t, s)
    mask = finite_mask(mask, t, s, q.device).contiguous()
    dq, dq4 = empty_like_layout(q, num_heads)
    dk, dk4 = empty_like_layout(k, num_heads)
    dv = torch.empty_like(dk)
    dmask = (torch.zeros((t, s), dtype=torch.float32, device=q.device)
             if need_dmask else None)
    dbias = (torch.empty((b * h, t, s), dtype=torch.float32, device=q.device)
             if real else None)
    if scratch is None:
        scratch = bwd_scratch(b, h, t, s, dot_dtype, q.device)
    ds_scratch, wd_scratch, sc_scratch = scratch
    in_bf16, bf16_dots, threshold, inv, drop = kernel_args(q4, dot_dtype, dropout)
    lib = typed("fused_attention_bwd", "fused_attention_bwd", 14)
    status = lib.fused_attention_bwd(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), mask.data_ptr(),
        0 if bias3 is None else bias3.data_ptr(), do4.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        0 if dbias is None else dbias.data_ptr(),
        0 if dmask is None else dmask.data_ptr(), ds_scratch.data_ptr(),
        wd_scratch.data_ptr(), 0 if sc_scratch is None else sc_scratch.data_ptr(),
        strides(q4, k4, do4, dq4, dk4, bias3),
        b, h, t, s, d, in_bf16, bf16_dots, int(seed) & MASK32, threshold,
        inv, drop, torch.cuda.current_stream(q.device).cuda_stream)
    raise_status(status, "fused_attention_bwd", q4, s, dot_dtype)
    if real:
        train_bwd_launches += 1
    else:
        train_bwd_nobias_launches += 1
    train_bwd_launches_f32 += not bf16_dots
    return dq, dk, dv, dmask, dbias


# ---- routing ------------------------------------------------------------------

def fused_attention(q, k, v, mask, bias=None) -> torch.Tensor:
    """K4, inference: the plain version for CPU tensors, the kernel for CUDA
    tensors."""
    fn = fused_attention_plain if q.device.type == "cpu" else fused_attention_cuda
    return fn(q, k, v, mask, bias)


def fused_attention_train_fwd(q, k, v, mask, bias=None, dot_dtype=torch.bfloat16,
                              **kw) -> torch.Tensor:
    """K6's forward; see fused_attention_train_fwd_plain."""
    fn = (fused_attention_train_fwd_plain if q.device.type == "cpu"
          else fused_attention_train_fwd_cuda)
    return fn(q, k, v, mask, bias, dot_dtype, **kw)


def fused_attention_train_bwd(q, k, v, mask, bias, dout, dot_dtype=torch.bfloat16,
                              **kw):
    """K6's backward; see fused_attention_train_bwd_plain."""
    fn = (fused_attention_train_bwd_plain if q.device.type == "cpu"
          else fused_attention_train_bwd_cuda)
    return fn(q, k, v, mask, bias, dout, dot_dtype, **kw)


class FusedAttentionTrain(torch.autograd.Function):
    """Differentiable fused attention, the counterpart of
    fused_attention_train's custom VJP: forward and backward are the K6
    wrappers above (kernels on CUDA, plain versions on the CPU). The
    placeholder bias (None or (B*H, 1, 1)) gets a zero cotangent, a real
    (B*H, T, S) bias the f32 score gradient; the mask's gradient is computed
    only when the mask requires one. Arguments: (q, k, v, mask, bias,
    num_heads, dropout, seed, dot_dtype)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, bias, num_heads, dropout, seed, dot_dtype):
        ctx.save_for_backward(q, k, v, mask, bias)
        ctx.config = dict(num_heads=num_heads, dropout=dropout, seed=seed)
        ctx.dot_dtype = dot_dtype
        return fused_attention_train_fwd(q, k, v, mask, bias, dot_dtype,
                                         **ctx.config)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, bias = ctx.saved_tensors
        dq, dk, dv, dmask, dbias = fused_attention_train_bwd(
            q, k, v, mask, bias, dout.to(q.dtype).contiguous(), ctx.dot_dtype,
            need_dmask=mask is not None and ctx.needs_input_grad[3],
            **ctx.config)
        if bias is not None and ctx.needs_input_grad[4]:
            dbias = (torch.zeros_like(bias) if dbias is None
                     else dbias.to(bias.dtype))
        else:
            dbias = None
        return dq, dk, dv, dmask, dbias, None, None, None, None


# ---- K7: the shard wrapper (pallas_attention.py:1122) ------------------------

# fused_attention_train_tp calls on CUDA tensors since the last reset
train_tp_launches = 0


def fused_attention_train_tp(mesh, q, k, v, mask, bias, num_heads: Optional[int],
                             dropout: float, seed: int,
                             dot_dtype=torch.bfloat16) -> torch.Tensor:
    """fused_attention_train_tp's counterpart: FusedAttentionTrain (K6 on
    CUDA, its plain version on the CPU) on this rank's (b_local, h_local)
    planes, packed (num_heads = h_local) or (B, H, L, d) (None), with its
    bias planes (b_local*h_local, T, S), the placeholder or None, at the
    shard's seed (attention_kernels.shard_seed): plane (b, h) draws stream
    seed + shard*(b_local*h_local) + b*h_local + h (:1152-1157);
    differentiable."""
    global train_tp_launches
    h = num_heads or q.shape[1]
    out = FusedAttentionTrain.apply(q, k, v, mask, bias, num_heads, dropout,
                                    shard_seed(seed, mesh, q.shape[0], h),
                                    dot_dtype)
    if q.device.type != "cpu":
        train_tp_launches += 1
    return out


def fused_attention_train_tp_plain(mesh, q, k, v, mask, bias, dout,
                                   dot_dtype=torch.bfloat16, *,
                                   num_heads: Optional[int] = None,
                                   dropout: float = 0.0, seed: int = 0,
                                   need_dmask: bool = False):
    """fused_attention_train_tp's plain version: [out, dq, dk, dv, dmask,
    dbias] of K6's plain forward and backward at the shard's seed."""
    h = num_heads or q.shape[1]
    kw = dict(num_heads=num_heads, dropout=dropout,
              seed=shard_seed(seed, mesh, q.shape[0], h))
    return [fused_attention_train_fwd_plain(q, k, v, mask, bias, dot_dtype, **kw),
            *fused_attention_train_bwd_plain(q, k, v, mask, bias, dout, dot_dtype,
                                             need_dmask=need_dmask, **kw)]
