"""Relative-bias attention, forward and backward, with in-kernel dropout
(counterpart of vqcpcb_tpu/ops/pallas_attention.py: the relbias kernels
`_relbias_fwd_kernel[_packed]` / `_relbias_bwd_kernel[_packed]`, their
per-head math `_relbias_fwd_head` / `_relbias_bwd_head`, and the dropout
hash `_hash_u32` / `_dropout_keep`).

    w   = softmax(q.k^T + mask + bias),  bias[t, s] = q_t . E[s + (S-1) - t//r]
    out = dropout(w) . v,                E = [e1; e2[1:]],  r = T/S

Layouts: with `num_heads=None` q is (B, H, T, d) and k, v are (B, H, S, d);
with `num_heads=H` they are packed (B, T, H*d) and (B, S, H*d) -- the
in-projection's output reshaped, never transposed -- and results come back
packed. The CUDA kernels read any view whose last axis is contiguous through
(batch, head, row) strides, so a k or v slice of a (B, S, 3*H*d) projection
is read in place.

Dropout (rate > 0) is the TPU kernels' counter-based hash: the (b, h) plane
of the mask is `dropout_keep_plain((T, S), rate, seed + h*B + b)`, bit for
bit the JAX mask, regenerated by the backward.

Each wrapper routes by device: a CPU tensor takes the plain PyTorch version,
a CUDA tensor launches csrc/relbias_attention.cu (forward: with bf16 dots
the kernel of csrc/attention_fwd_mma.cuh, w.v on the tensor cores, with f32
dots the 3xTF32 tensor-core kernel of csrc/attention_fwd_f32.cuh with the
bias window streamed beside K) or csrc/relbias_attention_bwd.cu (backward:
with bf16 dots the tensor-core rows, cols, table and table-sum kernels of
csrc/attention_bwd_mma.cuh, with f32 dots the streamed rows kernel of
csrc/attention_bwd_f32.cuh and two CUDA-core kernels) or raises; no f32-dot
kernel's shared memory grows with S. Both
round q, k, v, E (and do) to `dot_dtype` before the products with f32
accumulation, keep the softmax in f32, and return the input dtype.
`RelbiasAttention` is the autograd Function pairing the two.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from vqcpcb_tpu_torch.ops._kernel_io import (
    MASK32, TABLE_GROUPS, batch_einsum, bwd_scratch, check_inputs,
    dropout_threshold, empty_like_layout, finite_mask, heads, kernel_args,
    raise_status, score_grads_plain, strides, typed, unheads)

# Launches since the last reset: forward kernel calls, and backward wrapper
# calls (each launches the backward's kernels in turn); of those, the ones
# with f32 dots (VQCPCB_PALLAS_BF16_DOTS=0), whose kernels are their own.
launches = 0
bwd_launches = 0
launches_f32 = 0
bwd_launches_f32 = 0


# ---- dropout hash (pallas_attention.py:158-191) -----------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 on uint32 values held in int64 (pallas_attention.py:158)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_keep_plain(shape: Tuple[int, int], rate: float, seed,
                       device=None) -> torch.Tensor:
    """Regenerable dropout mask, True = keep (pallas_attention.py:170).

    shape: (T, S); seed: an int or an integer tensor of stream indices
    (wrapping uint32 arithmetic). Returns bool of seed.shape + (T, S):
    lowbias32((t*S + s) ^ lowbias32(seed * 0x9E3779B9)) >= threshold."""
    t, s = shape
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device) & MASK32
    rows = torch.arange(t, dtype=torch.int64, device=seed.device)[:, None]
    cols = torch.arange(s, dtype=torch.int64, device=seed.device)[None, :]
    idx = (rows * s + cols) & MASK32
    seed_h = _hash_u32(_mul32(seed, 0x9E3779B9))[..., None, None]
    return _hash_u32(idx ^ seed_h) >= dropout_threshold(rate)


def _stream_seeds(seed: int, b: int, h: int, device) -> torch.Tensor:
    """(B, H) stream indices seed + h*B + b (pallas_attention.py:574,883)."""
    bi = torch.arange(b, dtype=torch.int64, device=device)[:, None]
    hi = torch.arange(h, dtype=torch.int64, device=device)[None, :]
    return int(seed) + hi * b + bi


# ---- the relative-bias table ---------------------------------------------------

def combined_table(e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """(H, S, d) x2 -> (H, 2S-1, d): row j of head h is e1[h, j] for j < S and
    e2[h, j - (S-1)] above (pallas_attention.py:_relbias_pack_e, unpadded)."""
    return torch.cat([e1, e2[:, 1:]], dim=1)


def split_table_grad(de: torch.Tensor, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, 2S-1, d) table gradient -> (de1, de2); e2's offset-0 row is never
    addressed, so its gradient is 0 (pallas_attention.py:1029-1036)."""
    zero = torch.zeros_like(de[:, :1])
    return de[:, :s], torch.cat([zero, de[:, s:]], dim=1)


def _bias_columns(t: int, s: int, device) -> torch.Tensor:
    """(T, S) column of the combined table read at (t, s): s + (S-1) - t//r."""
    ratio = t // s
    return (torch.arange(s, device=device)[None, :] + (s - 1)
            - torch.arange(t, device=device)[:, None] // ratio)


# ---- plain versions -----------------------------------------------------------

def _plain_weights(qd, kd, mask, table):
    """f32 softmax of the scores, from inputs already rounded to the dot
    type; also returns the gather index of the bias."""
    b, h, t, _ = qd.shape
    s = kd.shape[2]
    scores = batch_einsum("bhtd,bhsd->bhts", qd, kd)
    c = batch_einsum("bhtd,hjd->bhtj", qd, table)            # (B, H, T, 2S-1)
    cols = _bias_columns(t, s, qd.device).expand(b, h, t, s)
    bias = torch.gather(c, 3, cols)
    mask = finite_mask(mask, t, s, qd.device)
    return torch.softmax(scores + mask + bias, dim=-1), cols


def _plain_keep(b, h, t, s, dropout, seed, device):
    if dropout <= 0.0:
        return None, 1.0
    keep = dropout_keep_plain((t, s), dropout, _stream_seeds(seed, b, h, device))
    inv = torch.tensor(1.0 / (1.0 - dropout), dtype=torch.float32)
    return keep, inv


def relbias_attention_fwd_plain(q, k, v, mask, e1, e2,
                                dot_dtype=torch.bfloat16, *,
                                num_heads: Optional[int] = None,
                                dropout: float = 0.0, seed: int = 0
                                ) -> torch.Tensor:
    """The forward kernel's arithmetic in PyTorch: q already scaled; mask
    (T, S) additive or None; e1, e2 (H, S, d). Returns q's layout and dtype
    (pallas_attention.py:_relbias_fwd_head)."""
    q4, k4, v4 = (heads(x, num_heads) for x in (q, k, v))
    b, h, t, _ = q4.shape
    s = k4.shape[2]
    rd = lambda x: x.to(dot_dtype).float()                 # noqa: E731
    w, _ = _plain_weights(rd(q4), rd(k4), mask, rd(combined_table(e1, e2)))
    keep, inv = _plain_keep(b, h, t, s, dropout, seed, q.device)
    if keep is not None:
        w = torch.where(keep, w * inv, 0.0)
    out = torch.einsum("bhts,bhsd->bhtd", rd(w), rd(v4))
    return unheads(out.to(q.dtype), num_heads)


def relbias_attention_bwd_weights_plain(q, k, v, mask, e1, e2, dout,
                                        dot_dtype=torch.bfloat16, *,
                                        num_heads: Optional[int] = None,
                                        dropout: float = 0.0, seed: int = 0):
    """The f32 (B, H, T, S) dropped weights w_drop and score gradient ds of
    relbias_attention_bwd_plain, which the bf16-dot kernels round to bf16
    into their scratch before dv and dq, dk, dE."""
    q4, k4, v4, do4 = (heads(x, num_heads) for x in (q, k, v, dout))
    b, h, t, _ = q4.shape
    rd = lambda x: x.to(dot_dtype).float()                 # noqa: E731
    w, _ = _plain_weights(rd(q4), rd(k4), mask, rd(combined_table(e1, e2)))
    keep, inv = _plain_keep(b, h, t, k4.shape[2], dropout, seed, q.device)
    return score_grads_plain(w, rd(do4), rd(v4), keep, inv)


def relbias_attention_bwd_plain(q, k, v, mask, e1, e2, dout,
                                dot_dtype=torch.bfloat16, *,
                                num_heads: Optional[int] = None,
                                dropout: float = 0.0, seed: int = 0,
                                need_dmask: bool = True):
    """The backward kernels' arithmetic in PyTorch
    (pallas_attention.py:_relbias_bwd_head and _fused_relbias_packed_bwd).
    Returns (dq, dk, dv, dmask, de1, de2): dq, dk, dv in the inputs' layout
    and dtype, dmask (T, S) f32 summed over (b, h) or None, de1 and de2
    (H, S, d) summed over the batch, in q's dtype."""
    q4, k4, do4 = (heads(x, num_heads) for x in (q, k, dout))
    b, h, t, d = q4.shape
    s = k4.shape[2]
    rd = lambda x: x.to(dot_dtype).float()                 # noqa: E731
    qd, kd, dod = rd(q4), rd(k4), rd(do4)
    table = rd(combined_table(e1, e2))
    cols = _bias_columns(t, s, q.device).expand(b, h, t, s)
    w_drop, ds = relbias_attention_bwd_weights_plain(
        q, k, v, mask, e1, e2, dout, dot_dtype, num_heads=num_heads,
        dropout=dropout, seed=seed)
    dv = torch.einsum("bhts,bhtd->bhsd", rd(w_drop), dod)
    ds_d = rd(ds)
    dc = torch.zeros((b, h, t, 2 * s - 1), dtype=ds_d.dtype, device=ds_d.device)
    dc.scatter_(3, cols, ds_d)                               # dc[t, s + shift(t)]
    dq = (torch.einsum("bhts,bhsd->bhtd", ds_d, kd)
          + torch.einsum("bhtj,hjd->bhtd", dc, table))
    dk = torch.einsum("bhts,bhtd->bhsd", ds_d, qd)
    de = torch.einsum("bhtj,bhtd->hjd", dc, qd)
    de1, de2 = split_table_grad(de.to(q.dtype), s)
    dmask = ds.sum((0, 1)) if need_dmask else None
    return (unheads(dq.to(q.dtype), num_heads),
            unheads(dk.to(k.dtype), num_heads),
            unheads(dv.to(v.dtype), num_heads), dmask, de1, de2)


# ---- CUDA launchers -----------------------------------------------------------

def _check_cuda(q4, k4, v4, e1, e2, mask, dot_dtype, extra=()):
    """What the relative-bias kernels take besides check_inputs: the
    (H, S, d) tables on q's device and T a multiple of S."""
    check_inputs(q4, k4, v4, mask, dot_dtype, extra)
    b, h, t, d = q4.shape
    s = k4.shape[2]
    if e1.shape != (h, s, d) or e2.shape != (h, s, d):
        raise ValueError(f"e1/e2 must be (H, S, d) = {(h, s, d)}")
    for name, x in (("e1", e1), ("e2", e2)):
        if x.device != q4.device:
            raise ValueError(f"{name} must lie on {q4.device} (got {x.device})")
    if s == 0 or t % s:
        raise ValueError(f"target length {t} is not a multiple of {s}")


def relbias_attention_fwd_cuda(q, k, v, mask, e1, e2,
                               dot_dtype=torch.bfloat16, *,
                               num_heads: Optional[int] = None,
                               dropout: float = 0.0, seed: int = 0
                               ) -> torch.Tensor:
    """Launch csrc/relbias_attention.cu; see the module docstring."""
    global launches, launches_f32
    q4, k4, v4 = (heads(x, num_heads) for x in (q, k, v))
    _check_cuda(q4, k4, v4, e1, e2, mask, dot_dtype)
    b, h, t, d = q4.shape
    s = k4.shape[2]
    mask = finite_mask(mask, t, s, q.device).contiguous()
    table = combined_table(e1, e2).float().contiguous()
    out, out4 = empty_like_layout(q, num_heads)
    in_bf16, bf16_dots, threshold, inv, drop = kernel_args(q4, dot_dtype, dropout)
    lib = typed("relbias_attention", "relbias_attention_fwd", 6)
    status = lib.relbias_attention_fwd(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), mask.data_ptr(),
        table.data_ptr(), out.data_ptr(), strides(q4, k4, out4),
        b, h, t, s, d, in_bf16, bf16_dots, int(seed) & MASK32, threshold, inv,
        drop, torch.cuda.current_stream(q.device).cuda_stream)
    raise_status(status, "relbias_attention_fwd", q4, s, dot_dtype)
    launches += 1
    launches_f32 += not bf16_dots
    return out


def relbias_attention_bwd_cuda(q, k, v, mask, e1, e2, dout,
                               dot_dtype=torch.bfloat16, *,
                               num_heads: Optional[int] = None,
                               dropout: float = 0.0, seed: int = 0,
                               need_dmask: bool = True, scratch=None):
    """Launch csrc/relbias_attention_bwd.cu; returns what
    relbias_attention_bwd_plain returns. `scratch` is bwd_scratch's triple
    for these shapes, or None to allocate one; with bf16 dots its ds and
    w_drop hold the bf16 values of relbias_attention_bwd_weights_plain's
    results afterwards (with f32 dots, the f32 values, row stride S)."""
    global bwd_launches, bwd_launches_f32
    q4, k4, v4, do4 = (heads(x, num_heads) for x in (q, k, v, dout))
    _check_cuda(q4, k4, v4, e1, e2, mask, dot_dtype, extra=(("dout", do4),))
    b, h, t, d = q4.shape
    s = k4.shape[2]
    if do4.shape != q4.shape:
        raise ValueError(f"dout {tuple(dout.shape)} does not match q {tuple(q.shape)}")
    mask = finite_mask(mask, t, s, q.device).contiguous()
    # in the dot type: the bf16-dot kernels stage it as it is
    table = combined_table(e1, e2).to(dot_dtype).contiguous()
    dq, dq4 = empty_like_layout(q, num_heads)
    dk, dk4 = empty_like_layout(k, num_heads)
    dv = torch.empty_like(dk)
    dmask = (torch.zeros((t, s), dtype=torch.float32, device=q.device)
             if need_dmask else None)
    de = torch.empty((h, 2 * s - 1, d), dtype=torch.float32, device=q.device)
    # the table kernel's per-group sums, then with bf16 dots dq's f32 ds.k part
    de_partial = torch.empty(
        min(b, TABLE_GROUPS) * de.numel()
        + (b * h * t * d if dot_dtype == torch.bfloat16 else 0),
        dtype=torch.float32, device=q.device)
    if scratch is None:
        scratch = bwd_scratch(b, h, t, s, dot_dtype, q.device)
    ds_scratch, wd_scratch, sc_scratch = scratch
    in_bf16, bf16_dots, threshold, inv, drop = kernel_args(q4, dot_dtype, dropout)
    lib = typed("relbias_attention_bwd", "relbias_attention_bwd", 15)
    status = lib.relbias_attention_bwd(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), mask.data_ptr(),
        table.data_ptr(), do4.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), 0 if dmask is None else dmask.data_ptr(),
        de.data_ptr(), de_partial.data_ptr(), ds_scratch.data_ptr(),
        wd_scratch.data_ptr(), 0 if sc_scratch is None else sc_scratch.data_ptr(),
        strides(q4, k4, do4, dq4, dk4), b, h, t, s, d, in_bf16, bf16_dots,
        int(seed) & MASK32, threshold, inv, drop,
        torch.cuda.current_stream(q.device).cuda_stream)
    raise_status(status, "relbias_attention_bwd", q4, s, dot_dtype)
    bwd_launches += 1
    bwd_launches_f32 += not bf16_dots
    de1, de2 = split_table_grad(de.to(q.dtype), s)
    return dq, dk, dv, dmask, de1, de2


# ---- routing ------------------------------------------------------------------

def relbias_attention_fwd(q, k, v, mask, e1, e2, dot_dtype=torch.bfloat16, *,
                          num_heads: Optional[int] = None, dropout: float = 0.0,
                          seed: int = 0) -> torch.Tensor:
    """Relative-bias attention forward; see the module docstring. The plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    fn = (relbias_attention_fwd_plain if q.device.type == "cpu"
          else relbias_attention_fwd_cuda)
    return fn(q, k, v, mask, e1, e2, dot_dtype, num_heads=num_heads,
              dropout=dropout, seed=seed)


def relbias_attention_bwd(q, k, v, mask, e1, e2, dout,
                          dot_dtype=torch.bfloat16, *,
                          num_heads: Optional[int] = None, dropout: float = 0.0,
                          seed: int = 0, need_dmask: bool = True):
    """Relative-bias attention backward; see relbias_attention_bwd_plain.
    The plain version for CPU tensors, the CUDA kernels for CUDA tensors."""
    fn = (relbias_attention_bwd_plain if q.device.type == "cpu"
          else relbias_attention_bwd_cuda)
    return fn(q, k, v, mask, e1, e2, dout, dot_dtype, num_heads=num_heads,
              dropout=dropout, seed=seed, need_dmask=need_dmask)


class RelbiasAttention(torch.autograd.Function):
    """Differentiable relative-bias attention: forward and backward are the
    wrappers above (kernels on CUDA, plain versions on the CPU), the
    counterpart of fused_attention_train_relbias[_packed]'s custom VJP. The
    mask's gradient is computed only when the mask requires one. Arguments:
    (q, k, v, mask, e1, e2, num_heads, dropout, seed, dot_dtype)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, e1, e2, num_heads, dropout, seed,
                dot_dtype):
        ctx.save_for_backward(q, k, v, mask, e1, e2)
        ctx.config = dict(num_heads=num_heads, dropout=dropout, seed=seed)
        ctx.dot_dtype = dot_dtype
        return relbias_attention_fwd(q, k, v, mask, e1, e2, dot_dtype,
                                     **ctx.config)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, e1, e2 = ctx.saved_tensors
        dq, dk, dv, dmask, de1, de2 = relbias_attention_bwd(
            q, k, v, mask, e1, e2, dout.to(q.dtype).contiguous(), ctx.dot_dtype,
            need_dmask=mask is not None and ctx.needs_input_grad[3],
            **ctx.config)
        return dq, dk, dv, dmask, de1, de2, None, None, None, None


# ---- K7: the shard wrappers (pallas_attention.py:1045, :1085) ----------------
#
# Under a (data, model) mesh each rank holds its rows of the batch and, with
# a model axis, its contiguous block of heads: packed q, k, v are its
# (b_local, L, h_local*d) columns (head-aligned: heads are contiguous d-wide
# blocks of E), e1 and e2 its (h_local, S, d) tables. A K7 wrapper runs the
# kernel on those planes with the dropout seed offset per shard, as JAX's
# shard_map `local()` does, so that its (b, h) plane draws stream
# seed + shard*(b_local*h_local) + h*b_local + b. The union of the shards'
# masks is not the unsharded mask: a TP step with dropout equals JAX's TP
# step, not the one-device step. At dropout 0 each plane is computed on its
# own, so the shards' results are the unsharded kernel's, bit for bit.

# K7 wrapper calls on CUDA tensors since the last reset, packed and (B, H, L,
# d); each launches the forward kernel and, in the backward, the backward's.
tp_launches = 0
tp_bhld_launches = 0


def shard_seed(seed: int, mesh, b_local: int, h_local: int) -> int:
    """The seed of this rank's shard: seed + shard * (b_local * h_local),
    shard = data_index * n_model + model_index (pallas_attention.py:
    1068-1071; wrapped to 32 bits by the kernels and the hash)."""
    return int(seed) + mesh.rank * b_local * h_local


def relbias_attention_packed_tp(mesh, q, k, v, mask, e1, e2, num_heads: int,
                                dropout: float, seed: int,
                                dot_dtype=torch.bfloat16) -> torch.Tensor:
    """fused_attention_train_relbias_packed_tp's counterpart: RelbiasAttention
    (K2 on CUDA, its plain version on the CPU) on this rank's packed
    (b_local, L, num_heads*d) blocks and (num_heads, S, d) tables, num_heads
    the local head count, at the shard's seed; differentiable."""
    global tp_launches
    out = RelbiasAttention.apply(q, k, v, mask, e1, e2, num_heads, dropout,
                                 shard_seed(seed, mesh, q.shape[0], num_heads),
                                 dot_dtype)
    if q.device.type != "cpu":
        tp_launches += 1
    return out


def relbias_attention_tp(mesh, q, k, v, mask, e1, e2, dropout: float,
                         seed: int, dot_dtype=torch.bfloat16) -> torch.Tensor:
    """fused_attention_train_relbias_tp's counterpart: the same on this
    rank's (b_local, h_local, L, d) planes (K3's layout)."""
    global tp_bhld_launches
    b, h = q.shape[:2]
    out = RelbiasAttention.apply(q, k, v, mask, e1, e2, None, dropout,
                                 shard_seed(seed, mesh, b, h), dot_dtype)
    if q.device.type != "cpu":
        tp_bhld_launches += 1
    return out


def relbias_attention_tp_plain(mesh, q, k, v, mask, e1, e2, dout,
                               dot_dtype=torch.bfloat16, *,
                               num_heads: Optional[int] = None,
                               dropout: float = 0.0, seed: int = 0,
                               need_dmask: bool = False):
    """The K7 wrappers' plain version, packed (num_heads = the local head
    count) or (B, H, L, d) (None): [out, dq, dk, dv, dmask, de1, de2] of
    the plain forward and backward on this rank's blocks at the shard's
    seed."""
    h = num_heads or q.shape[1]
    kw = dict(num_heads=num_heads, dropout=dropout,
              seed=shard_seed(seed, mesh, q.shape[0], h))
    return [relbias_attention_fwd_plain(q, k, v, mask, e1, e2, dot_dtype, **kw),
            *relbias_attention_bwd_plain(q, k, v, mask, e1, e2, dout, dot_dtype,
                                         need_dmask=need_dmask, **kw)]
