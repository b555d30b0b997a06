"""Multi-head attention with the subsampled relative bias (counterpart of
vqcpcb_tpu/ops/attention.py:MultiheadAttention).

Parameters keep the reference layout: in_proj_weight (3E, E) with [q|k|v]
rows, in_proj_bias (3E,), out_proj, and attn_bias.e1 / attn_bias.e2 stored
heads-major as (H*S, hd). q is scaled by hd**-0.5 before the bias, so the
bias sees the scaled q.

Routes of the full forward:
  * train mode: the packed route of the JAX module (attention.py:188-231,
    255-318). The in-projection's (B, L, 3E) output is sliced, never
    transposed (a cross-attention projects q from the query and k, v from
    the key); q is scaled before any bias. Without the relative bias the
    attention is FusedAttentionTrain (ops/fused_attention_kernels.py, K6)
    with the zero placeholder bias; with it, RelbiasAttention
    (ops/attention_kernels.py), or, with the in-kernel relbias off
    (utils.relbias_in_kernel), FusedAttentionTrain with the bias built in
    PyTorch (in f32, as JAX's skew) so autograd carries e1 and e2. The
    kernels take bf16 dots on CUDA, the plain versions f32 on the CPU; both
    apply the attention-weight dropout in-kernel. No weights are returned.
    The dropout seed is drawn on the host from `seed_generator` (torch's
    default CPU generator when None), so no device value is read per layer;
  * inference on CUDA: K4 (fused_attention, f32 dots) without the relative
    bias, or with the bias built in PyTorch when the in-kernel relbias is
    off; the relative-bias forward kernel (bf16 dots) with it. No weights
    are returned -- the routes the JAX module takes on the TPU
    (attention.py:243-253);
  * inference on the CPU: the plain path, f32 throughout, returning the
    weights.
`step` (one query position over the KV cache) is plain PyTorch on every
device, as it is plain XLA in JAX.

The projections (in_proj, out_proj) compute in utils.layer_compute_dtype,
bf16 under VQCPCB_COMPUTE_DTYPE=bfloat16 or the decoder trainer's scope, as
JAX's DenseGeneral(dtype=compute_dtype()); q, k and v are then bf16, and
the scores, the softmax and w.v accumulate in f32 on every route.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vqcpcb_tpu_torch.ops.attention_kernels import (RelbiasAttention,
                                                    relbias_attention_fwd)
from vqcpcb_tpu_torch.ops.fused_attention_kernels import (FusedAttentionTrain,
                                                          fused_attention)
from vqcpcb_tpu_torch.ops.kv_cache import Cache, cache_prefix, dequantize_kv
from vqcpcb_tpu_torch.ops.relative_attention import (
    subsampled_relative_bias, subsampled_relative_bias_row)
from vqcpcb_tpu_torch.utils import dense, relbias_in_kernel

RELATIVE_BIAS_TYPES = ("relative_attention", "relative_attention_target_source")


class RelativeBias(nn.Module):
    """Learned causal (e1) and anticausal (e2) embeddings, (H*S, hd) each."""

    def __init__(self, num_heads: int, seq_len_src: int, head_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.e1 = nn.Parameter(torch.randn(num_heads * seq_len_src, head_dim))
        self.e2 = nn.Parameter(torch.randn(num_heads * seq_len_src, head_dim))

    def tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """e1, e2 as (H, S, hd)."""
        h = self.num_heads
        return (self.e1.view(h, -1, self.e1.shape[-1]),
                self.e2.view(h, -1, self.e2.shape[-1]))


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int,
                 attention_bias_type: Optional[str] = None,
                 num_channels_k: int = 1, num_events_k: int = 1,
                 num_channels_q: int = 1, num_events_q: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.seed_generator: Optional[torch.Generator] = None
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        nn.init.xavier_uniform_(self.in_proj_weight)
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.out_proj.weight)
        nn.init.zeros_(self.out_proj.bias)
        if attention_bias_type is None:
            self.attn_bias = None
        elif attention_bias_type in RELATIVE_BIAS_TYPES:
            seq_len_src = num_channels_k * num_events_k
            seq_len_tgt = num_channels_q * num_events_q
            if seq_len_tgt % seq_len_src:
                raise ValueError(f"target length {seq_len_tgt} is not a "
                                 f"multiple of source length {seq_len_src}")
            self.attn_bias = RelativeBias(num_heads, seq_len_src, self.head_dim)
        else:
            raise NotImplementedError(
                f"Not a valid type of attention bias: {attention_bias_type}")

    def _split_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        return x.view(b, n, self.num_heads, self.head_dim).transpose(1, 2)

    def project_q(self, query: torch.Tensor) -> torch.Tensor:
        """(B, L, E) -> scaled q (B, H, L, hd), in the compute dtype."""
        e = self.embed_dim
        q = dense(query, self.in_proj_weight[:e], self.in_proj_bias[:e])
        return self._split_heads(q * self.head_dim ** -0.5)

    def project_kv(self, key: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S, E) -> k, v each (B, H, S, hd), in the compute dtype."""
        e = self.embed_dim
        kv = dense(key, self.in_proj_weight[e:], self.in_proj_bias[e:])
        return self._split_heads(kv[..., :e]), self._split_heads(kv[..., e:])

    def _out_proj(self, out: torch.Tensor) -> torch.Tensor:
        return dense(out, self.out_proj.weight, self.out_proj.bias)

    def _merge_heads(self, out: torch.Tensor) -> torch.Tensor:
        b, h, t, d = out.shape
        return self._out_proj(out.transpose(1, 2).reshape(b, t, h * d))

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """query (B, L_tgt, E), key (= value) (B, L_src, E), attn_mask an
        additive (L_tgt, L_src) mask or None. Returns (output (B, L_tgt, E),
        weights (B, H, L_tgt, L_src) on the plain inference path, None on the
        kernel and training paths). Train mode takes the training route."""
        if self.training:
            return self._train_packed(query, key, attn_mask), None
        return self.attend(self.project_q(query), *self.project_kv(key),
                           attn_mask)

    def _explicit_bias(self, q4: torch.Tensor) -> torch.Tensor:
        """The relative bias as a (B*H, T, S) f32 tensor, from the scaled q
        (B, H, T, hd) (attention.py:305-306): computed in f32 whatever q's
        dtype, as JAX's skew promotes to its f32 tables."""
        b, h, t, _ = q4.shape
        bias = subsampled_relative_bias(q4.float(), *self.attn_bias.tables())
        return bias.reshape(b * h, t, bias.shape[-1])

    def _train_packed(self, query: torch.Tensor, key: torch.Tensor,
                      attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The packed training route (attention.py:188-231, 255-318)."""
        e, h = self.embed_dim, self.num_heads
        if key is query:
            qkv = dense(query, self.in_proj_weight, self.in_proj_bias)
            q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
        else:
            q = dense(query, self.in_proj_weight[:e], self.in_proj_bias[:e])
            kv = dense(key, self.in_proj_weight[e:], self.in_proj_bias[e:])
            k, v = kv[..., :e], kv[..., e:]                # views of (B, S, 2E)
        q = q * self.head_dim ** -0.5                        # (B, T, E)
        seed = 0
        if self.dropout > 0.0:
            seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                     generator=self.seed_generator))
        dot_dtype = torch.float32 if q.device.type == "cpu" else torch.bfloat16
        if self.attn_bias is not None and relbias_in_kernel():
            e1, e2 = self.attn_bias.tables()
            out = RelbiasAttention.apply(q, k, v, attn_mask, e1, e2, h,
                                         float(self.dropout), seed, dot_dtype)
        else:
            bias = (None if self.attn_bias is None else
                    self._explicit_bias(q.unflatten(-1, (h, -1)).transpose(1, 2)))
            out = FusedAttentionTrain.apply(q, k, v, attn_mask, bias, h,
                                            float(self.dropout), seed, dot_dtype)
        return self._out_proj(out)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               attn_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The forward after the projections: scaled q (B, H, L_tgt, hd), k and
        v (B, H, L_src, hd) as project_q / project_kv give them. A prefill
        that also keeps k and v for the cache projects them once and calls
        this. Projections in bf16 are attended in f32 (exactly their
        values): the scores accumulate in f32 as JAX's
        preferred_element_type has them, and on the CPU the weights are
        rounded to v's dtype before w.v, as JAX rounds them."""
        v_dtype = v.dtype
        q, k, v = q.float(), k.float(), v.float()
        if q.device.type != "cpu":
            if self.attn_bias is None:
                out = fused_attention(q, k, v, attn_mask)
            elif relbias_in_kernel():
                e1, e2 = self.attn_bias.tables()
                out = relbias_attention_fwd(q.contiguous(), k.contiguous(),
                                            v.contiguous(), attn_mask,
                                            e1.contiguous(), e2.contiguous(),
                                            dot_dtype=torch.bfloat16)
            else:
                out = fused_attention(q, k, v, attn_mask, self._explicit_bias(q))
            return self._merge_heads(out), None
        scores = torch.einsum("bhtd,bhsd->bhts", q, k)
        if attn_mask is not None:
            scores = scores + attn_mask
        if self.attn_bias is not None:
            scores = scores + subsampled_relative_bias(q, *self.attn_bias.tables())
        weights = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhts,bhsd->bhtd", weights.to(v_dtype).float(), v)
        return self._merge_heads(out), weights

    def step(self, query_t: torch.Tensor, k_cache: Cache, v_cache: Cache,
             t: int, seq_len_tgt: int,
             key_len_mask: Optional[torch.Tensor] = None,
             causal: bool = True) -> torch.Tensor:
        """Attend from one query position over cached keys and values.

        query_t (B, 1, E) at target position t; caches (B, H, S, hd) or int8
        tuples. causal: the rule keys <= t, for which only rows [0, t] are
        read; key_len_mask: (S,) bool of visible keys, or None for all.
        Returns (B, 1, E) (attention.py:354)."""
        q = self.project_q(query_t)[:, :, 0].float()          # (B, H, hd)
        if causal:
            k_cache = cache_prefix(k_cache, t + 1)
            v_cache = cache_prefix(v_cache, t + 1)
        k = dequantize_kv(k_cache).float()
        v = dequantize_kv(v_cache)
        v_dtype, v = v.dtype, v.float()
        s = k.shape[2]
        scores = torch.einsum("bhd,bhsd->bhs", q, k)
        if self.attn_bias is not None:
            e1, e2 = self.attn_bias.tables()
            scores = scores + subsampled_relative_bias_row(
                q, e1, e2, t, seq_len_tgt)[..., :s]
        if key_len_mask is not None:
            scores = scores.masked_fill(~key_len_mask, float("-inf"))
        weights = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhs,bhsd->bhd", weights.to(v_dtype).float(), v)
        b, h, d = out.shape
        return self._out_proj(out.reshape(b, 1, h * d))

