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
    kernels take bf16 dots on CUDA (f32 under VQCPCB_PALLAS_BF16_DOTS=0,
    utils.train_dot_dtype), the plain versions f32 on the CPU; both
    apply the attention-weight dropout in-kernel. No weights are returned.
    The dropout seed is drawn on the host from `seed_generator` (torch's
    default CPU generator when None), so no device value is read per layer;
  * inference on CUDA: K4 (fused_attention, f32 dots) without the relative
    bias, or with the bias built in PyTorch when the in-kernel relbias is
    off; the relative-bias forward kernel (K3, bf16 dots, f32 under
    VQCPCB_PALLAS_BF16_DOTS=0 as JAX's K3 reads the knob,
    pallas_attention.py:725) with it. No weights are returned -- the routes
    the JAX module takes on the TPU (attention.py:243-253). A caller that
    asks for the weights (need_weights, which the stacks' collect_attentions
    sets) gets the plain path below on the card instead, and the weights;
    every other forward launches the kernels. JAX picks this route with
    its VQCPCB_PALLAS_ATTENTION switch for every forward of the process;
    the port reads no such switch. Unlike JAX, grouped layers take the
    kernels too unless the weights are asked for (JAX returns their weights
    on the TPU, attention.py:243);
  * inference on the CPU: the plain path, f32 throughout, returning the
    weights whatever need_weights says.
`step` (one query position over the KV cache) is plain PyTorch on every
device, as it is plain XLA in JAX.

Grouped-query attention (num_kv_heads, JAX's attention.py:40-66): K and V
get num_kv_heads heads, query head h reading KV head h // g for
g = num_heads / num_kv_heads. A grouped module has separate projections
q_proj (E -> E) and kv_proj (E -> 2 * H_kv * hd, k's heads then v's) in
place of in_proj_weight / in_proj_bias, which stay exactly as they are when
num_kv_heads is None (or equal to num_heads). project_kv gives H_kv heads,
so the caches hold H_kv heads and `step` reads them with the grouped
einsum. The full forward expands k and v to H heads before the kernels
(`expand_kv_heads`; autograd sums dk and dv over each group), so every
route above serves grouped layers unchanged.

The projections (in_proj, out_proj) compute in utils.layer_compute_dtype,
bf16 under VQCPCB_COMPUTE_DTYPE=bfloat16 or the decoder trainer's scope, as
JAX's DenseGeneral(dtype=compute_dtype()); q, k and v are then bf16, and
the scores, the softmax and w.v accumulate in f32 on every route.

Under a mesh (parallel/mesh.py; `set_mesh`, which shard_params calls) the
training route, and under a model axis also the eval forward, run through
the K7 shard wrappers (relbias_attention_packed_tp, fused_attention_train_tp)
on this rank's rows, with the dropout seed offset per shard, as JAX routes
through its `_tp` wrappers (attention.py:195-230, 270-316); the seed is
still drawn on the host, the same on every rank. With a model axis whose
size divides the heads the module holds num_heads / m query heads: its
in_proj rows are the [q; k; v] blocks of its heads, q_proj's its heads,
e1 / e2 its tables, out_proj's columns its heads' (row-parallel, reduced
over `model`, its bias added after the reduce). Grouped, kv_proj holds
num_kv_heads / m KV heads when those divide too -- a query head's KV head
then lies on its rank (JAX's mesh.py:135-152) -- and is otherwise
replicated, each rank reading the KV heads of its query heads, its
gradient summed over `model`. Heads that do not divide the model axis keep
the attention replicated, every rank computing it at its data shard's
offsets; out_proj, split when E divides, then takes this rank's columns.

The KV-cached paths (project_q, project_kv, attend, step: a sampler's
prefill and decode steps) and the eval forward without gradients run
under a model axis on this rank's heads: q of its query heads, k and v of
the KV heads its caches hold (`cache_heads`: its block of the KV heads,
or, grouped with a replicated kv_proj, the KV head of each of its query
heads, as _kv_mesh picks them), its relative-bias tables, and the out
projection row-parallel (`_project_out`). On the card the prefill's
attention launches K3-fwd (or K4 without the bias) on the rank's own
(b_local, h_local) planes, each equal to the unsharded kernel's plane, as
JAX's inference path computes the whole (attention.py:239-252, which falls
back to XLA under a mesh). Under a data axis alone a rank runs its rows
with the unsharded code.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vqcpcb_tpu_torch.ops.attention_kernels import (
    RelbiasAttention, relbias_attention_fwd, relbias_attention_packed_tp)
from vqcpcb_tpu_torch.ops.fused_attention_kernels import (
    FusedAttentionTrain, fused_attention, fused_attention_train_tp)
from vqcpcb_tpu_torch.ops.kv_cache import Cache, cache_prefix, dequantize_kv
from vqcpcb_tpu_torch.ops.relative_attention import (
    subsampled_relative_bias, subsampled_relative_bias_row)
from vqcpcb_tpu_torch.parallel.collectives import (copy_to_model, row_parallel,
                                                   split_to_model)
from vqcpcb_tpu_torch.utils import dense, relbias_in_kernel, train_dot_dtype

RELATIVE_BIAS_TYPES = ("relative_attention", "relative_attention_target_source")


class RelativeBias(nn.Module):
    """Learned causal (e1) and anticausal (e2) embeddings, (H*S, hd) each
    (under a model axis, the module's num_heads local heads)."""

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


def expand_kv_heads(x: torch.Tensor, num_kv_heads: int, g: int) -> torch.Tensor:
    """K or V of num_kv_heads heads, packed (B, S, H_kv * hd) or (B, H_kv,
    S, hd), -> the same layout with each head repeated g times in place,
    query head h reading KV head h // g (attention.py:324-325)."""
    if g == 1:
        return x
    if x.dim() == 3:
        b, s, _ = x.shape
        return x.view(b, s, num_kv_heads, 1, -1).expand(
            b, s, num_kv_heads, g, x.shape[-1] // num_kv_heads).reshape(b, s, -1)
    b, _, s, d = x.shape
    return x[:, :, None].expand(b, num_kv_heads, g, s, d).reshape(
        b, num_kv_heads * g, s, d)


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int,
                 attention_bias_type: Optional[str] = None,
                 num_channels_k: int = 1, num_events_k: int = 1,
                 num_channels_q: int = 1, num_events_q: int = 1,
                 dropout: float = 0.0, num_kv_heads: Optional[int] = None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads {num_heads} is not a multiple of "
                             f"num_kv_heads {self.num_kv_heads}")
        self.group = num_heads // self.num_kv_heads
        self.dropout = dropout
        self.seed_generator: Optional[torch.Generator] = None
        # set by set_mesh: the mesh, and which parameters the model axis split
        self.mesh = None
        self.tp_heads = self.tp_kv = self.tp_out = False
        if self.grouped:
            self.q_proj = nn.Linear(embed_dim, embed_dim)
            self.kv_proj = nn.Linear(embed_dim,
                                     2 * self.num_kv_heads * self.head_dim)
            for proj in (self.q_proj, self.kv_proj):
                nn.init.xavier_uniform_(proj.weight)
                nn.init.zeros_(proj.bias)
        else:
            self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                           embed_dim))
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

    @property
    def grouped(self) -> bool:
        return self.num_kv_heads != self.num_heads

    def set_mesh(self, mesh, specs) -> None:
        """Run under `mesh` with the blocks shard_params left; specs: this
        module's parameters' Splits, by name (parallel/mesh.py)."""
        self.mesh = mesh
        q_name = "q_proj.weight" if self.grouped else "in_proj_weight"
        self.tp_heads = specs.get(q_name) is not None
        self.tp_kv = self.grouped and specs.get("kv_proj.weight") is not None
        self.tp_out = specs.get("out_proj.weight") is not None
        if self.attn_bias is not None and self.tp_heads:
            self.attn_bias.num_heads = self.num_heads // mesh.n_model

    @property
    def _model_axis(self) -> bool:
        return self.mesh is not None and self.mesh.n_model > 1

    @property
    def cache_heads(self) -> int:
        """The KV heads this rank's caches hold (project_kv's): every KV
        head off a model axis or where the heads do not split; its block of
        them where kv_proj (or in_proj) splits; grouped with a replicated
        kv_proj, one for each of its query heads."""
        if not (self._model_axis and self.tp_heads):
            return self.num_kv_heads
        m = self.mesh.n_model
        if self.grouped and self.tp_kv:
            return self.num_kv_heads // m
        return self.num_heads // m

    def _split_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        return x.view(b, n, -1, self.head_dim).transpose(1, 2)

    def _q_packed(self, query: torch.Tensor) -> torch.Tensor:
        """(B, L, E) -> unscaled q (B, L, E), in the compute dtype."""
        if self.grouped:
            return dense(query, self.q_proj.weight, self.q_proj.bias)
        e = self.in_proj_weight.shape[0] // 3
        return dense(query, self.in_proj_weight[:e], self.in_proj_bias[:e])

    def _kv_packed(self, key: torch.Tensor, sum_grads_over=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S, E) -> k, v each (B, S, H_kv * hd), views of one product in
        the compute dtype. sum_grads_over: a mesh whose model ranks each
        read part of a replicated kv_proj, whose gradient is summed over
        `model` (copy_to_model on the weights)."""
        if self.grouped:
            w, b = self.kv_proj.weight, self.kv_proj.bias
            if sum_grads_over is not None:
                w, b = (copy_to_model(x, sum_grads_over) for x in (w, b))
            kv = dense(key, w, b)
        else:
            e = self.in_proj_weight.shape[0] // 3
            kv = dense(key, self.in_proj_weight[e:], self.in_proj_bias[e:])
        return kv.chunk(2, dim=-1)

    def project_q(self, query: torch.Tensor) -> torch.Tensor:
        """(B, L, E) -> scaled q (B, H, L, hd), in the compute dtype; under
        a model axis that splits the heads, this rank's H / m heads."""
        return self._split_heads(self._q_packed(query) * self.head_dim ** -0.5)

    def project_kv(self, key: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S, E) -> k, v each (B, cache_heads, S, hd), in the compute
        dtype: every KV head, or under a model axis those of this rank."""
        if (self._model_axis and self.tp_heads and self.grouped
                and not self.tp_kv):
            # a replicated kv_proj: the KV head of each of this rank's
            # query heads
            k, v = self._kv_mesh(key, self.num_heads // self.mesh.n_model)
        else:
            k, v = self._kv_packed(key)
        return self._split_heads(k), self._split_heads(v)

    def _out_proj(self, out: torch.Tensor) -> torch.Tensor:
        return dense(out, self.out_proj.weight, self.out_proj.bias)

    def _project_out(self, out: torch.Tensor) -> torch.Tensor:
        """The out projection of the attention's packed output (B, T, h *
        hd): under a model axis row-parallel over this rank's heads (or, with
        replicated heads and a split out_proj, over its columns of them),
        reduced over `model`, the bias added once."""
        if not (self._model_axis and (self.tp_heads or self.tp_out)):
            return self._out_proj(out)
        if not self.tp_heads:
            out = split_to_model(out, self.mesh)
        return row_parallel(out, self.out_proj.weight, self.out_proj.bias,
                            self.mesh)

    def _merge_heads(self, out: torch.Tensor) -> torch.Tensor:
        b, h, t, d = out.shape
        return self._project_out(out.transpose(1, 2).reshape(b, t, h * d))

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                need_weights: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """query (B, L_tgt, E), key (= value) (B, L_src, E), attn_mask an
        additive (L_tgt, L_src) mask or None. Returns (output (B, L_tgt, E),
        weights (B, H, L_tgt, L_src) on the plain inference path, which the
        CPU and need_weights take, None on the kernel and training paths).
        Train mode takes the training route, and
        so does eval under a model axis with gradients on, at dropout 0
        (its backward needs the Megatron collectives); eval without them
        attends on this rank's heads, as a sampler's prefill does."""
        if self.training:
            return self._train_packed(query, key, attn_mask), None
        if self._model_axis and torch.is_grad_enabled():
            return self._train_mesh(query, key, attn_mask, 0.0), None
        return self.attend(self.project_q(query), *self.project_kv(key),
                           attn_mask, need_weights)

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
        if self.mesh is not None and self.mesh.size > 1:
            return self._train_mesh(query, key, attn_mask, self.dropout)
        e, h = self.embed_dim, self.num_heads
        if key is query and not self.grouped:
            qkv = dense(query, self.in_proj_weight, self.in_proj_bias)
            q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
        else:
            q = self._q_packed(query)
            k, v = (expand_kv_heads(x, self.num_kv_heads, self.group)
                    for x in self._kv_packed(key))    # (B, S, E) each
        q = q * self.head_dim ** -0.5                        # (B, T, E)
        seed = self._draw_seed(self.dropout)
        dot_dtype = train_dot_dtype(q.device)
        if dot_dtype == torch.float32:
            q, k, v = q.float(), k.float(), v.float()
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

    def _draw_seed(self, dropout: float) -> int:
        """The layer's dropout seed, drawn on the host (0 without dropout)."""
        if dropout <= 0.0:
            return 0
        return int(torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=self.seed_generator))

    def _kv_mesh(self, key: torch.Tensor, h: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """k, v packed (B, S, h * hd) for this rank's h query heads."""
        mesh, g = self.mesh, self.group
        if not self.grouped:
            return self._kv_packed(key)
        if self.tp_kv or not self.tp_heads:
            kv_heads = self.num_kv_heads // (mesh.n_model if self.tp_kv else 1)
            return tuple(expand_kv_heads(x, kv_heads, g)
                         for x in self._kv_packed(key))
        # replicated kv_proj under split query heads: this rank's query
        # heads read KV heads h // g of the whole set
        b, s, _ = key.shape
        index = torch.div(mesh.model_index * h
                          + torch.arange(h, device=key.device), g,
                          rounding_mode="floor")
        return tuple(x.view(b, s, self.num_kv_heads, -1)[:, :, index].reshape(b, s, -1)
                     for x in self._kv_packed(key, sum_grads_over=mesh))

    def _train_mesh(self, query: torch.Tensor, key: torch.Tensor,
                    attn_mask: Optional[torch.Tensor],
                    dropout: float) -> torch.Tensor:
        """The packed route under a mesh: this rank's rows and, with split
        heads, its heads, through the K7 wrappers; see the module
        docstring."""
        mesh = self.mesh
        tp = self.tp_heads
        h = self.num_heads // mesh.n_model if tp else self.num_heads
        self_attention = key is query
        if tp:
            query = copy_to_model(query, mesh)
            key = query if self_attention else copy_to_model(key, mesh)
        if self_attention and not self.grouped:
            q, k, v = dense(query, self.in_proj_weight,
                            self.in_proj_bias).chunk(3, dim=-1)
        else:
            q = self._q_packed(query)
            k, v = self._kv_mesh(key, h)
        q = q * self.head_dim ** -0.5
        seed = self._draw_seed(dropout)
        dot_dtype = train_dot_dtype(q.device)
        if dot_dtype == torch.float32:
            q, k, v = q.float(), k.float(), v.float()
        shards = mesh if tp else mesh.data_only()
        if self.attn_bias is not None and relbias_in_kernel():
            e1, e2 = self.attn_bias.tables()
            out = relbias_attention_packed_tp(shards, q, k, v, attn_mask, e1, e2,
                                              h, float(dropout), seed, dot_dtype)
        else:
            bias = (None if self.attn_bias is None else
                    self._explicit_bias(q.unflatten(-1, (h, -1)).transpose(1, 2)))
            out = fused_attention_train_tp(shards, q, k, v, attn_mask, bias, h,
                                           float(dropout), seed, dot_dtype)
        return self._project_out(out)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               attn_mask: Optional[torch.Tensor] = None,
               need_weights: bool = False
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The forward after the projections: scaled q (B, H, L_tgt, hd), k and
        v (B, H, L_src, hd) as project_q / project_kv give them. A prefill
        that also keeps k and v for the cache projects them once and calls
        this. Projections in bf16 are attended in f32 (exactly their
        values): the scores accumulate in f32 as JAX's
        preferred_element_type has them, and on the CPU the weights are
        rounded to v's dtype before w.v, as JAX rounds them. Grouped k and
        v (fewer heads than q) are expanded to q's heads first. Under a
        model axis q, k and v are this rank's heads (project_q /
        project_kv), and the kernels run on its planes. Returns the merged
        output and, on the plain path (the CPU, or the card with
        need_weights), the f32 weights (B, H, L_tgt, L_src); None from the
        kernels."""
        g = q.shape[1] // k.shape[1]
        k, v = (expand_kv_heads(x, x.shape[1], g) for x in (k, v))
        v_dtype = v.dtype
        q, k, v = q.float(), k.float(), v.float()
        if q.device.type != "cpu" and not need_weights:
            if self.attn_bias is None:
                out = fused_attention(q, k, v, attn_mask)
            elif relbias_in_kernel():
                e1, e2 = self.attn_bias.tables()
                out = relbias_attention_fwd(q.contiguous(), k.contiguous(),
                                            v.contiguous(), attn_mask,
                                            e1.contiguous(), e2.contiguous(),
                                            dot_dtype=train_dot_dtype(q.device))
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

        query_t (B, 1, E) at target position t; caches (B, H_kv, S, hd) or
        int8 tuples. causal: the rule keys <= t, for which only rows [0, t]
        are read; key_len_mask: (S,) bool of visible keys, or None for all.
        Caches are read with the grouped einsum (attention.py:386-411, g = 1
        when ungrouped), never expanded. Under a model axis the query heads,
        the caches and the tables are this rank's, and the out projection
        is row-parallel. Returns (B, 1, E) (attention.py:354)."""
        q = self.project_q(query_t)[:, :, 0].float()          # (B, H, hd)
        if causal:
            k_cache = cache_prefix(k_cache, t + 1)
            v_cache = cache_prefix(v_cache, t + 1)
        k = dequantize_kv(k_cache).float()
        v = dequantize_kv(v_cache)
        v_dtype, v = v.dtype, v.float()
        s = k.shape[2]
        b, h, d = q.shape
        kv = k.shape[1]
        g = h // kv                                         # 1 ungrouped
        scores = torch.einsum("bkgd,bksd->bkgs", q.view(b, kv, g, d),
                              k).reshape(b, h, s)
        if self.attn_bias is not None:
            e1, e2 = self.attn_bias.tables()
            scores = scores + subsampled_relative_bias_row(
                q, e1, e2, t, seq_len_tgt)[..., :s]
        if key_len_mask is not None:
            scores = scores.masked_fill(~key_len_mask, float("-inf"))
        weights = torch.softmax(scores, dim=-1).to(v_dtype).float()
        out = torch.einsum("bkgs,bksd->bkgd", weights.view(b, kv, g, s), v)
        return self._project_out(out.reshape(b, 1, h * d))

