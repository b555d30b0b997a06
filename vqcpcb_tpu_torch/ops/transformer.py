"""Post-LN transformer stacks with KV-cached decode steps (counterpart of
vqcpcb_tpu/ops/transformer.py).

Parameter names follow the reference (self_attn, linear1, linear2, norm1..3,
cross_attn.0 / cross_attn.2, layers.{i}), the layout that
training/import_reference.py reads. LayerNorms use eps 1e-6, flax's default
(torch's is 1e-5). Two decoder layers: the aligned one, whose
cross-attention is a position-aligned MLP (cross_attn.0 / cross_attn.2),
and the attention one, whose cross-attention attends over the memory
(multihead_attn), as the JAX stack picks them (transformer.py:359-361).

Training: in train mode a layer runs its self-attention on the training
route (attention.py) and applies dropout after the attention (drop1), the
cross branch (drop2 of the decoder layer), the FFN (drop2 / drop3) and on
the FFN's hidden activation, as the JAX layers do (transformer.py:53-109,
318-327). The rate defaults to 0; the Decoder passes its own. Those
dropouts draw their masks from the generator set on them (`Dropout`), the
trainer's, so a run's every draw has a source it can save
(`wire_generators`). `train_mode` runs a block with a module in the mode a
caller's `training` argument names, for the modules that take one as the
JAX modules do.

Grouped-query attention: `n_head_kv` (None: one KV head per query head)
goes to every attention of a layer, self and cross (transformer.py:81,
186, 272); `capture` returns the H_kv-head k and v the caches keep.

Attention maps: each layer's forward returns its output and a dict of its
weights under JAX's keys (`Attentions`: a_self_encoder; a_self_decoder and
a_cross, None for the aligned branch), and both stacks take
collect_attentions (transformer.py:160-169, 366-375), with which they
return (output, one dict per layer); without it, the output alone. The
flag reaches each attention as need_weights: the forward that collects
takes the plain path on the card, since the kernels keep no weights, and
every other forward launches the kernels.

Compute dtype: the attention projections and the FFN's linears compute in
utils.layer_compute_dtype (bf16 under VQCPCB_COMPUTE_DTYPE=bfloat16 or the
decoder trainer's scope, transformer.py:61-64); the residual stream, the
LayerNorms and the aligned cross branch stay f32, as JAX's Dense layers
without a dtype and its f32 LayerNorms do.

Rematerialisation: under VQCPCB_REMAT=1 each layer of a stack in train mode
is recomputed in the backward instead of keeping its activations
(transformer.py:26-40; `remat_layer`), which bounds the peak to one layer's
temporaries. Its dropout draws come from explicit generators, which
torch.utils.checkpoint does not restore: the recompute rewinds them to
where the forward found them, so it draws the same seeds and masks, and
leaves them where the forward left them.

Under a model axis (parallel/mesh.py shard_params, which calls each layer's
`set_mesh`) the FFN pair and the aligned layer's cross MLP pair run as
Megatron's column-then-row blocks where their hidden width divides the
axis: copy_to_model on the input, the first Linear on this rank's output
rows, the activation (elementwise, so the split holds through it), the
second Linear on its input columns, reduce_from_model, the bias once
(parallel/collectives.py); replicated otherwise.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vqcpcb_tpu_torch.ops.attention import MultiheadAttention
from vqcpcb_tpu_torch.ops.kv_cache import Cache
from vqcpcb_tpu_torch.parallel.collectives import (copy_to_model,
                                                   reduce_from_model,
                                                   row_parallel)
from vqcpcb_tpu_torch.utils import (default_compute_dtype, dense, dropout,
                                    layer_compute_dtype)

LAYER_NORM_EPS = 1e-6
# a layer's attention weights under JAX's keys (a_self_encoder;
# a_self_decoder, a_cross): (B, H, T, S) on the plain path, None from the
# kernels, the training route and the aligned cross branch
Attentions = Dict[str, Optional[torch.Tensor]]


class Dropout(nn.Dropout):
    """nn.Dropout whose mask is drawn from `generator`, set by the owner
    (torch's default generator of the input's device while it is None)."""

    generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.p, self.training, self.generator)


def wire_generators(module: nn.Module, generator: torch.Generator,
                    seed_generator: torch.Generator) -> None:
    """Every `Dropout` under `module` draws its masks from `generator` (on the
    module's device) and every attention layer its dropout seeds from
    `seed_generator` (on the host): the trainer's generators, which it
    saves with its state."""
    for m in module.modules():
        if isinstance(m, MultiheadAttention):
            m.seed_generator = seed_generator
        elif isinstance(m, Dropout):
            m.generator = generator


def _layer_generators(layer: nn.Module) -> List[torch.Generator]:
    """The explicit generators the layer's dropout draws from, each once."""
    found: List[torch.Generator] = []
    for m in layer.modules():
        if isinstance(m, MultiheadAttention):
            g = m.seed_generator
        elif isinstance(m, Dropout):
            g = m.generator
        else:
            continue
        if g is not None and all(g is not h for h in found):
            found.append(g)
    return found


def remat_layer(layer: nn.Module, *args):
    """layer(*args); under VQCPCB_REMAT=1, for a layer in train mode with
    gradients on, through torch.utils.checkpoint, so the backward recomputes
    the layer's activations (JAX's nn.remat of each layer). The recompute
    runs in the compute dtype of the forward (the backward may run outside
    a default_compute_dtype scope) and first rewinds the layer's explicit
    generators to their states before the forward, so it draws the
    forward's dropout seeds and masks, and then puts them back where they
    were; torch's default generators are restored by checkpoint itself."""
    if not (os.environ.get("VQCPCB_REMAT") == "1" and layer.training
            and torch.is_grad_enabled()):
        return layer(*args)
    generators = _layer_generators(layer)
    before = [g.get_state() for g in generators]
    dtype = layer_compute_dtype()
    calls = []

    def run(*inputs):
        if not calls:                            # the forward
            calls.append(True)
            return layer(*inputs)
        now = [g.get_state() for g in generators]
        for g, state in zip(generators, before):
            g.set_state(state)
        try:
            with default_compute_dtype(dtype):
                return layer(*inputs)
        finally:
            for g, state in zip(generators, now):
                g.set_state(state)

    return checkpoint(run, *args, use_reentrant=False)


def _run_stack(layers: nn.ModuleList, collect_attentions: bool, x, *args
               ) -> Tuple[torch.Tensor, List[Attentions]]:
    """x through every layer (remat_layer), and each layer's weights dict
    when collect_attentions, which asks each layer for its weights."""
    attentions = []
    for layer in layers:
        x, attn = remat_layer(layer, x, *args, collect_attentions)
        if collect_attentions:
            attentions.append(attn)
    return x, attentions


@contextlib.contextmanager
def train_mode(module: nn.Module, training: Optional[bool]) -> Iterator[None]:
    """Runs the block with `module` and its submodules in train mode
    (training True) or eval mode (False), then gives each its mode back;
    None keeps the modes as they are."""
    if training is None:
        yield
        return
    saved = [(m, m.training) for m in module.modules()]
    module.train(training)
    try:
        yield
    finally:
        for m, mode in saved:
            m.training = mode


def feed_forward(x: torch.Tensor, linear1: nn.Linear, linear2: nn.Linear,
                 activation: str, dropout: Dropout, mesh=None) -> torch.Tensor:
    """The FeedForward block (transformer.py:53): linear1, relu or gelu
    (flax's gelu is the tanh approximation), dropout, linear2, the linears
    in the compute dtype. Its modules live on the layer, the Linears under
    the reference's names. mesh: a mesh whose model axis splits the pair
    (column then row), or None."""
    if mesh is not None:
        x = copy_to_model(x, mesh)
    h = dense(x, linear1.weight, linear1.bias)
    if activation == "relu":
        h = F.relu(h)
    elif activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"activation should be relu/gelu, not {activation}")
    if mesh is not None:
        return row_parallel(dropout(h), linear2.weight, linear2.bias, mesh)
    return dense(dropout(h), linear2.weight, linear2.bias)


class _MeshLayer(nn.Module):
    """A transformer layer's FFN split over a model axis (set_mesh); the
    attention modules take theirs from shard_params themselves."""

    ff_mesh = None

    def set_mesh(self, mesh, specs) -> None:
        self.ff_mesh = mesh if specs.get("linear1.weight") is not None else None


class TransformerEncoderLayer(_MeshLayer):
    """attn -> add -> LN -> FFN -> add -> LN (transformer.py:67)."""

    def __init__(self, d_model: int, n_head: int,
                 attention_bias_type: Optional[str], num_channels: int,
                 num_events: int, dim_feedforward: int = 2048,
                 activation: str = "relu", dropout: float = 0.0,
                 n_head_kv: Optional[int] = None):
        super().__init__()
        self.self_attn = MultiheadAttention(
            d_model, n_head, attention_bias_type,
            num_channels_k=num_channels, num_events_k=num_events,
            num_channels_q=num_channels, num_events_q=num_events,
            dropout=dropout, num_kv_heads=n_head_kv)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)
        self.ff_dropout = Dropout(dropout)
        self.activation = activation

    def forward(self, src: torch.Tensor, src_mask: Optional[torch.Tensor] = None,
                need_weights: bool = False) -> Tuple[torch.Tensor, Attentions]:
        """(output, {'a_self_encoder': the weights or None}), as JAX's
        layer returns them (transformer.py:101-109); need_weights asks the
        attention for them on the card (MultiheadAttention.forward)."""
        src2, a_self = self.self_attn(src, src, attn_mask=src_mask,
                                      need_weights=need_weights)
        return self._after_self(src, src2), {"a_self_encoder": a_self}

    def _after_self(self, src, src2):
        src = self.norm1(src + self.drop1(src2))
        return self.norm2(src + self.drop2(self._ff(src)))

    def _ff(self, x):
        return feed_forward(x, self.linear1, self.linear2, self.activation,
                            self.ff_dropout, self.ff_mesh)

    def capture(self, src, src_mask=None):
        """Full forward that also returns this layer's self-attention K/V,
        projected once for both."""
        attn = self.self_attn
        k_self, v_self = attn.project_kv(src)
        src2, _ = attn.attend(attn.project_q(src), k_self, v_self, src_mask)
        return self._after_self(src, src2), (k_self, v_self)

    def step(self, x_t, k_cache: Cache, v_cache: Cache, t: int, seq_len: int):
        """One position: x_t (B, 1, E); caches already hold position t."""
        x = self.norm1(x_t + self.self_attn.step(x_t, k_cache, v_cache, t,
                                                 seq_len))
        return self.norm2(x + self._ff(x))


class TransformerEncoder(nn.Module):
    """Stack of independent layers (transformer.py:129)."""

    def __init__(self, num_layers: int, d_model: int, n_head: int,
                 attention_bias_type: Optional[str], num_channels: int,
                 num_events: int, dim_feedforward: int = 2048,
                 dropout: float = 0.0, n_head_kv: Optional[int] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, n_head, attention_bias_type,
                                    num_channels, num_events, dim_feedforward,
                                    dropout=dropout, n_head_kv=n_head_kv)
            for _ in range(num_layers))

    def forward(self, src: torch.Tensor, mask: Optional[torch.Tensor] = None,
                collect_attentions: bool = False):
        """The stack's output; with collect_attentions, (output, one
        weights dict per layer), as JAX's stack (transformer.py:160-169)."""
        out, attentions = _run_stack(self.layers, collect_attentions, src, mask)
        return (out, attentions) if collect_attentions else out


class TransformerAlignedDecoderLayer(_MeshLayer):
    """Causal self-attention, then the aligned cross branch -- an MLP of the
    memory event (channels_enc*E -> 2E -> E*channels_dec) broadcast over the
    subsampling ratio -- then the FFN, each followed by add & LN
    (transformer.py:257)."""

    def __init__(self, d_model: int, n_head: int,
                 attention_bias_type_self: Optional[str],
                 num_channels_encoder: int, num_events_encoder: int,
                 num_channels_decoder: int, num_events_decoder: int,
                 dim_feedforward: int = 2048, activation: str = "relu",
                 dropout: float = 0.0, n_head_kv: Optional[int] = None):
        super().__init__()
        self.self_attn = MultiheadAttention(
            d_model, n_head, attention_bias_type_self,
            num_channels_k=num_channels_decoder,
            num_events_k=num_events_decoder,
            num_channels_q=num_channels_decoder,
            num_events_q=num_events_decoder, dropout=dropout,
            num_kv_heads=n_head_kv)
        self.cross_attn = nn.Sequential(
            nn.Linear(d_model * num_channels_encoder, d_model * 2), nn.ELU(),
            nn.Linear(d_model * 2, d_model * num_channels_decoder))
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)
        self.drop3 = Dropout(dropout)
        self.ff_dropout = Dropout(dropout)
        self.num_channels_encoder = num_channels_encoder
        self.num_channels_decoder = num_channels_decoder
        self.activation = activation
        self.cross_mesh = None

    def set_mesh(self, mesh, specs) -> None:
        super().set_mesh(mesh, specs)
        self.cross_mesh = (mesh if specs.get("cross_attn.0.weight") is not None
                           else None)

    def _cross_mlp(self, x: torch.Tensor) -> torch.Tensor:
        """cross_attn (Linear, ELU, Linear) in f32; split column then row
        under a model axis."""
        mesh = self.cross_mesh
        if mesh is None:
            return self.cross_attn(x)
        first, elu, second = self.cross_attn
        h = elu(first(copy_to_model(x, mesh)))
        return reduce_from_model(F.linear(h, second.weight), mesh) + second.bias

    def cross_branch(self, memory: torch.Tensor, tgt_len: int) -> torch.Tensor:
        """memory (B, S, E), S = events_memory * channels_encoder ->
        (B, tgt_len, E); depends on memory only, so the sampler computes it
        once per window."""
        b, s, e = memory.shape
        c_enc, c_dec = self.num_channels_encoder, self.num_channels_decoder
        n_mem = s // c_enc
        h = self._cross_mlp(memory.reshape(b, n_mem, c_enc * e))
        h = h.reshape(b, n_mem, e, c_dec).transpose(2, 3)      # (B, n, C, E)
        ratio = (tgt_len // c_dec) // n_mem
        return h[:, :, None].expand(b, n_mem, ratio, c_dec, e).reshape(
            b, tgt_len, e)

    def _after_self(self, x, cross):
        x = self.norm2(x + self.drop2(cross))
        return self.norm3(x + self.drop3(feed_forward(
            x, self.linear1, self.linear2, self.activation, self.ff_dropout,
            self.ff_mesh)))

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                need_weights: bool = False):
        """memory_mask is unused: the aligned branch masks nothing."""
        tgt2, a_self = self.self_attn(tgt, tgt, attn_mask=tgt_mask,
                                      need_weights=need_weights)
        tgt = self.norm1(tgt + self.drop1(tgt2))
        return (self._after_self(tgt, self.cross_branch(memory, tgt.shape[1])),
                {"a_self_decoder": a_self, "a_cross": None})

    def capture(self, tgt, memory, tgt_mask=None, memory_mask=None):
        """Full forward returning the self-attention K/V and the cross branch
        (B, T, E) for the decode steps; K/V are projected once for both."""
        attn = self.self_attn
        k_self, v_self = attn.project_kv(tgt)
        tgt2, _ = attn.attend(attn.project_q(tgt), k_self, v_self, tgt_mask)
        tgt = self.norm1(tgt + tgt2)
        cross = self.cross_branch(memory, tgt.shape[1])
        return self._after_self(tgt, cross), (k_self, v_self), cross

    def step(self, x_t, k_cache: Cache, v_cache: Cache, cross_t, t: int,
             seq_len_tgt: int):
        """cross_t: (B, 1, E), the cross branch at position t."""
        x = self.norm1(x_t + self.self_attn.step(x_t, k_cache, v_cache, t,
                                                 seq_len_tgt))
        return self._after_self(x, cross_t)


class TransformerDecoderLayer(_MeshLayer):
    """Causal self-attention, then cross-attention over the memory, then the
    FFN, each followed by add & LN (transformer.py:172)."""

    def __init__(self, d_model: int, n_head: int,
                 attention_bias_type_self: Optional[str],
                 attention_bias_type_cross: Optional[str],
                 num_channels_encoder: int, num_events_encoder: int,
                 num_channels_decoder: int, num_events_decoder: int,
                 dim_feedforward: int = 2048, activation: str = "relu",
                 dropout: float = 0.0, n_head_kv: Optional[int] = None):
        super().__init__()
        self.self_attn = MultiheadAttention(
            d_model, n_head, attention_bias_type_self,
            num_channels_k=num_channels_decoder,
            num_events_k=num_events_decoder,
            num_channels_q=num_channels_decoder,
            num_events_q=num_events_decoder, dropout=dropout,
            num_kv_heads=n_head_kv)
        self.multihead_attn = MultiheadAttention(
            d_model, n_head, attention_bias_type_cross,
            num_channels_k=num_channels_encoder,
            num_events_k=num_events_encoder,
            num_channels_q=num_channels_decoder,
            num_events_q=num_events_decoder, dropout=dropout,
            num_kv_heads=n_head_kv)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)
        self.drop3 = Dropout(dropout)
        self.ff_dropout = Dropout(dropout)
        self.activation = activation

    def _ff_block(self, x):
        return self.norm3(x + self.drop3(feed_forward(
            x, self.linear1, self.linear2, self.activation, self.ff_dropout,
            self.ff_mesh)))

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                need_weights: bool = False):
        tgt2, a_self = self.self_attn(tgt, tgt, attn_mask=tgt_mask,
                                      need_weights=need_weights)
        tgt = self.norm1(tgt + self.drop1(tgt2))
        tgt2, a_cross = self.multihead_attn(tgt, memory, attn_mask=memory_mask,
                                            need_weights=need_weights)
        tgt = self.norm2(tgt + self.drop2(tgt2))
        return self._ff_block(tgt), {"a_self_decoder": a_self, "a_cross": a_cross}

    def capture(self, tgt, memory, tgt_mask=None, memory_mask=None):
        """Full forward returning the self-attention K/V and the memory's K/V
        for the decode steps, each projected once."""
        self_attn, cross = self.self_attn, self.multihead_attn
        k_self, v_self = self_attn.project_kv(tgt)
        k_mem, v_mem = cross.project_kv(memory)
        tgt2, _ = self_attn.attend(self_attn.project_q(tgt), k_self, v_self,
                                   tgt_mask)
        tgt = self.norm1(tgt + tgt2)
        tgt2, _ = cross.attend(cross.project_q(tgt), k_mem, v_mem, memory_mask)
        tgt = self.norm2(tgt + tgt2)
        return self._ff_block(tgt), (k_self, v_self), (k_mem, v_mem)

    def step(self, x_t, k_cache: Cache, v_cache: Cache, k_mem, v_mem, t: int,
             seq_len_tgt: int, cross_key_mask: Optional[torch.Tensor]):
        """One position: x_t (B, 1, E); caches already hold position t;
        k_mem, v_mem (B, H_kv, S, hd); cross_key_mask (S,) bool of the memory
        positions visible from t, or None when all are."""
        x = self.norm1(x_t + self.self_attn.step(x_t, k_cache, v_cache, t,
                                                 seq_len_tgt))
        x = self.norm2(x + self.multihead_attn.step(
            x, k_mem, v_mem, t, seq_len_tgt, key_len_mask=cross_key_mask,
            causal=False))
        return self._ff_block(x)


class TransformerDecoder(nn.Module):
    """Stack of decoder layers, aligned or attention (transformer.py:350)."""

    def __init__(self, num_layers: int, aligned: bool = True, **layer_kwargs):
        super().__init__()
        layer = TransformerAlignedDecoderLayer if aligned else TransformerDecoderLayer
        self.layers = nn.ModuleList(layer(**layer_kwargs)
                                    for _ in range(num_layers))

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                collect_attentions: bool = False):
        """The stack's output; with collect_attentions, (output, one
        weights dict per layer), as JAX's stack (transformer.py:366-375)."""
        out, attentions = _run_stack(self.layers, collect_attentions, tgt,
                                     memory, tgt_mask, memory_mask)
        return (out, attentions) if collect_attentions else out
