"""Re-harmonisation decoder: frozen-encoder codes -> chorale tokens
(counterpart of vqcpcb_tpu/models/decoder.py).

Two transformer types, as in JAX: 'relative' (relative-attention layers;
target tokens carry channel and intra-code position features) and
'absolute' (no relative bias; source and target tokens carry learned
absolute positional embeddings, the source embedding being d_model - p
wide). The cross branch is 'diagonal' (the aligned MLP, relative only) or
an attention over the memory, 'full' or 'anticausal'. The defaults are the
flagship AC/D/C (relative, diagonal); `configs/decoder_random.py`
(`decoder_type: 'transformer'`) is absolute with full cross-attention.
Codes are re-embedded and run through the encoder transformer (the
memory); target tokens are embedded, shifted by SOS and decoded causally.
`sample_range` is the KV-cached sampler: one prefill per call, then one
decode step per position, eager PyTorch.

Training: `forward` in train mode runs every attention layer on the
training route (the relative-bias or the fused-attention kernels on CUDA)
with dropout, as JAX's `Decoder.__call__(training=True)`. The output heads
are fused into one (d_model, sum vocab) product with the stacked cross
entropy, JAX's default (decoder.py:41-53, 246-261). The compute dtype is
utils.layer_compute_dtype: the trainer's steps run in its bf16 scope on
CUDA (JAX's default_compute_dtype('bfloat16')) and in f32 on the CPU, and
VQCPCB_COMPUTE_DTYPE=bfloat16 puts every forward and `sample_range` in
bf16. It reaches the transformer layers and the fused head, as JAX's
dtype=compute_dtype() does (decoder.py:161, 251); parameters stay f32, and
the embeddings, the target embedding's Dense and the sampler's per-channel
heads (JAX's fused generation head, decoder.py:320-350) compute in f32.

The source: merged code indices re-embedded by `source_embeddings`, an
nn.Embedding of source_vocab_size rows; or, over an encoder without a
quantizer (source_vocab_size 0), the encoder's continuous z (B, S,
source_dim) mapped by `source_embeddings`, an nn.Linear in f32 under every
compute dtype, as JAX's nn.Dense without a dtype (decoder.py:114-119).
`n_head_kv` makes every attention of both stacks grouped-query
(ops/attention.py; decoder.py:80).

Parameter names follow the reference Decoder (sos, linear_target,
source_embeddings, target_channel_embeddings and
target_events_positioning_embeddings (relative) or
source_positional_embeddings and target_positional_embeddings (absolute),
data_processor.embeddings.{c}, transformer.encoder.layers.{i},
transformer.decoder.layers.{i}, pre_softmaxes.{c}).

Under a model axis (parallel/mesh.py shard_params) the output heads whose
vocabulary divides the axis are vocabulary-parallel (models/heads.py):
this rank's rows of each, the logits all-gathered along the vocabulary
before stacked_categorical_crossentropy (decoder.py:240; exact, and small
at about 4 x 62 columns); the other heads stay replicated.

`sample_range` runs under the mesh the module was sharded with (JAX's
sampler under GSPMD, tests/test_multichip.py:391): source and tokens_init
are this rank's rows of the generation batch (`rows`, parallel/mesh.Rows),
the attention layers run on this rank's heads with caches of its KV heads
(ops/attention.py), the FFN and the aligned cross MLP column then row
(ops/transformer.py), the sampled channel's head vocabulary-parallel
(head_logit), and the noise of each draw is the global batch's
(ops/sampling.py). The ranks of one data index end with the same tokens,
which each call checks.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vqcpcb_tpu_torch.models.data_processor import DataProcessor
from vqcpcb_tpu_torch.models.heads import VocabParallelHeads
from vqcpcb_tpu_torch.ops.kv_cache import Cache, cache_update, new_cache
from vqcpcb_tpu_torch.ops.losses import stacked_categorical_crossentropy
from vqcpcb_tpu_torch.ops.masks import anticausal_mask, causal_mask
from vqcpcb_tpu_torch.ops.sampling import sample_categorical
from vqcpcb_tpu_torch.ops.transformer import TransformerDecoder, TransformerEncoder
from vqcpcb_tpu_torch.parallel.collectives import check_replicated
from vqcpcb_tpu_torch.utils import (dense, flatten, kv_cache_dtype,
                                    module_device, to_device)


class Decoder(VocabParallelHeads, nn.Module):
    def __init__(self, data_processor: DataProcessor,
                 encoder_attention_type: str, d_model: int,
                 num_encoder_layers: int, num_decoder_layers: int, n_head: int,
                 dim_feedforward: int, positional_embedding_size: int,
                 num_channels_encoder: int, num_events_encoder: int,
                 num_channels_decoder: int, num_events_decoder: int,
                 total_upscaling: int, source_vocab_size: int,
                 dropout: float = 0.0, transformer_type: str = "relative",
                 cross_attention_type: str = "diagonal", source_dim: int = 0,
                 n_head_kv: Optional[int] = None):
        super().__init__()
        if encoder_attention_type not in ("anticausal", "causal", "full"):
            raise ValueError(encoder_attention_type)
        if cross_attention_type not in ("anticausal", "diagonal", "full"):
            raise ValueError(cross_attention_type)
        if transformer_type not in ("absolute", "relative"):
            raise ValueError(transformer_type)
        self.data_processor = data_processor
        self.encoder_attention_type = encoder_attention_type
        self.transformer_type = transformer_type
        self.cross_attention_type = cross_attention_type
        self.d_model = d_model
        self.num_channels_decoder = num_channels_decoder
        self.num_events_encoder = num_events_encoder
        self.num_channels_encoder = num_channels_encoder
        self.total_upscaling = total_upscaling
        self.num_tokens_target = num_channels_decoder * num_events_decoder
        if self.num_tokens_target % total_upscaling:
            raise ValueError("target tokens are not a multiple of the upscaling")
        p = positional_embedding_size
        relative = transformer_type == "relative"
        if relative:
            self.target_channel_embeddings = nn.Parameter(
                torch.randn(1, num_channels_decoder, p))
            self.target_events_positioning_embeddings = nn.Parameter(
                torch.randn(1, total_upscaling // num_channels_decoder, p))
            embed_width, target_in = d_model, data_processor.embedding_size + 2 * p
        else:
            self.source_positional_embeddings = nn.Parameter(
                torch.randn(1, self.num_tokens_target // total_upscaling, p))
            self.target_positional_embeddings = nn.Parameter(
                torch.randn(1, self.num_tokens_target, p))
            embed_width, target_in = d_model - p, data_processor.embedding_size + p
        if source_vocab_size > 0:
            self.source_embeddings = nn.Embedding(source_vocab_size, embed_width)
        else:
            self.source_embeddings = nn.Linear(source_dim, embed_width)
        self.linear_target = nn.Linear(target_in, d_model)
        self.sos = nn.Parameter(torch.randn(1, 1, d_model))
        bias_type = "relative_attention" if relative else None
        self.aligned = relative and cross_attention_type == "diagonal"
        layer_kwargs = dict(
            d_model=d_model, n_head=n_head, attention_bias_type_self=bias_type,
            num_channels_encoder=num_channels_encoder,
            num_events_encoder=num_events_encoder,
            num_channels_decoder=num_channels_decoder,
            num_events_decoder=num_events_decoder,
            dim_feedforward=dim_feedforward, dropout=dropout,
            n_head_kv=n_head_kv)
        if not self.aligned:
            layer_kwargs["attention_bias_type_cross"] = (
                "relative_attention_target_source" if relative else None)
        self.transformer = nn.ModuleDict({
            "encoder": TransformerEncoder(
                num_encoder_layers, d_model, n_head, bias_type,
                num_channels_encoder, num_events_encoder, dim_feedforward,
                dropout=dropout, n_head_kv=n_head_kv),
            "decoder": TransformerDecoder(num_decoder_layers,
                                          aligned=self.aligned, **layer_kwargs),
        })
        self.pre_softmaxes = nn.ModuleList(
            nn.Linear(d_model, v) for v in data_processor.num_tokens_per_channel)

    mesh = None                 # the mesh shard_params gave, None off one

    def set_mesh(self, mesh, specs) -> None:
        super().set_mesh(mesh, specs)
        self.mesh = mesh

    def _stacked_logits(self, output: torch.Tensor) -> torch.Tensor:
        """(B, events, C, d_model) -> the channel-stacked logits (B, events,
        C, sum vocab): one product with the per-channel weights concatenated,
        channel c's logits in its columns (decoder.py:246-261); under a
        model axis the heads of models/heads.py, concatenated."""
        heads = self.pre_softmaxes
        if self.head_mesh is None:
            return dense(output, torch.cat([h.weight for h in heads]),
                         torch.cat([h.bias for h in heads]))
        return torch.cat(self.head_logits(output, per_channel=False, linear=dense),
                         dim=-1)

    @property
    def decoder_layers(self):
        return self.transformer["decoder"].layers

    # ---- embeddings ---------------------------------------------------------

    def embed_source(self, source: torch.Tensor) -> torch.Tensor:
        """Code indices (B, S), or z (B, S, source_dim) over an unquantized
        encoder, -> (B, S, d_model); the absolute decoder concatenates the
        source positional embeddings. A z without its feature axis raises
        where JAX's Dense does (a parameter shape error): the case of
        `generate_reharmonisation`, whose reshape(1, -1) of the encoded
        chunks flattens z (decoder_trainer.py:454)."""
        if isinstance(self.source_embeddings, nn.Embedding):
            source_seq = self.source_embeddings(source.long())
        else:
            width = self.source_embeddings.in_features
            if source.dim() != 3 or source.shape[-1] != width:
                raise ValueError(
                    f"the source of a decoder over an unquantized encoder is z "
                    f"of shape (B, S, {width}), not {tuple(source.shape)}; a "
                    "code sequence glued with reshape(1, -1) has lost z's "
                    "feature axis (the JAX package fails at the same call)")
            source_seq = self.source_embeddings(source.float())
        if self.transformer_type == "absolute":
            pos = self.source_positional_embeddings
            source_seq = torch.cat(
                [source_seq, pos.expand(source_seq.shape[0], -1, -1)], dim=2)
        return source_seq

    def embed_target(self, target: torch.Tensor) -> torch.Tensor:
        """Target tokens (B, E, C) -> (B, E*C, d_model), without the SOS
        shift: token embedding with channel and intra-code event features
        (relative) or with the target positional embeddings (absolute)."""
        b = target.shape[0]
        target_seq = flatten(self.data_processor.embed(target))
        num_tokens = target_seq.shape[1]
        if self.transformer_type == "relative":
            c = self.num_channels_decoder
            channel = self.target_channel_embeddings.repeat(b, num_tokens // c, 1)
            events = self.target_events_positioning_embeddings.repeat_interleave(
                c, dim=1).repeat(b, num_tokens // self.total_upscaling, 1)
            feats = [target_seq, channel, events]
        else:
            feats = [target_seq, self.target_positional_embeddings.expand(b, -1, -1)]
        return self.linear_target(torch.cat(feats, 2))

    def shift_with_sos(self, target_seq: torch.Tensor) -> torch.Tensor:
        sos = self.sos.expand(target_seq.shape[0], 1, -1)
        return torch.cat([sos, target_seq[:, :-1]], dim=1)

    def encode_memory(self, source: torch.Tensor) -> torch.Tensor:
        """The relative-attention encoder over the embedded codes."""
        source_seq = self.embed_source(source)
        n, dev = source_seq.shape[1], source_seq.device
        if self.encoder_attention_type == "full":
            mask = None
        elif self.encoder_attention_type == "causal":
            mask = causal_mask(n, device=dev)
        else:
            mask = anticausal_mask(n, device=dev)
        return self.transformer["encoder"](source_seq, mask)

    def cross_mask(self, source_length: int, target_length: int
                   ) -> Optional[torch.Tensor]:
        """The (T, S) cross-attention mask: None for 'diagonal' and 'full'
        (decoder.py:216)."""
        if self.cross_attention_type in ("diagonal", "full"):
            return None
        return anticausal_mask(source_length, sz_tgt=target_length,
                               device=self.sos.device)

    def _cross_visibility(self) -> Optional[torch.Tensor]:
        """(T, S) bool of the memory positions visible from each target
        position (decoder.py:389), built once per sampling call; None where
        every position is visible ('full', 'diagonal')."""
        if self.cross_attention_type != "anticausal":
            return None
        s_len = self.num_events_encoder * self.num_channels_encoder
        t = torch.arange(self.num_tokens_target, device=self.sos.device)
        s = torch.arange(s_len, device=self.sos.device)
        return s[None, :] >= (t // (self.num_tokens_target // s_len))[:, None]

    # ---- teacher-forced forward ---------------------------------------------

    def forward(self, source: torch.Tensor, target: torch.Tensor) -> Dict:
        """source (B, S) codes or (B, S, source_dim) z, target (B,
        num_events, C) tokens. Returns {'loss', 'weights_per_category'}:
        the per-channel logits (B, num_events, vocab_c) and their summed CE
        (decoder.py:223). In train mode the attention layers take the
        training route, with dropout."""
        b = target.shape[0]
        memory = self.encode_memory(source)
        target_seq = self.shift_with_sos(self.embed_target(target))
        t_len = target_seq.shape[1]
        output = self.transformer["decoder"](
            target_seq, memory, causal_mask(t_len, device=target_seq.device),
            self.cross_mask(memory.shape[1], t_len))
        output = output.reshape(b, -1, self.num_channels_decoder, self.d_model)
        vocabs = self.data_processor.num_tokens_per_channel
        stacked = self._stacked_logits(output)
        offsets = [sum(vocabs[:c]) for c in range(len(vocabs))]
        logits = [stacked[:, :, c, o:o + v]
                  for c, (o, v) in enumerate(zip(offsets, vocabs))]
        return {"loss": stacked_categorical_crossentropy(stacked, target, vocabs),
                "weights_per_category": logits}

    # ---- KV-cached sampling ---------------------------------------------------

    def _embed_input_at(self, prev_token: torch.Tensor, t: int) -> torch.Tensor:
        """Transformer input at flat position t > 0: the embedding of the
        token at t-1 with position t-1's features, as the SOS shift of the
        full sequence gives it (decoder.py:287). prev_token (B,) -> (B, d)."""
        c = self.num_channels_decoder
        prev_pos = t - 1
        channel = prev_pos % c
        emb = self.data_processor.embeddings[channel]
        token_emb = emb(prev_token.long().clamp(0, emb.num_embeddings - 1))
        b = prev_token.shape[0]
        if self.transformer_type == "relative":
            event_in_code = (prev_pos % self.total_upscaling) // c
            feats = [self.target_channel_embeddings[0, channel],
                     self.target_events_positioning_embeddings[0, event_in_code]]
        else:
            feats = [self.target_positional_embeddings[0, prev_pos]]
        return self.linear_target(torch.cat(
            [token_emb] + [f.expand(b, -1) for f in feats], dim=-1))

    def _head_logits_at(self, x: torch.Tensor, t: int) -> torch.Tensor:
        """Output head of channel t % C padded to the largest vocabulary with
        -inf: x (B, d) -> (B, vocab_max), the values of the JAX padded head
        (decoder.py:320); a split head's logits gathered over `model`."""
        vocabs = self.data_processor.num_tokens_per_channel
        c = t % self.num_channels_decoder
        logits = self.head_logit(x, c)
        pad = max(vocabs) - vocabs[c]
        if pad:
            logits = F.pad(logits, (0, pad), value=float("-inf"))
        return logits

    def prefill(self, source: torch.Tensor, target: torch.Tensor,
                cache_dt: Optional[torch.dtype] = None
                ) -> Tuple[List[Tuple[Cache, Cache]], List[torch.Tensor]]:
        """One full forward filling every layer's caches: per layer (k, v) of
        (B, H_kv, T, hd) in the cache format, and the cross context: the
        aligned branch (B, T, E), or the memory's (k, v) of (B, H_kv, S, hd)
        for an attention layer (decoder.py:363)."""
        memory = self.encode_memory(source)
        out = self.shift_with_sos(self.embed_target(target))
        mask = causal_mask(out.shape[1], device=out.device)
        mem_mask = self.cross_mask(memory.shape[1], out.shape[1])
        caches, crosses = [], []
        for layer in self.decoder_layers:
            out, (k, v), cross = layer.capture(out, memory, mask, mem_mask)
            caches.append((new_cache(k.contiguous(), cache_dt),
                           new_cache(v.contiguous(), cache_dt)))
            crosses.append(cross)
        return caches, crosses

    def _decode_one(self, x_t: torch.Tensor, caches, crosses, t: int,
                    cross_visible: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """All decoder layers at position t; writes each layer's K/V row t
        into its cache first (in place). x_t (B, 1, E) -> (B, 1, E);
        cross_visible: _cross_visibility's (T, S) rows, or None."""
        cross_mask = None if cross_visible is None else cross_visible[t]
        out = x_t
        for layer, (k_cache, v_cache), cross in zip(self.decoder_layers,
                                                    caches, crosses):
            k_t, v_t = layer.self_attn.project_kv(out)       # (B, H_kv, 1, hd)
            cache_update(k_cache, k_t, t)
            cache_update(v_cache, v_t, t)
            if self.aligned:
                out = layer.step(out, k_cache, v_cache, cross[:, t:t + 1], t,
                                 self.num_tokens_target)
            else:
                out = layer.step(out, k_cache, v_cache, *cross, t,
                                 self.num_tokens_target, cross_mask)
        return out

    @torch.no_grad()
    def sample_range(self, source, tokens_init, start: int, num_steps: int,
                     generator: torch.Generator, temperature: float = 1.0,
                     top_k: int = 0, top_p: float = 0.0,
                     forbidden_indices=None, exact_ties: Optional[bool] = None,
                     device=None, rows=None) -> torch.Tensor:
        """Sample flat positions [start, start + num_steps) autoregressively
        (decoder.py:421).

        source (B, S) codes or (B, S, source_dim) z; tokens_init (B, E, C)
        tokens, the fixed context outside the sampled range;
        forbidden_indices: optional (C, n) token ids excluded per channel.
        Runs on `device` -- the card unless the caller names another; the
        module must already live there. Caches follow utils.kv_cache_dtype
        (int8 on the card, f32 on the CPU). Under a mesh, source and
        tokens_init are this rank's rows [rows.start, rows.stop) of the
        generation batch (rows: a parallel/mesh.Rows; None, the batch is
        this rank's alone) and `generator` is in the same state on every
        rank (parallel/collectives.common_generator). Returns the updated
        (B, E, C) tokens on that device."""
        here = module_device(self, device)
        source = to_device(source, here)
        tokens_init = to_device(tokens_init, here)
        b, num_events, c = tokens_init.shape
        tokens_flat = tokens_init.reshape(b, num_events * c).clone()
        caches, crosses = self.prefill(source, tokens_init, kv_cache_dtype(here))
        cross_visible = None if self.aligned else self._cross_visibility()
        forbidden = (None if forbidden_indices is None
                     else to_device(forbidden_indices, here).long())
        for t in range(start, start + num_steps):
            if t > 0:
                x_t = self._embed_input_at(tokens_flat[:, t - 1], t)
            else:
                x_t = self.sos[0].expand(b, -1)
            out = self._decode_one(x_t[:, None], caches, crosses, t,
                                   cross_visible)
            logits = self._head_logits_at(out[:, 0], t)
            if forbidden is not None:
                logits = logits.index_fill(1, forbidden[t % c], float("-inf"))
            new_token = sample_categorical(generator, logits, temperature,
                                           top_k, top_p, exact_ties, rows)
            tokens_flat[:, t] = new_token.to(tokens_flat.dtype)
        check_replicated(tokens_flat, self.mesh, rows)
        return tokens_flat.reshape(b, num_events, c)
