"""Autoregressive prior over merged VQ code sequences (counterpart of
vqcpcb_tpu/models/prior.py, PriorRelative :23).

A decoder-only relative-attention language model over merged code indices
(vocabulary codebook_size ** num_codebooks): each code is embedded, the
sequence is shifted right by a learned SOS vector and run causally through
a TransformerEncoder with the relative bias, and one head gives the next
code's logits. Train mode (the module's) takes the attention's training
route (the relative-bias kernels on CUDA) with dropout; the compute dtype
is f32, as in JAX, but for the transformer layers under
VQCPCB_COMPUTE_DTYPE=bfloat16 (utils.layer_compute_dtype), in training and
in `sample_window` alike.

`sample_window` is the KV-cached sampler: one prefill per window that has
a fixed context (the relative-bias forward kernel in every layer on CUDA),
then one decode step per code in plain PyTorch, as `Decoder.sample_range`. Its tempering follows
the reference: the logits are *multiplied* by the temperature, so a higher
temperature sharpens the distribution.

`n_head_kv` makes the layers grouped-query (ops/attention.py; prior.py:33):
the caches hold n_head_kv heads.

Parameter names follow the JAX module (embedding, linear, sos,
transformer.layers.{i}, pre_softmax).

Under a model axis (parallel/mesh.py shard_params) the head is
vocabulary-parallel when the vocabulary divides the axis: this rank's rows
of pre_softmax, the logits all-gathered before the cross entropy.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from vqcpcb_tpu_torch.ops.kv_cache import Cache, cache_update, new_cache
from vqcpcb_tpu_torch.ops.losses import categorical_crossentropy
from vqcpcb_tpu_torch.ops.masks import causal_mask
from vqcpcb_tpu_torch.ops.sampling import sample_categorical
from vqcpcb_tpu_torch.ops.transformer import TransformerEncoder, train_mode
from vqcpcb_tpu_torch.parallel.collectives import copy_to_model, gather_from_model
from vqcpcb_tpu_torch.utils import kv_cache_dtype, module_device, to_device


class PriorRelative(nn.Module):
    def __init__(self, code_vocab_size: int, d_model: int, num_layers: int,
                 n_head: int, dim_feedforward: int, embedding_size: int,
                 num_channels: int, num_events: int, dropout: float,
                 n_head_kv: Optional[int] = None):
        super().__init__()
        if num_channels != 1:
            raise ValueError(f"the prior has one channel, not {num_channels} "
                             "(prior.py:40)")
        self.num_channels = num_channels
        self.num_events = num_events
        self.embedding = nn.Embedding(code_vocab_size, embedding_size)
        self.linear = nn.Linear(embedding_size, d_model)
        self.sos = nn.Parameter(torch.randn(1, 1, d_model))
        self.transformer = TransformerEncoder(
            num_layers, d_model, n_head, "relative_attention", num_channels,
            num_events, dim_feedforward, dropout, n_head_kv=n_head_kv)
        self.pre_softmax = nn.Linear(d_model, code_vocab_size)
        self.head_mesh = None            # set by set_mesh when it splits the head

    def set_mesh(self, mesh, specs) -> None:
        self.head_mesh = (mesh if specs.get("pre_softmax.weight") is not None
                          else None)

    @property
    def num_tokens(self) -> int:
        return self.num_channels * self.num_events

    def _shifted_input(self, x: torch.Tensor) -> torch.Tensor:
        """Codes (B, T) -> the transformer's input (B, T, d_model): the
        embedded codes shifted right by one, SOS first."""
        x_seq = self.linear(self.embedding(x.long()))
        sos = self.sos.expand(x.shape[0], 1, -1)
        return torch.cat([sos, x_seq[:, :-1]], dim=1)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, num_tokens) code indices -> logits (B, num_tokens, V)
        (prior.py:57)."""
        out = self.transformer(self._shifted_input(x),
                               causal_mask(x.shape[1], device=x.device))
        mesh = self.head_mesh
        if mesh is None:
            return self.pre_softmax(out)
        return gather_from_model(self.pre_softmax(copy_to_model(out, mesh)), mesh)

    def forward(self, x: torch.Tensor) -> Dict:
        """The next-code cross entropy of codes (B, num_tokens) (prior.py:67):
        {'loss', 'weights_per_category': [logits],
        'monitored_quantities': {'loss'}}."""
        logits = self.logits(x)
        loss = categorical_crossentropy([logits], x[..., None])
        return {"loss": loss, "weights_per_category": [logits],
                "monitored_quantities": {"loss": loss}}

    # ---- KV-cached sampling ---------------------------------------------------

    def _embed_input_at(self, prev_code: torch.Tensor) -> torch.Tensor:
        """Transformer input at a position whose previous code is prev_code
        (B,) -> (B, d_model). The prior has no positional features (only
        the relative bias), so it does not depend on the position."""
        return self.linear(self.embedding(prev_code.long()))

    def prefill(self, x: torch.Tensor, cache_dt: Optional[torch.dtype] = None
                ) -> List[Tuple[Cache, Cache]]:
        """Causal full forward over the SOS-shifted window x (B, T), filling
        each layer's self-attention caches: per layer (k, v) of (B, H_kv, T,
        hd) in the format for cache_dt (prior.py:93)."""
        out = self._shifted_input(x)
        mask = causal_mask(x.shape[1], device=x.device)
        caches = []
        for layer in self.transformer.layers:
            out, (k, v) = layer.capture(out, mask)
            caches.append((new_cache(k.contiguous(), cache_dt),
                           new_cache(v.contiguous(), cache_dt)))
        return caches

    def _empty_caches(self, b: int, length: int,
                      cache_dt: Optional[torch.dtype]
                      ) -> List[Tuple[Cache, Cache]]:
        """Zero self-attention caches of the shape prefill fills: a window
        sampled from position 0 writes each row before it reads it."""
        caches = []
        for layer in self.transformer.layers:
            attn = layer.self_attn
            zeros = self.sos.new_zeros((b, attn.num_kv_heads, length,
                                        attn.head_dim))
            caches.append((new_cache(zeros, cache_dt),
                           new_cache(zeros.clone(), cache_dt)))
        return caches

    @torch.no_grad()
    def sample_window(self, x_init, start: int, num_steps: int,
                      generator: torch.Generator, temperature: float = 1.0,
                      top_k: int = 0, device=None) -> torch.Tensor:
        """Sample window positions [start, start + num_steps) autoregressively
        (prior.py:114), in eval mode.

        x_init (B, T) codes, the fixed context in [0, start). The logits are
        multiplied by `temperature` (p ~ softmax(logits) ** temperature, the
        reference's rule) and filtered to the top_k (0: none; 1 is greedy).
        Runs on `device` -- the card unless the caller names another; the
        module must already live there. Caches follow utils.kv_cache_dtype;
        a window sampled from position 0 has no context to prefill, so its
        caches start as zeros. Returns the updated (B, T) codes (int64) on
        that device."""
        here = module_device(self, device)
        x = to_device(x_init, here).long().clone()
        b, num_tokens = x.shape
        cache_dt = kv_cache_dtype(here)
        with train_mode(self, False):
            caches = (self.prefill(x, cache_dt) if start > 0
                      else self._empty_caches(b, num_tokens, cache_dt))
            for t in range(start, start + num_steps):
                x_t = (self._embed_input_at(x[:, t - 1]) if t > 0
                       else self.sos[0].expand(b, -1))
                out = x_t[:, None]
                for layer, (k_cache, v_cache) in zip(self.transformer.layers,
                                                     caches):
                    k_t, v_t = layer.self_attn.project_kv(out)
                    cache_update(k_cache, k_t, t)
                    cache_update(v_cache, v_t, t)
                    out = layer.step(out, k_cache, v_cache, t, num_tokens)
                logits = self.pre_softmax(out[:, 0])
                x[:, t] = sample_categorical(generator, logits * temperature,
                                             1.0, top_k)
        return x
