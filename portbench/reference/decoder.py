"""The AC/D/C relative decoder of configs/decoder_relative_AC_D_C_random.py
in plain PyTorch (arXiv:2004.10120, Section 3.3; the reference VQCPCB
code's layer order and names).

Source: each code embedded to d_model, then 3 post-LN encoder layers
(relative-bias self-attention under the anticausal mask, FF with ReLU).
Target: per-voice token embeddings with a channel and an event-in-code
feature, a linear map to d_model, shifted right behind a learned SOS, then
3 post-LN decoder layers: causal relative-bias self-attention, the
diagonal ("aligned") cross branch -- an MLP of each code's memory row
(d -> 2d, ELU, -> 4 d), one d-row per voice, broadcast over the code's 4
events -- and the FF. Per-voice output heads; the loss is the sum over
voices of the mean cross entropy. LayerNorms use eps 1e-6; q is scaled by
d_head^-1/2 before the bias.

`Precision` covers the products the configuration states in bf16 (the
attention projections and dots, the FF, the heads); `kv_round` rounds the
decoder self-attention's K and V rows as a decode cache would."""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.nets import (Draws, Precision, anticausal, causal,
                                      attention_keep, layer_norm,
                                      relbias_attention, round_rows)

F32 = Precision("f32")


def _attention(w, name, x, mask, cfg, prec, draws, kv_round=None):
    """Self-attention of one layer: x (B, L, d) -> (B, L, d) before drop1."""
    b, n, d = x.shape
    h = cfg["n_head"]
    hd = d // h
    qkv = prec.linear(x, w[f"{name}.in_proj_weight"], w[f"{name}.in_proj_bias"])
    q, k, v = (t.reshape(b, n, h, hd).transpose(1, 2) for t in qkv.chunk(3, -1))
    q = q * hd ** -0.5
    k, v = round_rows(k, kv_round), round_rows(v, kv_round)
    e1 = w[f"{name}.attn_bias.e1"].reshape(h, n, hd)
    e2 = w[f"{name}.attn_bias.e2"].reshape(h, n, hd)
    keep, rate = None, cfg["dropout"] if draws is not None else 0.0
    if rate > 0.0:
        keep = attention_keep(b, h, n, n, rate, draws.attention_seed(), x.device)
    out = relbias_attention(q, k, v, mask, e1, e2, prec, keep, rate)
    out = out.transpose(1, 2).reshape(b, n, d)
    return prec.linear(out, w[f"{name}.out_proj.weight"], w[f"{name}.out_proj.bias"])


def _dropout(draws, x, rate, dtype):
    return x if draws is None else draws.dropout(x, rate, dtype)


def _feed_forward(w, name, x, cfg, prec, draws, dt):
    hid = F.relu(prec.linear(x, w[f"{name}.linear1.weight"], w[f"{name}.linear1.bias"]))
    hid = _dropout(draws, hid, cfg["dropout"], dt)
    return prec.linear(hid, w[f"{name}.linear2.weight"], w[f"{name}.linear2.bias"])


def memory(w, codes, cfg, prec: Precision = F32, draws: Optional[Draws] = None,
           dt=torch.float32) -> torch.Tensor:
    """Codes (B, S) -> the encoder stack's output (B, S, d). dt: the dtype
    of the program's activations at its dropout points."""
    x = w["source_embeddings.weight"][codes.long()]
    mask = anticausal(x.shape[1], x.device)
    rate = cfg["dropout"]
    for i in range(cfg["num_encoder_layers"]):
        name = f"transformer.encoder.layers.{i}"
        a = _attention(w, f"{name}.self_attn", x, mask, cfg, prec, draws)
        x = layer_norm(x + _dropout(draws, a, rate, dt), w[f"{name}.norm1.weight"],
                       w[f"{name}.norm1.bias"])
        f = _feed_forward(w, name, x, cfg, prec, draws, dt)
        x = layer_norm(x + _dropout(draws, f, rate, dt), w[f"{name}.norm2.weight"],
                       w[f"{name}.norm2.bias"])
    return x


def logits(w, codes, target, cfg, prec: Precision = F32,
           draws: Optional[Draws] = None, kv_round: Optional[str] = None,
           dt=torch.float32) -> List[torch.Tensor]:
    """Teacher-forced per-voice logits [(B, events, vocab_c)] of target
    (B, events, voices) under codes (B, S)."""
    mem = memory(w, codes, cfg, prec, draws, dt)
    b, events, voices = target.shape
    n = events * voices
    d = cfg["d_model"]
    up = cfg["total_upscaling"]
    emb = torch.stack([w[f"data_processor.embeddings.{c}.weight"][target[..., c].long()]
                       for c in range(voices)], dim=-2).reshape(b, n, -1)
    channel = w["target_channel_embeddings"].repeat(b, n // voices, 1)
    event = w["target_events_positioning_embeddings"].repeat_interleave(
        voices, dim=1).repeat(b, n // up, 1)
    x = F.linear(torch.cat([emb, channel, event], 2), w["linear_target.weight"],
                 w["linear_target.bias"])
    x = torch.cat([w["sos"].expand(b, 1, d), x[:, :-1]], dim=1)
    mask = causal(n, x.device)
    rate = cfg["dropout"]
    n_mem = mem.shape[1]
    for i in range(cfg["num_decoder_layers"]):
        name = f"transformer.decoder.layers.{i}"
        a = _attention(w, f"{name}.self_attn", x, mask, cfg, prec, draws, kv_round)
        x = layer_norm(x + _dropout(draws, a, rate, dt), w[f"{name}.norm1.weight"],
                       w[f"{name}.norm1.bias"])
        hid = F.elu(F.linear(mem, w[f"{name}.cross_attn.0.weight"],
                             w[f"{name}.cross_attn.0.bias"]))
        cross = F.linear(hid, w[f"{name}.cross_attn.2.weight"],
                         w[f"{name}.cross_attn.2.bias"])            # (B, S, d*C)
        cross = cross.reshape(b, n_mem, d, voices).transpose(2, 3)  # (B, S, C, d)
        cross = cross[:, :, None].expand(b, n_mem, n // voices // n_mem, voices,
                                         d).reshape(b, n, d)
        x = layer_norm(x + _dropout(draws, cross, rate, torch.float32),
                       w[f"{name}.norm2.weight"], w[f"{name}.norm2.bias"])
        f = _feed_forward(w, name, x, cfg, prec, draws, dt)
        x = layer_norm(x + _dropout(draws, f, rate, dt), w[f"{name}.norm3.weight"],
                       w[f"{name}.norm3.bias"])
    out = x.reshape(b, events, voices, d)
    return [prec.linear(out[:, :, c], w[f"pre_softmaxes.{c}.weight"],
                        w[f"pre_softmaxes.{c}.bias"]) for c in range(voices)]


def loss(w, codes, target, cfg, prec: Precision = F32,
         draws: Optional[Draws] = None, dt=torch.float32) -> torch.Tensor:
    """Sum over voices of the mean cross entropy of the next token."""
    per_voice = logits(w, codes, target, cfg, prec, draws, dt=dt)
    return sum(F.cross_entropy(lg.reshape(-1, lg.shape[-1]).float(),
                               target[..., c].reshape(-1).long())
               for c, lg in enumerate(per_voice))


def weight_spec(cfg: dict, vocab_sizes):
    """The decoder's leaves, their shapes and initial distributions."""
    from portbench.harness.weights import layer_norm, linear
    d, h, ff, p = cfg["d_model"], cfg["n_head"], cfg["dim_feedforward"], \
        cfg["positional_embedding_size"]
    voices = cfg["num_voices"]
    s_mem = cfg["sequences_size"]
    n = cfg["num_events"] * voices
    spec = [("source_embeddings.weight",
             (cfg["config_encoder"]["codebook_size"], d), "normal", 1.0),
            ("target_channel_embeddings", (1, voices, p), "normal", 1.0),
            ("target_events_positioning_embeddings",
             (1, cfg["total_upscaling"] // voices, p), "normal", 1.0),
            ("sos", (1, 1, d), "normal", 1.0)]
    spec += linear("linear_target", cfg["embedding_size"] + 2 * p, d)
    spec += [(f"data_processor.embeddings.{c}.weight", (v + 1, cfg["embedding_size"]),
              "normal", 1.0) for c, v in enumerate(vocab_sizes)]

    def attention(name, s):
        return [(f"{name}.in_proj_weight", (3 * d, d), "normal", (2.0 * d) ** -0.5),
                (f"{name}.in_proj_bias", (3 * d,), "const", 0.0),
                (f"{name}.out_proj.weight", (d, d), "normal", d ** -0.5),
                (f"{name}.out_proj.bias", (d,), "const", 0.0),
                (f"{name}.attn_bias.e1", (h * s, d // h), "normal", 1.0),
                (f"{name}.attn_bias.e2", (h * s, d // h), "normal", 1.0)]

    for i in range(cfg["num_encoder_layers"]):
        name = f"transformer.encoder.layers.{i}"
        spec += attention(f"{name}.self_attn", s_mem)
        spec += linear(f"{name}.linear1", d, ff) + linear(f"{name}.linear2", ff, d)
        spec += layer_norm(f"{name}.norm1", d) + layer_norm(f"{name}.norm2", d)
    for i in range(cfg["num_decoder_layers"]):
        name = f"transformer.decoder.layers.{i}"
        spec += attention(f"{name}.self_attn", n)
        spec += linear(f"{name}.cross_attn.0", d, 2 * d)
        spec += linear(f"{name}.cross_attn.2", 2 * d, d * voices)
        spec += linear(f"{name}.linear1", d, ff) + linear(f"{name}.linear2", ff, d)
        for k in (1, 2, 3):
            spec += layer_norm(f"{name}.norm{k}", d)
    for c, v in enumerate(vocab_sizes):
        spec += linear(f"pre_softmaxes.{c}", d, v)
    return spec
