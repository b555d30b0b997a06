"""Operations and bytes of the flagship decoder's work, from the shapes.

Operations are the multiply-adds of the products times 2; attention counts
only the live (unmasked) entries of its score, bias and weighting products.
A training step counts the frozen encoder's forward once and the decoder's
forward three times (forward and backward), nothing recomputed. A
generation call counts the encode, the memory stack and its cross branch,
and one decode step per position over the cache (the decoder stack's
prefill rows, which decoding from position 0 overwrites, are not counted).
"""
from __future__ import annotations

from portbench.harness import peaks, traffic


def mm(n: int, i: int, o: int) -> int:
    return 2 * n * i * o


def live(t: int, s: int) -> int:
    """Entries of a causal or anticausal T = S mask (the diagonal kept)."""
    return t * (t + 1) // 2


def encoder_forward(cfg: dict, rows: int) -> int:
    """The GRU encoder over rows of num_events x voices tokens."""
    e = cfg["config_encoder"]
    blocks = rows * cfg["num_events"] * cfg["num_voices"] // e["num_tokens_per_block"]
    steps = blocks * e["num_tokens_per_block"]
    h = e["hidden_size"]
    gru = 0
    for layer in range(e["downscaler_layers"]):
        width = e["embedding_size"] if layer == 0 else h
        gru += mm(steps, width, 3 * h) + mm(steps, h, 3 * h)
    return (2 * gru + mm(blocks, 2 * h, e["codebook_dim"])
            + mm(blocks, e["codebook_dim"], e["codebook_size"])
            + mm(blocks, e["codebook_dim"], e["upscaler_hidden_size"])
            + mm(blocks, e["upscaler_hidden_size"], e["upscaler_output_dim"]))


def _layer(cfg: dict, rows: int, length: int) -> int:
    """One self-attention layer with its FF over rows x length tokens."""
    d, ff, h = cfg["d_model"], cfg["dim_feedforward"], cfg["n_head"]
    n = rows * length
    return (mm(n, d, 3 * d) + 3 * 2 * rows * h * live(length, length) * (d // h)
            + mm(n, d, d) + mm(n, d, ff) + mm(n, ff, d))


def _cross(cfg: dict, rows: int) -> int:
    d, s = cfg["d_model"], cfg["sequences_size"]
    return mm(rows * s, d, 2 * d) + mm(rows * s, 2 * d, d * cfg["num_voices"])


def decoder_forward(cfg: dict, rows: int) -> int:
    """The decoder's teacher-forced forward over rows of 384 tokens."""
    d, p = cfg["d_model"], cfg["positional_embedding_size"]
    n = cfg["num_events"] * cfg["num_voices"]
    vocab = sum(traffic.vocab_sizes(cfg["vocabulary"]))
    return (cfg["num_encoder_layers"] * _layer(cfg, rows, cfg["sequences_size"])
            + mm(rows * n, cfg["embedding_size"] + 2 * p, d)
            + cfg["num_decoder_layers"] * (_layer(cfg, rows, n) + _cross(cfg, rows))
            + mm(rows * cfg["num_events"], d, vocab))


def train_flops(cfg: dict, traffic: dict) -> int:
    rows = traffic["tensors"]["x"][0]
    return encoder_forward(cfg, rows) + 3 * decoder_forward(cfg, rows)


def decode_step(cfg: dict, rows: int, t: int) -> int:
    """Position t: the input embedding, every layer over the cached t + 1
    positions, the voice's head."""
    d, ff, h, p = cfg["d_model"], cfg["dim_feedforward"], cfg["n_head"], \
        cfg["positional_embedding_size"]
    vocab = traffic.vocab_sizes(cfg["vocabulary"])[t % cfg["num_voices"]]
    per_layer = (mm(rows, d, 3 * d) + 3 * 2 * rows * h * (t + 1) * (d // h)
                 + mm(rows, d, d) + mm(rows, d, ff) + mm(rows, ff, d))
    embed = mm(rows, cfg["embedding_size"] + 2 * p, d) if t else 0
    return embed + cfg["num_decoder_layers"] * per_layer + mm(rows, d, vocab)


def generate_flops(cfg: dict, traffic: dict) -> int:
    rows = traffic["tensors"]["templates"][0] * traffic["tile"]
    positions = cfg["num_events"] * cfg["num_voices"]
    return (encoder_forward(cfg, rows)
            + cfg["num_encoder_layers"] * _layer(cfg, rows, cfg["sequences_size"])
            + cfg["num_decoder_layers"] * _cross(cfg, rows)
            + sum(decode_step(cfg, rows, t) for t in range(positions)))


def relbias_bounds(cfg: dict, rows: int, elem_bytes: int = 2):
    """(bytes, operations) of one K2 forward and one K2 backward at each of
    a training step's self-attention shapes: [(count, fwd, bwd)], each
    (bytes, operations). q, k, v, out (fwd) and q, k, v, do, dq, dk, dv
    (bwd) once each in the activations' type, the (H, 2S-1, d) f32 table,
    the f32 (T, S) mask; 3 and 8 products of d over the live entries."""
    d, h = cfg["d_model"], cfg["n_head"]
    out = []
    for count, t in ((cfg["num_encoder_layers"], cfg["sequences_size"]),
                     (cfg["num_decoder_layers"], cfg["num_events"] * cfg["num_voices"])):
        act = elem_bytes * rows * t * d
        side = 4 * t * t + 4 * h * (2 * t - 1) * (d // h)
        prod = 2 * live(t, t) * (d // h) * rows * h
        out.append((count, (4 * act + side, 3 * prod), (7 * act + 2 * side, 8 * prod)))
    return out


def relbias_least_seconds(cfg: dict, traffic: dict) -> float:
    """The least time of a training step's K2 launches."""
    rows = traffic["tensors"]["x"][0]
    return sum(count * (peaks.least_seconds(*fwd) + peaks.least_seconds(*bwd))
               for count, fwd, bwd in relbias_bounds(cfg, rows))
