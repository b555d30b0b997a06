"""Operations of a VQ-CPC training step, from the shapes: the encoder on
the negatives', the left and the right blocks, the context GRU and its
linear map, the bilinear scores; forward times 3 (forward and backward),
nothing recomputed."""
from __future__ import annotations


def mm(n: int, i: int, o: int) -> int:
    return 2 * n * i * o


def gru(steps: int, width: int, h: int, layers: int) -> int:
    total = 0
    for layer in range(layers):
        total += mm(steps, width if layer == 0 else h, 3 * h) + mm(steps, h, 3 * h)
    return total


def forward(cfg: dict, traffic: dict) -> int:
    t = traffic["tensors"]
    b, n, k = t["negative_samples"][:3]
    block = cfg["num_tokens_per_block"]
    blocks = b * n * k + (t["x_left"][0] * t["x_left"][1] * t["x_left"][2]
                          + t["x_right"][0] * t["x_right"][1] * t["x_right"][2]) // block
    h, cd, z = cfg["hidden_size"], cfg["codebook_dim"], cfg["upscaler_output_dim"]
    encoder = (2 * gru(blocks * block, cfg["embedding_size"], h, cfg["downscaler_layers"])
               + mm(blocks, 2 * h, cd) + mm(blocks, cd, cfg["codebook_size"])
               + mm(blocks, cd, cfg["upscaler_hidden_size"])
               + mm(blocks, cfg["upscaler_hidden_size"], z))
    left_blocks = cfg["num_blocks_left"]
    c = cfg["context_output_dim"]
    context = (gru(b * left_blocks, z, cfg["context_hidden_size"], cfg["context_layers"])
               + mm(b, cfg["context_hidden_size"], c))
    scores = (b * k + b * n * k) * (mm(1, c, z) + 2 * z)
    return encoder + context + scores


def train_flops(cfg: dict, traffic: dict) -> int:
    return 3 * forward(cfg, traffic)
