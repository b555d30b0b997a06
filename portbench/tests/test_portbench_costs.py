"""The costs files' operation and byte counts against hand counts at tiny
shapes, and the K2 bound against PERF.md's kernel table."""
import copy

from portbench.harness import peaks, registry

DECODER = registry.module("costs", "vqcpc-decoder-ACDC")
ENCODER = registry.module("costs", "vqcpc-encoder-random")


def tiny_decoder():
    cfg = copy.deepcopy(registry.cell("flagship-train")["config"])
    cfg.update(d_model=8, n_head=2, num_encoder_layers=1, num_decoder_layers=1,
               dim_feedforward=16, num_events=4, sequences_size=1, embedding_size=2,
               positional_embedding_size=1)
    cfg["vocabulary"] = {"voice_ranges": [[60, 60]] * 4, "specials": []}
    cfg["config_encoder"].update(embedding_size=2, hidden_size=3, downscaler_layers=1,
                                 codebook_size=2, codebook_dim=1,
                                 upscaler_hidden_size=2, upscaler_output_dim=2)
    return cfg


def test_decoder_train_step_by_hand():
    # encoder: 16 GRU steps of 2 -> 3 (input 2*16*2*9, hidden 2*16*3*9) in
    # two directions, 6 -> 1 output, 1 x 2 distances, 1 -> 2 -> 2 upscaler
    encoder = 2 * (576 + 864) + 12 + 4 + 12
    # memory layer at length 1: in_proj 384, 3 dots of 4 over 1 entry and 2
    # heads 48, out 128, FF 512; target linear 16 x 4 -> 8: 1024; decoder
    # layer at 16: in_proj 6144, dots 3*2*2*136*4, out 2048, FF 8192; cross
    # 1 x 8 -> 16 -> 32: 1280; heads 4 events x 8 -> 4: 256
    decoder = 1072 + 1024 + (6144 + 6528 + 2048 + 8192) + 1280 + 256
    traffic = {"tensors": {"x": [1, 4, 4]}}
    assert DECODER.train_flops(tiny_decoder(), traffic) == encoder + 3 * decoder


def test_decode_steps_by_hand():
    cfg = tiny_decoder()
    # t = 0: no input embedding (SOS), one cached position; t = 1: 4 -> 8
    # embedding, two cached positions; a head of 8 -> 1
    assert DECODER.decode_step(cfg, 1, 0) == 1072 + 16
    assert DECODER.decode_step(cfg, 1, 1) == 64 + (384 + 96 + 128 + 512) + 16


def test_relbias_bound_matches_the_kernel_table():
    """PERF.md's K2-fwd bound at B = 32, T = S = 384: 0.0157 ms, by bytes."""
    cfg = registry.cell("flagship-train")["config"]
    (_, _, _), (count, fwd, bwd) = DECODER.relbias_bounds(cfg, 32)
    act = 2 * 32 * 384 * 512
    side = 4 * 384 * 384 + 4 * 8 * 767 * 64
    assert fwd == (4 * act + side, 3 * 2 * (384 * 385 // 2) * 64 * 32 * 8)
    assert bwd == (7 * act + 2 * side, 8 * 2 * (384 * 385 // 2) * 64 * 32 * 8)
    assert abs(peaks.least_seconds(*fwd) * 1e3 - 0.0157) < 1e-4


def test_encoder_train_step_by_hand():
    cfg = copy.deepcopy(registry.cell("encoder-train")["config"])
    cfg.update(hidden_size=2, embedding_size=1, downscaler_layers=1, codebook_size=2,
               codebook_dim=1, upscaler_hidden_size=1, upscaler_output_dim=1,
               context_hidden_size=1, context_layers=1, context_output_dim=1,
               num_blocks_left=1, num_blocks_right=1)
    traffic = {"tensors": {"x_left": [1, 4, 4], "x_right": [1, 4, 4],
                           "negative_samples": [1, 1, 1, 4, 4]}}
    # 3 blocks of 16 steps, GRU 1 -> 2 both ways 2 * (576 + 1152); 4 -> 1
    # output, distances, upscaler; the context GRU of 1 step 1 -> 1 and its
    # map; two bilinear scores of 4 each
    forward = 2 * 1728 + 24 + 12 + 12 + (6 + 6) + 2 + 8
    assert ENCODER.train_flops(cfg, traffic) == 3 * forward
