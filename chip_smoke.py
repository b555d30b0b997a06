"""Smoke run of the PyTorch + CUDA port (vqcpcb_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py             # the smoke run
    python3 chip_smoke.py --profile   # plus profiler breakdowns of sampling,
                                      # of 3 decoder train steps, of 3
                                      # encoder train steps, of 3 student
                                      # train steps and of 3 prior train
                                      # steps

Phases, in order; any failure raises and the run exits non-zero:
  1. environment: the card's name and power limit, torch / CUDA versions,
     TF32 off for matmuls and cuDNN (the comparisons below are in f32);
  2. build every CUDA kernel of the port from csrc/ with nvcc (sm_90a), one
     nvcc per source, all started together;
  3. nearest-codebook kernel (the one the shape picks: a compiled instance
     at every main path's shape) vs its plain PyTorch version and, for an
     instance, vs the run-time kernel bit for bit, at every main path's
     shape and at odd ones; timed at the main paths' shapes by events and by
     device time beside the run-time kernel, an empty kernel launched on the
     run-time kernel's grid (the launch floor) and one that only loads x
     and the codebook and stores an int a row (the I/O floor);
  4. relative-bias attention forward kernel (inference) vs its plain
     version and, at its three batch-8 shapes, the forward's bf16 weights
     bit for bit, timed beside its bound and beside
     scaled_dot_product_attention as a yardstick;
  5. relative-bias attention training kernels (forward and backward, with
     dropout, packed and (B, H, L, d) layouts, T/S = 1, 4 and 16) vs their
     plain versions, the dropout mask and, at batch 32, the forward's bf16
     w_drop and the backward's bf16 w_drop and ds scratch bit for bit, timed
     at the flagship training shape beside SDPA's autograd backward by its
     device time; then with no mask at the student's lengths T = S = 384,
     96, 24, 16 and 4 (packed, dropout 0 and 0.2, the dropout mask at 16),
     and K2-fwd, K2-bwd and K3-fwd held and timed at every batch the main
     paths give them with no mask (the student's, the transformer
     downscaler's in VQ-CPC training, the decoder CLI's encode); then the
     prior's causal T = S = 24: K2 at its batch of 64 (dropout 0 and 0.1,
     the dropout mask), K3-fwd there and at the sampling batch 512 and the
     CLI's generation batch 1, held and timed;
  6. fused attention: K4 at batch 512 at the absolute decoder's three
     shapes and at batch 8 with the explicit-bias prefill's real bias, K6's
     forward and backward at batch 32 with the placeholder and
     with a real bias (dmask and dbias once), dropout 0 and 0.2, the mask,
     the forward's bf16 w_drop (T = 384) and the backward's bf16 w_drop and
     ds scratch bit for bit, each vs its plain version and timed (SDPA's
     backward by its device time);
  7. the re-harmonisation serving path end to end at full width (random
     weights from a seed), for the flagship AC/D/C decoder and for the
     absolute decoder: encoder codes, KV-cached sampling at batch 512,
     re-harmonisation of a random template, the launches of one prefill,
     and kernel-route vs plain-route logits plus greedy KV-cached tokens vs
     the teacher-forced argmax;
  8. decoder training at full width, flagship and absolute: DecoderTrainer
     steps at batch 32 with bf16 transformer layers and dropout 0.2 (falling loss,
     ms/step, tokens/s, launches per step), and kernel-route vs CPU f32
     plain-route loss and gradients at batch 2, dropout 0; then the
     flagship with VQCPCB_PALLAS_RELBIAS=0 (the explicit-bias route: K6 in
     training, K4 at inference): a few train steps, one prefill, and its
     loss and gradients vs the in-kernel route at dropout 0;
  9. VQ-CPC encoder training at bench.py's geometry, full width: the
     card's eval forward vs the CPU's, then (a) VQCPCEncoderTrainer steps
     at batch 16 in f32 (5 warm-up, 100 timed as one window ->
     encoder_train_tokens_per_sec, 30 synced one by one -> median ms/step,
     3 K1 launches a step), (b) bench.py's trained guard on the port's own
     data path and EMA quantizer (300 steps on the synthetic corpus:
     held-out CPC accuracy and codebook perplexity), (c) with --profile, 3
     profiled steps;
 10. the student (distilled VQ-VAE) at configs/encoder_student_synthetic.py's
     full width and the VQ-CPC encoder with the relative-transformer
     downscaler: (a) StudentEncoderTrainer steps at batch 8 in f32 (5
     warm-up, 30 synced -> median ms/step, student_train_tokens_per_sec,
     launches per step, a falling teacher loss), (b) kernel-route vs CPU
     f32 plain-route losses and gradients at batch 8, dropout 0, the CPU
     route decoding the card's codes, (c) the
     same with the absolute auxiliary decoder (K6 in training, K4 in its
     eval step), (d) VQCPCEncoderTrainer steps with the transformer
     downscaler at bench.py's geometry (median ms/step, tokens/s, launches
     per step), (e) with --profile, 3 profiled student steps;
 11. the entry points, the CLIs as a user calls them, in process in
     build/entry_points: the encoder CLI -t on
     configs/encoder_random_synthetic.py (60 batches, then the cluster
     dumps), the decoder CLI -t on configs/decoder_synthetic.py (the
     flagship, 40 batches at 64) over that encoder, -l -r and -l
     --num_examples 1, the AC/AC/C decoder (decoder_type
     'transformer_relative') -t (10 batches) and -l -r, the encoder CLI -t
     (20 batches) and -l on configs/encoder_student_synthetic.py (the
     student), and the flagship decoder -t (10 batches) and -l -r over the
     student's encoder; then the checks: exit codes, model directories and
     metrics rows, written tokens inside the vocabulary, the reloaded
     decoders' and student's eval losses equal to the trained ones', one
     AC/AC/C step on the kernel route vs the f32 plain route; after the
     flagship decoder's calls, the prior CLI (configs/prior_config.py on the
     synthetic corpus over that encoder) -t (20 batches at 64) and -l -g
     through that decoder, its reloaded eval loss equal to the trained one;
     and the flagship's -l -r once more with VQCPCB_CODES_PER_WINDOW=2 and
     VQCPCB_EXACT_TOPP_TIES=1 (exit 0, 3 grids inside the vocabulary);
 12. the prior of configs/prior_config.py at full width: (a) PriorTrainer
     steps at batch 64 in f32 (5 warm-up, 30 synced -> median ms/step,
     prior_train_tokens_per_sec, codes/s, launches per step, a falling
     loss), (b) kernel-route vs CPU f32 plain-route loss and gradients at
     batch 8, dropout 0, (c) generate_codes at batch 512, 96 codes a row
     (codes/s, the launches of one prefill) and greedy KV-cached codes,
     from position 0 and from 12 after a fixed prefix, vs the
     teacher-forced argmax, (d) with --profile, 3 profiled steps and
     one profiled sampling window;
 13. one JSON line of per-kernel numbers, then the result line (printed
     last, after phase 14);
 14. the scale-up MIDI chain (scripts/r5_chain9.sh) through the CLIs in
     process in build/scaleup_midi, at the configs' full width: (a) 512
     .mid files from the port's writer (make_midi_corpus.py), their cache
     key, the encoder's and the decoder's windows built (count, seconds);
     (b) the encoder CLI -t on configs/encoder_scaleup_midi.py (40 batches)
     as configured, again with VQCPCB_REMAT=1, and 6 batches with
     VQCPCB_COMPUTE_DTYPE=bfloat16: epoch tokens/s, CLI seconds, median
     ms/step, peak memory of the train steps; (c) the decoder CLI -t on
     configs/decoder_scaleup_midi.py (20 batches) over the remat run's
     config.py, then -l -r --num_examples 1; (d) the prior CLI -t on
     configs/prior_scaleup_midi.py (20 batches), then -l -g; (e) the
     checks: exit codes, model directories, tokens inside the vocabulary,
     codes below 256, every written .mid parsed back, reloaded eval losses
     equal to the trained ones, every K1 launch on the d4_s16 instance.
The five runs of phases 7 and 8, the run of phase 9 (a), the three runs of
phase 10 (a), (c) and (d), the CLI calls of phase 11, the runs of phase 12
(a) and (c) and the CLI calls of phase 14 are the main paths: each is driven
with the launch counts set to 0 just before it and read just after. Every
K1 launch on them must run a compiled instance.

Without CUDA, or without the package beside it, it exits non-zero before
printing any result.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# Products that keep f32 accuracy at the card's fastest: 3xTF32 on the
# tensor cores, three TF32 products (495 TFLOP/s) for each.
F32_ACCURATE_FLOPS = 495e12 / 3

# Shapes of the slices at full width: 512 templates of 96 events x 4 voices,
# 24 codes each (blocks of 16 tokens), decoder d_model 512 / 8 heads;
# decoder training at batch 32 (BENCHMARKS.md's decoder-training batch).
BATCH = 512
TRAIN_BATCH = 32
TRAIN_STEPS = 30
TRAIN_DROPOUT = 0.2
NUM_EVENTS = 96
NUM_CODES = 24
HEADS = 8
HEAD_DIM = 64
CODEBOOK_SIZE = 32
# VQ-CPC encoder training at bench.py:52-88's geometry: batch 16, 6 + 6
# blocks of 16 tokens (4 ticks x 4 voices), 15 negatives per block,
# vocabulary 62 per voice; the negatives' 1,440 windows go through the
# encoder as one batch.
ENC_BATCH = 16
ENC_BLOCKS = 6
ENC_NEG = 15
ENC_VOCAB = 62
ENC_NEG_ROWS = ENC_BATCH * ENC_NEG * ENC_BLOCKS
# the decoder CLI's batch (configs/decoder_synthetic.py): its encode of 64 x
# 24 blocks; the prior's batch (configs/prior_config.py) is the same
DECODER_CLI_BATCH = 64
# the student's batch (configs/encoder_student_synthetic.py)
STUDENT_BATCH = 8
# the scale-up MIDI chain's K1 (configs/*_scaleup_midi.py, phase 14): (C, d,
# S) = (2, 4, 16) (codebook_dim 8 over 2 sub-codebooks), the d4_s16
# instance, on the encoder's 64 x 15 x 6 negative windows and 64 x 6 left
# or right blocks, the decoder's encode of 32 x 24 blocks and the prior's
# of 64 x 24
SCALEUP_K1 = (2, 4, 16)
SCALEUP_BATCH = 64
SCALEUP_NEG_ROWS = SCALEUP_BATCH * ENC_NEG * ENC_BLOCKS
SCALEUP_K1_ROWS = (SCALEUP_NEG_ROWS, SCALEUP_BATCH * ENC_BLOCKS,
                   TRAIN_BATCH * NUM_CODES, SCALEUP_BATCH * NUM_CODES)
ENC_WARMUP = 5
ENC_STEPS = 100
ENC_SYNCED = 30
GUARD_STEPS = 300


def log(msg: str) -> None:
    print(msg, flush=True)


def time_cuda(fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds per call: CUDA events around `reps` calls after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds of device time per call: the kernels' own time, summed
    by torch.profiler over `reps` calls after warm-up, without the host's
    gaps between them. Raises when the profiler saw no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    if busy_us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return busy_us / 1e3 / reps


def bound(bytes_moved: float, flops: float, peak_flops: float):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and flops / peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- phase 1 ---------------------------------------------------------------

def phase_environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"# tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    return card


# ---- phase 2 ---------------------------------------------------------------

def phase_build() -> None:
    from vqcpcb_tpu_torch.ops import _build
    t0 = time.perf_counter()
    seconds = _build.build_all()
    log(f"# build: {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
        f"wall {time.perf_counter() - t0:.2f} s")
    for name in _build.SOURCES:
        report = _build.library_path(name).with_suffix(".so.log")
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"# ptxas {name}: {line.strip()}")


# ---- phase 3 ---------------------------------------------------------------

def phase_vq(gen: torch.Generator) -> dict:
    """K1 against its plain version at the slices' shapes (the serving
    batch, the VQ-CPC step's, the student's 8 x 24 codes, the decoder CLI's
    and the prior's 64 x 24, the scale-up MIDI chain's four) and at odd
    ones, through the kernel the shape
    picks; where that is a compiled instance, its indices against the
    run-time kernel's bit for bit. At each main-path shape (each must pick
    an instance) timed by events and by device time, beside the run-time
    kernel's device time and the device time of an empty kernel launched on
    the run-time kernel's grid there (the launch floor) and of one that only
    loads x and the codebook and stores an int a row (the I/O floor of any
    correct K1). The top-level numbers are the serving shape's, as since the
    kernel was first ported."""
    from vqcpcb_tpu_torch.ops import vq_kernels as vk
    dev = torch.device("cuda")
    main_shapes = [(BATCH * NUM_CODES, 1, 3, CODEBOOK_SIZE),
                   (ENC_NEG_ROWS, 1, 3, CODEBOOK_SIZE),
                   (ENC_BATCH * ENC_BLOCKS, 1, 3, CODEBOOK_SIZE),
                   (STUDENT_BATCH * NUM_CODES, 1, 3, CODEBOOK_SIZE),
                   (DECODER_CLI_BATCH * NUM_CODES, 1, 3, CODEBOOK_SIZE)]
    main_shapes += [(n, SCALEUP_K1[0], SCALEUP_K1[1], SCALEUP_K1[2])
                    for n in SCALEUP_K1_ROWS]
    timed, kinds = {}, {}
    for n, k, d, s in main_shapes + [(300, 2, 8, 16), (7, 1, 130, 200),
                                     (1048576, 1, 3, CODEBOOK_SIZE)]:
        x = torch.randn((n, k, d), generator=gen, device=dev)
        e = torch.randn((k, s, d), generator=gen, device=dev)
        kind = kinds[f"({n},{k},{d},{s})"] = vk.kernel_kind(d, s)
        if (n, k, d, s) in main_shapes and kind == "runtime":
            raise AssertionError(f"the main-path shape ({n},{k},{d},{s}) picks "
                                 "the run-time kernel, not a compiled instance")
        got = vk.nearest_codebook_indices_cuda(x, e)
        want = vk.nearest_codebook_indices_plain(x, e)
        runtime = vk.nearest_codebook_indices_cuda(x, e, kind="runtime")
        torch.cuda.synchronize()
        # rows whose two smallest distances lie within 1e-6 relative of each
        # other may round either way between two summation orders
        dist = ((x * x).sum(-1, keepdim=True)
                - 2.0 * torch.einsum("nkd,ksd->nks", x, e)
                + (e * e).sum(-1)[None])
        two = dist.topk(2, dim=-1, largest=False).values
        margin = (two[..., 1] - two[..., 0]) > 1e-6 * two.abs().amax(-1).clamp_min(1.0)
        bad = ((got != want) & margin).sum().item()
        near = (~margin).sum().item()
        vs_runtime = (got != runtime).sum().item()
        log(f"# vq_nearest ({n},{k},{d},{s}): kernel {kind}; mismatches outside "
            f"the margin {bad}, rows inside the 1e-6 margin {near}, differing "
            f"there {((got != want) & ~margin).sum().item()}; indices differing "
            f"from the run-time kernel's {vs_runtime} (need 0)")
        if bad:
            raise AssertionError(f"vq_nearest disagrees with its plain version "
                                 f"on {bad} rows at ({n},{k},{d},{s})")
        if vs_runtime:
            raise AssertionError(f"the {kind} instance disagrees with the "
                                 f"run-time kernel on {vs_runtime} rows at "
                                 f"({n},{k},{d},{s})")
        if (n, k, d, s) in main_shapes:
            ms = time_cuda(lambda: vk.nearest_codebook_indices_cuda(x, e), 200)
            dev_ms = device_ms(lambda: vk.nearest_codebook_indices_cuda(x, e), 200)
            runtime_dev = device_ms(lambda: vk.nearest_codebook_indices_cuda(
                x, e, kind="runtime"), 200)
            floor_dev = device_ms(lambda: vk.launch_floor_cuda(n, k, dev), 200)
            floor_ms = time_cuda(lambda: vk.launch_floor_cuda(n, k, dev), 200)
            io_out = torch.empty((n, k), dtype=torch.int32, device=dev)
            io_dev = device_ms(lambda: vk.io_floor_cuda(x, e, io_out), 200)
            plain_ms = time_cuda(lambda: vk.nearest_codebook_indices_plain(x, e), 50)
            bytes_moved = 4 * (x.numel() + e.numel() + n * k)
            flops = n * k * s * (2 * d + 3) + n * k * 2 * d
            bound_ms, bound_by = bound(bytes_moved, flops, F32_FLOPS)
            # error as distance: how much farther the kernel's code lies
            # than the plain version's (0 when every index agrees)
            err = (dist.gather(-1, got.long()[..., None])
                   - dist.gather(-1, want.long()[..., None])).abs().max().item()
            timed[f"({n},{k},{d},{s})"] = dict(
                kind=kind, ms=ms, device_ms=dev_ms, runtime_device_ms=runtime_dev,
                plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err,
                empty_kernel_device_ms=floor_dev, empty_kernel_ms=floor_ms,
                io_floor_device_ms=io_dev, vs_io_floor=dev_ms / io_dev)
            log(f"# vq_nearest at ({n},{k},{d},{s}), {kind}: kernel {ms:.5f} ms "
                f"(device {dev_ms:.5f} ms), the run-time kernel device "
                f"{runtime_dev:.5f} ms, plain {plain_ms:.5f} ms, bound "
                f"{bound_ms:.7f} ms ({bound_by}); an empty kernel on the run-time "
                f"kernel's grid {floor_ms:.5f} ms (device {floor_dev:.5f} ms): "
                f"K1's device time is {dev_ms / floor_dev:.2f}x the launch "
                f"floor's; a kernel on that grid that only loads x and the "
                f"codebook and stores an int a row: device {io_dev:.5f} ms, K1 "
                f"{dev_ms / io_dev:.2f}x that I/O floor (the run-time kernel "
                f"{runtime_dev / io_dev:.2f}x)")
        elif n == 1048576:
            ms = time_cuda(lambda: vk.nearest_codebook_indices_cuda(x, e), 50)
            plain_ms = time_cuda(lambda: vk.nearest_codebook_indices_plain(x, e), 10)
            log(f"# vq_nearest at ({n},{k},{d},{s}), {kind}: kernel {ms:.5f} ms, "
                f"plain {plain_ms:.5f} ms")
    serving = timed[f"({BATCH * NUM_CODES},1,3,{CODEBOOK_SIZE})"]
    return dict(serving, max_abs_err=max(t["max_abs_err"] for t in timed.values()),
                shapes=timed, kinds=kinds)


# ---- phase 4 ---------------------------------------------------------------

# bf16 rule on both sides, the bound tests/test_torch_cuda.py derives: the two
# f32 reductions (CUDA-core FMA chains in the kernel, PyTorch's matmuls in the
# plain version) may round a softmax weight to the neighbouring bf16 value, one
# ulp = 2**-8 relative, moving an output by 2**-8 * w * |v|; only the small
# weights of long rows sit near enough to a rounding edge, which keeps that
# below 2e-3 with |v| < ~5.
RELBIAS_ATOL = 2e-3
# A kernel that skipped a bf16 rounding point (q/k/v/E before the dots, w
# before w.v) would land about as far from the bf16 plain version as the f32
# plain version does (1.6e-2 to 2.2e-2 at the shapes below on an H100). The
# kernel must also sit at least this many times closer to the bf16 rule than
# the two rules sit to each other, so the check holds at shapes or inputs
# where that gap is smaller.
RELBIAS_RULE_CONTRAST = 8.0

# Decoder logits, kernel route (bf16 dot inputs in the 6 relative-attention
# layers of the flagship; f32 in the absolute decoder's K4) against the f32
# plain route: each bf16 rounding is 2**-9 relative; through 6 post-LN layers
# the logits keep a few such errors, so 2e-2 of the largest logit bounds them
# with room and still catches a wrong kernel.
LOGITS_RTOL = 2e-2


def _relbias_inputs(gen, b, t, s, mask_kind):
    from vqcpcb_tpu_torch.ops.masks import anticausal_mask, causal_mask
    dev = torch.device("cuda")
    q = torch.randn((b, HEADS, t, HEAD_DIM), generator=gen, device=dev) * HEAD_DIM ** -0.5
    k = torch.randn((b, HEADS, s, HEAD_DIM), generator=gen, device=dev)
    v = torch.randn((b, HEADS, s, HEAD_DIM), generator=gen, device=dev)
    e1 = torch.randn((HEADS, s, HEAD_DIM), generator=gen, device=dev)
    e2 = torch.randn((HEADS, s, HEAD_DIM), generator=gen, device=dev)
    mask = (None if mask_kind == "unmasked"
            else causal_mask(t, device=dev) if mask_kind == "causal"
            else anticausal_mask(s, sz_tgt=t if t != s else None, device=dev))
    return q, k, v, mask, e1, e2


def phase_relbias(gen: torch.Generator) -> dict:
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    import torch.nn.functional as F
    worst = 0.0
    for name, t, s, kind in [("decoder self-attention", 384, 384, "causal"),
                             ("code encoder", 24, 24, "anticausal"),
                             ("ratio 4", 96, 24, "anticausal_rect")]:
        q, k, v, mask, e1, e2 = _relbias_inputs(gen, 8, t, s, kind)
        got = ak.relbias_attention_fwd_cuda(q, k, v, mask, e1, e2)
        want = ak.relbias_attention_fwd_plain(q, k, v, mask, e1, e2)
        want32 = ak.relbias_attention_fwd_plain(q, k, v, mask, e1, e2,
                                                torch.float32)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rule_gap = (want32 - want).abs().max().item()
        worst = max(worst, err)
        log(f"# relbias_attention {name} (B=8, H={HEADS}, T={t}, S={s}, "
            f"d={HEAD_DIM}, bf16 dots): max abs err {err:.3e} "
            f"(tolerance {RELBIAS_ATOL}); bf16 rule vs f32 rule {rule_gap:.3e} "
            f"(the error must stay below 1/{RELBIAS_RULE_CONTRAST:g} of it)")
        if not (err <= RELBIAS_ATOL
                and err * RELBIAS_RULE_CONTRAST <= rule_gap):
            raise AssertionError(f"relbias_attention {name}: max abs err {err}, "
                                 f"gap between the dot rules {rule_gap}")
        _hold_weights(f"relbias_attention {name} (B=8, f32 inputs)",
                      ak.relbias_attention_fwd_cuda,
                      ak.relbias_attention_bwd_weights_plain,
                      (q, k, v, mask, e1, e2, torch.zeros_like(q)),
                      dict(num_heads=None))
    # f32 dot rule at the code encoder's shape (K, V and the table in f32 fit
    # the block only at short source lengths)
    q, k, v, mask, e1, e2 = _relbias_inputs(gen, 8, 24, 24, "anticausal")
    err32 = (ak.relbias_attention_fwd_cuda(q, k, v, mask, e1, e2, torch.float32)
             - ak.relbias_attention_fwd_plain(q, k, v, mask, e1, e2,
                                              torch.float32)).abs().max().item()
    log(f"# relbias_attention code encoder, f32 dots: max abs err {err32:.3e} "
        "(tolerance 1e-4: f32 sums in two orders)")
    if not err32 <= 1e-4:
        raise AssertionError(f"relbias_attention f32 dots: max abs err {err32}")

    times = {}
    for label, t in (("decoder", 384), ("code encoder", 24)):
        q, k, v, mask, e1, e2 = _relbias_inputs(gen, BATCH, t, t, "causal" if t == 384 else "anticausal")
        ms = time_cuda(lambda: ak.relbias_attention_fwd_cuda(q, k, v, mask, e1, e2),
                       10 if t == 384 else 50)
        plain_ms = time_cuda(lambda: ak.relbias_attention_fwd_plain(q, k, v, mask, e1, e2),
                             3 if t == 384 else 20, warmup=1)
        from vqcpcb_tpu_torch.ops.relative_attention import subsampled_relative_bias
        full_mask = (mask + subsampled_relative_bias(q, e1, e2)).contiguous()
        library_ms = time_cuda(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=full_mask, scale=1.0), 3 if t == 384 else 20, warmup=1)
        del full_mask
        n = BATCH * HEADS
        bytes_moved = 4 * (4 * n * t * HEAD_DIM + t * t + HEADS * (2 * t - 1) * HEAD_DIM)
        flops = 3 * 2 * t * t * HEAD_DIM * n
        bound_ms, bound_by = bound(bytes_moved, flops, BF16_FLOPS)
        times[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
        log(f"# relbias_attention {label} at B={BATCH} (T=S={t}): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa(mask+bias) "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        del q, k, v, mask, e1, e2
        torch.cuda.empty_cache()
    return dict(times["decoder"], max_abs_err=worst, code_encoder=times["code encoder"])


# ---- phase 5 ---------------------------------------------------------------

# Training kernels vs their plain versions, bf16 dots on both sides: f32 sums
# in other orders may round a weight or a score gradient to the neighbouring
# bf16 value (2**-8 of one term of a sum), so each result must lie within
# GRAD_FRAC of its max |value| (bf16 outputs add 2**-9 relative of their own);
# and, as in phase 4, 8x closer to the bf16-rule plain version than the
# f32-rule one is, so a kernel that skipped a rounding point is caught.
GRAD_FRAC = 4e-3
TRAIN_RESULTS = ("out", "dq", "dk", "dv", "dmask", "de1", "de2")


def _pack(x):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _train_inputs(gen, b, t, s, kind, packed, dtype=torch.float32):
    q, k, v, mask, e1, e2 = _relbias_inputs(gen, b, t, s, kind)
    g = torch.randn(q.shape, generator=gen, device="cuda")
    if packed:
        q, k, v, g = (_pack(x) for x in (q, k, v, g))
    q, k, v, g = (x.to(dtype) for x in (q, k, v, g))
    return q, k, v, mask, e1, e2, g


def _fwd_bwd(fwd, bwd, q, k, v, mask, e1, e2, g, dot_dtype=torch.bfloat16,
             need_dmask=False, **kw):
    return [fwd(q, k, v, mask, e1, e2, dot_dtype, **kw),
            *bwd(q, k, v, mask, e1, e2, g, dot_dtype, need_dmask=need_dmask, **kw)]


def _hold(what, got, want, want32, worst, names=TRAIN_RESULTS,
          bwd_key="bwd", fracs=None) -> str:
    """Each result against the bf16-rule plain version: within GRAD_FRAC of
    its max |value| (or the fraction `fracs` names for it; plus one bf16
    step at that value for a result stored in bf16, where two f32 results a
    hair apart may round to neighbouring values); and, when the f32-rule
    plain version is given, 8x closer to the bf16 rule than the f32 rule is.
    Keeps the worst error in `worst`; returns the numbers for the log."""
    line = []
    for res, a, w, w32 in zip(names, got, want, want32 or [None] * len(want)):
        if a is None:
            continue
        err = (a.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        limit = (fracs or {}).get(res, GRAD_FRAC) * max(scale, 1e-30)
        if a.dtype == torch.bfloat16:
            limit += torch.finfo(torch.bfloat16).eps * scale
        key = "fwd" if res == "out" else bwd_key
        worst[key] = max(worst[key], err)
        ok = err <= limit
        if w32 is None:
            line.append(f"{res} {err:.2e}/{scale:.3g}")
        else:
            gap = (w32.float() - w.float()).abs().max().item()
            ok = ok and err * RELBIAS_RULE_CONTRAST <= gap
            line.append(f"{res} {err:.2e}/{gap:.2e}/{scale:.3g}")
        if not ok:
            raise AssertionError(f"{what}: {res} err {err} (limit {limit}), "
                                 f"{line[-1]}")
    return ", ".join(line)


def _hold_scratch(what, bwd, weights_plain, inputs, kw) -> str:
    """The backward's bf16 w_drop and ds scratch against the plain version's
    f32 values rounded to bf16: equal at every entry. A weight rounded to
    the other neighbouring bf16 value moves dv by one bf16 step of it times
    do, as far as a skipped rounding point would."""
    from vqcpcb_tpu_torch.ops._kernel_io import bwd_scratch, scratch_planes
    kw = {key: val for key, val in kw.items() if key != "need_dmask"}
    w_drop, ds = weights_plain(*inputs, **kw)
    b, h, t, s = ds.shape
    scratch = bwd_scratch(b, h, t, s, torch.bfloat16, ds.device)
    bwd(*inputs, need_dmask=False, scratch=scratch, **kw)
    differ = [(scratch_planes(x, b, h, t, s) != want.to(torch.bfloat16)).sum().item()
              for x, want in ((scratch[1], w_drop), (scratch[0], ds))]
    if any(differ):
        raise AssertionError(f"{what}: {differ[0]} bf16 w_drop and {differ[1]} ds "
                             "entries of the scratch differ from the plain version's")
    return f"bf16 w_drop and ds = the plain version's at all {b * h * t * s} entries"


def _hold_weights(what, fwd, weights_plain, inputs, kw) -> str:
    """The forward's bf16 w_drop against the plain version's f32 w_drop
    rounded to bf16: equal at every entry (the forward's counterpart of
    _hold_scratch). With v the one-hot columns of a block of 64 keys, the
    kernel's out is exactly its bf16 w_drop there: one product of a bf16
    weight and 1, and zeros, summed in f32. `inputs` is (q, k, v, mask,
    *extra, dout) as weights_plain takes them; fwd takes them without dout."""
    from vqcpcb_tpu_torch.ops._kernel_io import heads
    q, k, v, mask, *extra, g = inputs
    kw = {key: val for key, val in kw.items() if key != "need_dmask"}
    w_drop, _ = weights_plain(*inputs, **kw)
    b, h, t, s = w_drop.shape
    nh = kw.get("num_heads")
    d = heads(q, nh).shape[-1]
    differ = 0
    for c0 in range(0, s, d):
        n = min(d, s - c0)
        one_hot = torch.zeros((b, h, s, d), device="cuda")
        one_hot[:, :, c0:c0 + n, :n] = torch.eye(n, device="cuda")
        if nh:
            one_hot = one_hot.transpose(1, 2).reshape(b, s, h * d)
        # v shares k's strides, as the kernels ask (k, v may be slices of
        # one projection)
        vv = torch.empty_strided(k.shape, k.stride(), dtype=v.dtype, device="cuda")
        vv.copy_(one_hot)
        out = heads(fwd(q, k, vv, mask, *extra, **kw), nh)
        want = w_drop[..., c0:c0 + n].to(torch.bfloat16).float()
        differ += (out[..., :n].float() != want).sum().item()
        del out, one_hot
    log(f"# {what}: forward bf16 w_drop vs the plain version's, {differ} of "
        f"{b * h * t * s} entries differ (need 0)")
    if differ:
        raise AssertionError(f"{what}: {differ} entries of the forward's bf16 "
                             "w_drop differ from the plain version's")
    return f"forward bf16 w_drop = the plain version's at all {b * h * t * s} entries"


def _hold_dropout_mask(gen, name, t, s, kind) -> None:
    """The relative-bias forward's dropout mask, bit for bit: with v the
    one-hot columns of a block of 64 keys, the kernel's output is its
    dropped weight row there, kept where the hash keeps it."""
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    q, k, _, mask, e1, e2, _ = _train_inputs(gen, 4, t, s, kind, False)
    keep = ak.dropout_keep_plain((t, s), TRAIN_DROPOUT,
                                 ak._stream_seeds(99, 4, HEADS, "cuda"))
    mismatched = 0
    for c0 in range(0, s, HEAD_DIM):
        n = min(HEAD_DIM, s - c0)
        v = torch.zeros((4, HEADS, s, HEAD_DIM), device="cuda")
        v[:, :, c0:c0 + n, :n] = torch.eye(n, device="cuda")
        out = ak.relbias_attention_fwd_cuda(q, k, v, mask, e1, e2,
                                            dropout=TRAIN_DROPOUT, seed=99)
        w = ak.relbias_attention_fwd_plain(q, k, v, mask, e1, e2)
        live = w[..., :n] > 0
        mismatched += (((out[..., :n] != 0) & live)
                       != (keep[..., c0:c0 + n] & live)).sum().item()
    log(f"# relbias train {name}: dropout mask vs the hash, {mismatched} "
        f"of {4 * HEADS * t * s} entries differ (need 0)")
    if mismatched:
        raise AssertionError(f"dropout mask differs at {mismatched} entries")


def phase_relbias_train(gen: torch.Generator) -> dict:
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    import torch.nn.functional as F
    from vqcpcb_tpu_torch.ops.relative_attention import subsampled_relative_bias
    worst = {"fwd": 0.0, "bwd": 0.0}
    cases = [("decoder self-attention", 384, 384, "causal"),
             ("code encoder", 24, 24, "anticausal"),
             ("ratio 4", 96, 24, "anticausal_rect"),
             # the AC/AC/C decoder's relative cross-attention
             ("ratio 16", 384, 24, "anticausal_rect")]
    for name, t, s, kind in cases:
        for packed in (True, False):
            for rate in (0.0, TRAIN_DROPOUT):
                inputs = _train_inputs(gen, 4, t, s, kind, packed)
                kw = dict(num_heads=HEADS if packed else None, dropout=rate,
                          seed=1234)
                # dmask once, at the flagship shape
                need_dmask = t == 384 and packed and rate > 0
                got = _fwd_bwd(ak.relbias_attention_fwd_cuda,
                               ak.relbias_attention_bwd_cuda, *inputs,
                               need_dmask=need_dmask, **kw)
                want = _fwd_bwd(ak.relbias_attention_fwd_plain,
                                ak.relbias_attention_bwd_plain, *inputs,
                                need_dmask=need_dmask, **kw)
                want32 = _fwd_bwd(ak.relbias_attention_fwd_plain,
                                  ak.relbias_attention_bwd_plain, *inputs,
                                  dot_dtype=torch.float32,
                                  need_dmask=need_dmask, **kw)
                torch.cuda.synchronize()
                line = _hold(f"relbias training {name} packed={packed} "
                             f"dropout={rate}", got, want, want32, worst)
                if kind == "causal" and got[-1].any():
                    raise AssertionError("e2 gradient under the causal mask is not 0")
                log(f"# relbias train {name} (B=4, T={t}, S={s}, "
                    f"{'packed' if packed else '(B,H,L,d)'}, dropout {rate}): "
                    f"err/rule gap/max|value| {line}")
        _hold_dropout_mask(gen, name, t, s, kind)

    # the main path's calls: packed bf16 at B=32, dropout 0.2, at both of its
    # shapes. The bf16-input results are held against the plain versions on
    # the same inputs, and must equal, bit for bit, the kernels' results on
    # their f32 twin (the same values in f32) rounded to bf16; the twin's
    # results are held against both dot rules like the B=4 cases above.
    for name, t, kind in (("code encoder", 24, "anticausal"),
                          ("decoder self-attention", 384, "causal")):
        inputs = _train_inputs(gen, TRAIN_BATCH, t, t, kind, True, torch.bfloat16)
        q, k, v, mask, e1, e2, g = inputs
        twin = (q.float(), k.float(), v.float(), mask, e1, e2, g.float())
        kw = dict(num_heads=HEADS, dropout=TRAIN_DROPOUT, seed=3)
        cuda = (ak.relbias_attention_fwd_cuda, ak.relbias_attention_bwd_cuda)
        plain = (ak.relbias_attention_fwd_plain, ak.relbias_attention_bwd_plain)
        got, got32 = _fwd_bwd(*cuda, *inputs, **kw), _fwd_bwd(*cuda, *twin, **kw)
        torch.cuda.synchronize()
        line = _hold(f"relbias training {name} B={TRAIN_BATCH} bf16 inputs", got,
                     _fwd_bwd(*plain, *inputs, **kw), None, worst)
        line32 = _hold(f"relbias training {name} B={TRAIN_BATCH} f32 twin", got32,
                       _fwd_bwd(*plain, *twin, **kw),
                       _fwd_bwd(*plain, *twin, dot_dtype=torch.float32, **kw), worst)
        for res, a, a32 in zip(TRAIN_RESULTS, got, got32):
            if a is not None and not torch.equal(a, a32.to(a.dtype)):
                raise AssertionError(f"relbias training {name}: {res} from bf16 "
                                     "inputs is not the f32 twin's rounded to bf16")
        del got, got32
        line_s = _hold_scratch(f"relbias training {name} B={TRAIN_BATCH}", cuda[1],
                               ak.relbias_attention_bwd_weights_plain, inputs, kw)
        line_w = _hold_weights(f"relbias training {name} B={TRAIN_BATCH}", cuda[0],
                               ak.relbias_attention_bwd_weights_plain, inputs, kw)
        log(f"# relbias train {name} (B={TRAIN_BATCH}, T=S={t}, packed, dropout "
            f"{TRAIN_DROPOUT}): bf16 inputs err/max|value| {line}; f32 twin "
            f"err/rule gap/max|value| {line32}; bf16 results = the twin's "
            f"rounded to bf16, bit for bit; {line_s}; {line_w}")
        del twin
        torch.cuda.empty_cache()

    # timing at the flagship training shape, as the training path calls it
    # (the decoder's inputs, the last of the loop above)
    b, t = TRAIN_BATCH, 384
    fwd_ms = time_cuda(lambda: ak.relbias_attention_fwd_cuda(q, k, v, mask, e1, e2, **kw), 20)
    bwd_ms = time_cuda(lambda: ak.relbias_attention_bwd_cuda(
        q, k, v, mask, e1, e2, g, need_dmask=False, **kw), 10)
    fwd_plain = time_cuda(lambda: ak.relbias_attention_fwd_plain(
        q, k, v, mask, e1, e2, **kw), 5, warmup=1)
    bwd_plain = time_cuda(lambda: ak.relbias_attention_bwd_plain(
        q, k, v, mask, e1, e2, g, need_dmask=False, **kw), 3, warmup=1)
    q4, k4, v4, g4 = (x.unflatten(-1, (HEADS, HEAD_DIM)).transpose(1, 2).contiguous()
                      for x in (q, k, v, g))
    # the same kernels on the (B, H, L, d) layout (the TPU's K3 pair)
    kw4 = dict(kw, num_heads=None)
    fwd_bhld = time_cuda(lambda: ak.relbias_attention_fwd_cuda(
        q4, k4, v4, mask, e1, e2, **kw4), 20)
    bwd_bhld = time_cuda(lambda: ak.relbias_attention_bwd_cuda(
        q4, k4, v4, mask, e1, e2, g4, need_dmask=False, **kw4), 10)
    bias = (mask + subsampled_relative_bias(q4.float(), e1, e2)).to(torch.bfloat16)
    leaves = [x.detach().requires_grad_(True) for x in (q4, k4, v4, bias)]
    sdpa = lambda: F.scaled_dot_product_attention(       # noqa: E731
        *leaves[:3], attn_mask=leaves[3], dropout_p=TRAIN_DROPOUT, scale=1.0)
    lib_fwd = time_cuda(sdpa, 10, warmup=2)
    lib_fwd_bwd = time_cuda(lambda: sdpa().backward(g4), 10, warmup=2)
    # the backward alone over one retained graph: its device time (the
    # profiler's sum of its kernels) is the yardstick; the event time and
    # the difference above, host-bound at these sizes, are logged beside it
    out = sdpa()
    sdpa_bwd = lambda: torch.autograd.grad(out, leaves, g4,   # noqa: E731
                                           retain_graph=True)
    lib_bwd_events = time_cuda(sdpa_bwd, 10, warmup=2)
    lib_bwd = device_ms(sdpa_bwd, 10)
    del out, leaves, bias, q4, k4, v4, g4
    n, e = b * HEADS, HEADS * HEAD_DIM
    act = 2 * b * t * e                              # one bf16 (B, T, H*d) tensor
    side = 4 * t * t + 4 * HEADS * (2 * t - 1) * HEAD_DIM   # mask, E (f32)
    prod = 2 * t * t * HEAD_DIM * n                  # one T x S x d product
    # fwd: q.k, q.E, w.v; bwd: q.k, q.E, do.v, ds.k, dc.E (dq), ds.q (dk),
    # w.do (dv), dc.q (dE)
    fwd_bound = bound(4 * act + side, 3 * prod, BF16_FLOPS)
    bwd_bound = bound(7 * act + 2 * side, 8 * prod, BF16_FLOPS)
    log(f"# relbias train at B={b}, T=S={t}, packed bf16, dropout "
        f"{TRAIN_DROPOUT}: fwd kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, "
        f"sdpa(mask+bias) {lib_fwd:.4f} ms, bound {fwd_bound[0]:.4f} ms "
        f"({fwd_bound[1]}); bwd kernels {bwd_ms:.4f} ms, plain {bwd_plain:.4f} ms, "
        f"sdpa autograd bwd {lib_bwd:.4f} ms device time ({lib_bwd_events:.4f} "
        f"ms by events, fwd+bwd less fwd {lib_fwd_bwd - lib_fwd:.4f} ms), bound "
        f"{bwd_bound[0]:.4f} ms ({bwd_bound[1]}); on (B, H, L, d): fwd "
        f"{fwd_bhld:.4f} ms, bwd {bwd_bhld:.4f} ms")
    torch.cuda.empty_cache()
    return {"fwd": dict(ms=fwd_ms, plain_ms=fwd_plain, library_ms=lib_fwd,
                        bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
                        max_abs_err=worst["fwd"], ms_bhld=fwd_bhld),
            "bwd": dict(ms=bwd_ms, plain_ms=bwd_plain, library_ms=lib_bwd,
                        library_event_ms=lib_bwd_events,
                        bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
                        max_abs_err=worst["bwd"], ms_bhld=bwd_bhld)}


# The student slice's attentions carry no mask at all (T = S): the teacher
# over 384 tokens, the relative auxiliary decoder's stages at 24 and 96
# tokens, the transformer downscalers' stages over a block of 16 tokens and
# of 4. Held at B=4 with dropout 0 and 0.2, then held again and timed at the
# main paths' batches (the rows of attention the kernels see): the
# student's 8 sequences and its 8 x 24 blocks, the VQ-CPC step's 16 x 15 x 6
# negative blocks and 16 x 6 left or right blocks, and the decoder CLI's
# encode of 64 x 24 blocks through a student's encoder (K3-fwd only there);
# the scale-up MIDI chain's (phase 14): its encoder's 64 x 15 x 6 negative
# blocks and 64 x 6 left or right blocks, its decoder's encode of 32 x 24.
UNMASKED_LENGTHS = (384, 96, 24, 16, 4)
STUDENT_SHAPES = (("teacher", STUDENT_BATCH, 384),
                  ("aux decoder stage 1", STUDENT_BATCH, 96),
                  ("aux decoder stage 0", STUDENT_BATCH, 24),
                  ("downscaler stage 0", STUDENT_BATCH * NUM_CODES, 16),
                  ("downscaler stage 1", STUDENT_BATCH * NUM_CODES, 4),
                  ("CPC negatives, downscaler stage 0", ENC_NEG_ROWS, 16),
                  ("CPC negatives, downscaler stage 1", ENC_NEG_ROWS, 4),
                  ("CPC blocks, downscaler stage 0", ENC_BATCH * ENC_BLOCKS, 16),
                  ("CPC blocks, downscaler stage 1", ENC_BATCH * ENC_BLOCKS, 4),
                  ("decoder encode, downscaler stage 0",
                   DECODER_CLI_BATCH * NUM_CODES, 16),
                  ("decoder encode, downscaler stage 1",
                   DECODER_CLI_BATCH * NUM_CODES, 4),
                  ("scale-up CPC negatives, downscaler stage 0", SCALEUP_NEG_ROWS, 16),
                  ("scale-up CPC negatives, downscaler stage 1", SCALEUP_NEG_ROWS, 4),
                  ("scale-up CPC blocks, downscaler stage 0",
                   SCALEUP_BATCH * ENC_BLOCKS, 16),
                  ("scale-up CPC blocks, downscaler stage 1",
                   SCALEUP_BATCH * ENC_BLOCKS, 4),
                  ("scale-up decoder encode, downscaler stage 0",
                   TRAIN_BATCH * NUM_CODES, 16),
                  ("scale-up decoder encode, downscaler stage 1",
                   TRAIN_BATCH * NUM_CODES, 4))


def _relbias_bounds(b, t, s, elem_bytes, masked):
    """(fwd, bwd) bounds of the relative-bias kernels at one shape, inputs
    of `elem_bytes` bytes: q, k, v, out (fwd) and q, k, v, do, dq, dk, dv
    (bwd) once each, the (H, 2S-1, d) f32 table, and the f32 (T, S) mask
    where the call passes one (a call without a mask needs none; the zeros
    the wrapper makes for it are its own); 3 and 8 T x S x d products (fwd:
    q.k, q.E, w.v; bwd: q.k, q.E, do.v, ds.k, dc.E, ds.q, w.do, dc.q) at
    the bf16 tensor-core rate, the dots' type."""
    n, e = b * HEADS, HEADS * HEAD_DIM
    act = elem_bytes * b * t * e
    side = 4 * t * s * masked + 4 * HEADS * (2 * s - 1) * HEAD_DIM
    prod = 2 * t * s * HEAD_DIM * n
    return (bound(4 * act + side, 3 * prod, BF16_FLOPS),
            bound(7 * act + 2 * side, 8 * prod, BF16_FLOPS))


def _hold_and_time(gen, label, b, t, worst, causal=False, train=True):
    """At one shape (B x 8 heads, T = S = t) on f32 inputs (the student and
    the prior train and evaluate in f32; bf16 dots), with no mask or the
    causal one: K3-fwd (the inference route's (B, H, L, d) call, no
    dropout) and, with `train`, K2-fwd and K2-bwd (packed, the configs'
    dropout 0.1), held by _hold against their plain versions (and the
    forwards' bf16 weights by _hold_weights, bit for bit) and timed
    beside the plain versions, their bounds (the mask's bytes counted where
    a mask is passed) and scaled_dot_product_attention with the relative
    bias (plus the mask) as its mask, SDPA's backward by its device time.
    Events time the wrappers' host time too; device time the kernels' own."""
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    import torch.nn.functional as F
    from vqcpcb_tpu_torch.ops.masks import causal_mask
    from vqcpcb_tpu_torch.ops.relative_attention import subsampled_relative_bias
    cuda = (ak.relbias_attention_fwd_cuda, ak.relbias_attention_bwd_cuda)
    plain = (ak.relbias_attention_fwd_plain, ak.relbias_attention_bwd_plain)
    mask = causal_mask(t, device="cuda") if causal else None
    q, k, v = _projected(gen, b, t, t, torch.float32)
    g = torch.randn(q.shape, generator=gen, device="cuda")
    e1, e2 = (torch.randn((HEADS, t, HEAD_DIM), generator=gen, device="cuda")
              for _ in range(2))
    q4, k4, v4, g4 = (_split_heads(x).contiguous() for x in (q, k, v, g))
    inputs4 = (q4, k4, v4, mask, e1, e2)
    got_inf = [cuda[0](*inputs4)]
    torch.cuda.synchronize()
    line_inf = _hold(f"relbias inference {label}", got_inf, [plain[0](*inputs4)],
                     [plain[0](*inputs4, dot_dtype=torch.float32)], worst,
                     names=("out",))
    del got_inf
    _hold_weights(f"relbias inference {label}", cuda[0],
                  ak.relbias_attention_bwd_weights_plain, (*inputs4, g4), {})
    reps = 20 if b * t <= 8 * 384 else 10
    bias = subsampled_relative_bias(q4, e1, e2)
    bias = (bias if mask is None else bias + mask).contiguous()
    inf = lambda: cuda[0](*inputs4)                             # noqa: E731
    inf_ms, inf_dev = time_cuda(inf, reps), device_ms(inf, reps)
    inf_plain = time_cuda(lambda: plain[0](*inputs4), 5, warmup=1)
    inf_lib = time_cuda(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=bias, scale=1.0), reps, warmup=2)
    fwd_b, bwd_b = _relbias_bounds(b, t, t, 4, masked=causal)
    # K3-fwd: K2-fwd's bytes and products, no dropout
    result = dict(batch=b, t=t, causal=causal,
                  k3_fwd=dict(ms=inf_ms, device_ms=inf_dev, plain_ms=inf_plain,
                              library_ms=inf_lib, bound_ms=fwd_b[0],
                              bound_by=fwd_b[1]))
    text = (f"K3-fwd {line_inf}; K3-fwd (B,H,L,d) {inf_ms:.4f} ms (device "
            f"{inf_dev:.4f}; plain {inf_plain:.4f}, sdpa {inf_lib:.4f}, bound "
            f"{fwd_b[0]:.5f} {fwd_b[1]})")
    if train:
        kw = dict(num_heads=HEADS, dropout=0.1, seed=3)
        inputs = (q, k, v, mask, e1, e2, g)
        got = _fwd_bwd(*cuda, *inputs, **kw)
        torch.cuda.synchronize()
        line = _hold(f"relbias training {label}", got,
                     _fwd_bwd(*plain, *inputs, **kw),
                     _fwd_bwd(*plain, *inputs, dot_dtype=torch.float32, **kw), worst)
        if causal and got[-1].any():
            raise AssertionError(f"{label}: e2 gradient under the causal mask is not 0")
        del got
        _hold_weights(f"relbias training {label}", cuda[0],
                      ak.relbias_attention_bwd_weights_plain, inputs, kw)
        fwd = lambda: cuda[0](q, k, v, mask, e1, e2, **kw)      # noqa: E731
        bwd = lambda: cuda[1](                                  # noqa: E731
            q, k, v, mask, e1, e2, g, need_dmask=False, **kw)
        fwd_ms, fwd_dev = time_cuda(fwd, reps), device_ms(fwd, reps)
        bwd_ms, bwd_dev = time_cuda(bwd, reps), device_ms(bwd, reps)
        fwd_plain = time_cuda(lambda: plain[0](q, k, v, mask, e1, e2, **kw), 5,
                              warmup=1)
        bwd_plain = time_cuda(lambda: plain[1](
            q, k, v, mask, e1, e2, g, need_dmask=False, **kw), 3, warmup=1)
        leaves = [x.detach().requires_grad_(True) for x in (q4, k4, v4, bias)]
        sdpa = lambda: F.scaled_dot_product_attention(       # noqa: E731
            *leaves[:3], attn_mask=leaves[3], dropout_p=0.1, scale=1.0)
        lib_fwd = time_cuda(sdpa, reps, warmup=2)
        out = sdpa()
        sdpa_bwd = lambda: torch.autograd.grad(              # noqa: E731
            out, leaves, g4, retain_graph=True)
        lib_bwd = device_ms(sdpa_bwd, reps)
        del out, leaves
        result.update(
            k2_fwd=dict(ms=fwd_ms, device_ms=fwd_dev, plain_ms=fwd_plain,
                        library_ms=lib_fwd, bound_ms=fwd_b[0], bound_by=fwd_b[1]),
            k2_bwd=dict(ms=bwd_ms, device_ms=bwd_dev, plain_ms=bwd_plain,
                        library_ms=lib_bwd, bound_ms=bwd_b[0], bound_by=bwd_b[1]))
        text = (f"K2 err/rule gap/max|value| {line}; {text}; K2-fwd {fwd_ms:.4f} "
                f"ms (device {fwd_dev:.4f}; plain {fwd_plain:.4f}, sdpa "
                f"{lib_fwd:.4f}, bound {fwd_b[0]:.5f} {fwd_b[1]}); K2-bwd "
                f"{bwd_ms:.4f} ms (device {bwd_dev:.4f}; plain {bwd_plain:.4f}, "
                f"sdpa bwd {lib_bwd:.4f} device time, bound {bwd_b[0]:.5f} "
                f"{bwd_b[1]})")
    log(f"# relbias {'causal' if causal else 'unmasked'} {label} (B={b}, "
        f"H={HEADS}, T=S={t}, f32 inputs, bf16 dots): {text}")
    del q, k, v, g, q4, k4, v4, g4, bias
    torch.cuda.empty_cache()
    return result


def phase_relbias_unmasked(gen: torch.Generator) -> dict:
    """Phase 5, continued: the relative-bias training kernels with no mask,
    packed, dropout 0 and 0.2, at the student's five lengths (B=4), held as
    phase 5's cases are, and the dropout mask against the hash at T=S=16;
    then K2-fwd, K2-bwd and K3-fwd held and timed at each of
    STUDENT_SHAPES (_hold_and_time)."""
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    worst = {"fwd": 0.0, "bwd": 0.0}
    cuda = (ak.relbias_attention_fwd_cuda, ak.relbias_attention_bwd_cuda)
    plain = (ak.relbias_attention_fwd_plain, ak.relbias_attention_bwd_plain)
    for t in UNMASKED_LENGTHS:
        for rate in (0.0, TRAIN_DROPOUT):
            inputs = _train_inputs(gen, 4, t, t, "unmasked", True)
            kw = dict(num_heads=HEADS, dropout=rate, seed=1234)
            got = _fwd_bwd(*cuda, *inputs, **kw)
            want = _fwd_bwd(*plain, *inputs, **kw)
            want32 = _fwd_bwd(*plain, *inputs, dot_dtype=torch.float32, **kw)
            torch.cuda.synchronize()
            line = _hold(f"relbias training unmasked T=S={t} dropout={rate}", got,
                         want, want32, worst)
            if not (got[-2].any() and got[-1].any()):
                raise AssertionError("unmasked: a half of the table got no gradient")
            log(f"# relbias train unmasked (B=4, T=S={t}, packed, dropout {rate}): "
                f"err/rule gap/max|value| {line}")
    _hold_dropout_mask(gen, "unmasked T=S=16", 16, 16, "unmasked")
    times = {label: _hold_and_time(gen, label, b, t, worst)
             for label, b, t in STUDENT_SHAPES}
    return dict(max_abs_err=worst, shapes=times)


# The prior (configs/prior_config.py) runs its 6 relative layers causally
# over T = S = 24 codes: K2 at its training batch of 64, K3-fwd there in
# eval epochs, at the sampling batch of phase 12 (512) and at the prior
# CLI's generation batch (num_generated_codes, 1). At 24 rows the launcher
# rounds up to two row groups and the one key block is partly masked in
# every row group.
PRIOR_BATCH = 64
PRIOR_SAMPLE_BATCH = 512
PRIOR_CODES = 24
PRIOR_SHAPES = (("prior training and eval", PRIOR_BATCH, True),
                ("prior sampling", PRIOR_SAMPLE_BATCH, False),
                ("prior CLI generation", 1, False))


def phase_relbias_prior(gen: torch.Generator) -> dict:
    """Phase 5, continued: the prior's causal T = S = 24. K2-fwd and K2-bwd
    at B = 64, packed, dropout 0 and 0.1, held as phase 5's cases are (the
    e2 gradient 0 under the causal mask), the dropout mask against the hash
    at T = S = 24 causal; then each of PRIOR_SHAPES held and timed
    (_hold_and_time)."""
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    worst = {"fwd": 0.0, "bwd": 0.0}
    cuda = (ak.relbias_attention_fwd_cuda, ak.relbias_attention_bwd_cuda)
    plain = (ak.relbias_attention_fwd_plain, ak.relbias_attention_bwd_plain)
    for rate in (0.0, 0.1):
        inputs = _train_inputs(gen, PRIOR_BATCH, PRIOR_CODES, PRIOR_CODES,
                               "causal", True)
        kw = dict(num_heads=HEADS, dropout=rate, seed=1234)
        got = _fwd_bwd(*cuda, *inputs, **kw)
        torch.cuda.synchronize()
        line = _hold(f"relbias training prior dropout={rate}", got,
                     _fwd_bwd(*plain, *inputs, **kw),
                     _fwd_bwd(*plain, *inputs, dot_dtype=torch.float32, **kw), worst)
        if got[-1].any():
            raise AssertionError("prior: e2 gradient under the causal mask is not 0")
        log(f"# relbias train prior (B={PRIOR_BATCH}, T=S={PRIOR_CODES}, causal, "
            f"packed, dropout {rate}): err/rule gap/max|value| {line}")
    _hold_dropout_mask(gen, f"causal T=S={PRIOR_CODES}", PRIOR_CODES, PRIOR_CODES,
                       "causal")
    times = {label: _hold_and_time(gen, label, b, PRIOR_CODES, worst, causal=True,
                                   train=train)
             for label, b, train in PRIOR_SHAPES}
    return dict(max_abs_err=worst, shapes=times)


# ---- phase 6 ---------------------------------------------------------------

# K4 against its plain version: f32 dots and an f32 softmax on both sides
# (TF32 off), the sums in other orders: 1e-5, as tests/test_torch_cuda.py.
K4_ATOL = 1e-5
FUSED_RESULTS = ("out", "dq", "dk", "dv", "dmask", "dbias")
# dbias and dmask are K6's f32 score gradient ds, taken before every bf16
# rounding point, so kernel and plain version differ only by f32 sums in
# other orders (and, for dmask, the atomics' order over the B*H planes):
# 1e-5 of the max |value|, the bound of the f32-dot CPU tests. A ds stored
# in bf16 (2**-9 relative) fails it.
DS_FRACS = {"dmask": 1e-5, "dbias": 1e-5}
# The absolute decoder's attentions per (b, h): T, S and the mask. The
# cross-attention has none: the wrapper passes a zero (T, S) mask, as the
# JAX module does (attention.py:281).
ABSOLUTE_SHAPES = (("decoder self-attention", 384, 384, "causal"),
                   ("cross-attention", 384, 24, None),
                   ("code encoder", 24, 24, "anticausal"))


def _fused_mask(kind, t, s):
    from vqcpcb_tpu_torch.ops.masks import anticausal_mask, causal_mask
    if kind == "causal":
        return causal_mask(t, device="cuda")
    return anticausal_mask(s, device="cuda") if kind == "anticausal" else None


def _split_heads(x):
    return x.unflatten(-1, (HEADS, HEAD_DIM)).transpose(1, 2)


def _projected(gen, b, t, s, dtype):
    """q (B, T, E), already scaled, and k, v as the slices of a (B, S, 2E)
    projection: the tensors the attention module hands the kernels."""
    e = HEADS * HEAD_DIM
    q = torch.randn((b, t, e), generator=gen, device="cuda") * HEAD_DIM ** -0.5
    kv = torch.randn((b, s, 2 * e), generator=gen, device="cuda").to(dtype)
    return q.to(dtype), kv[..., :e], kv[..., e:]


def _fused_fwd_bwd(fwd, bwd, q, k, v, mask, bias, g, dot_dtype=torch.bfloat16,
                   need_dmask=False, **kw):
    return [fwd(q, k, v, mask, bias, dot_dtype, **kw),
            *bwd(q, k, v, mask, bias, g, dot_dtype, need_dmask=need_dmask, **kw)]


def k4_bound(b, t, s, mask, real_bias):
    """(bound_ms, bound_by) of K4 on these inputs: q, k, v and out read or
    written once in f32 with the f32 mask (and a real (B*H, T, S) bias);
    4 d flops for each live (not -inf) mask entry of each plane, at the
    rate of products that keep f32 accuracy."""
    n = b * HEADS
    live = t * s if mask is None else int((mask > -1e29).sum().item())
    bytes_moved = 4 * (2 * n * HEAD_DIM * (t + s) + t * s + (n * t * s if real_bias else 0))
    return bound(bytes_moved, 4 * HEAD_DIM * n * live, F32_ACCURATE_FLOPS)


def _fused_bounds(b, t, s, real_bias):
    """(fwd, bwd) bounds of K6 at one shape, packed bf16 inputs: bytes of
    q, k, v, out (fwd) and q, k, v, do, dq, dk, dv (bwd), the f32 mask and,
    with a real bias, its f32 values in and (bwd) dbias out; 2 and 5
    T x S x d products."""
    n = b * HEADS
    side = 4 * t * s + (4 * n * t * s if real_bias else 0)
    prod = 2 * t * s * HEAD_DIM * n
    fwd = bound(2 * n * HEAD_DIM * (2 * t + 2 * s) + side, 2 * prod, BF16_FLOPS)
    bwd = bound(2 * n * HEAD_DIM * (3 * t + 4 * s) + side
                + (4 * n * t * s if real_bias else 0), 5 * prod, BF16_FLOPS)
    return fwd, bwd


def phase_fused(gen: torch.Generator) -> dict:
    """K4 at the serving batch and K6 at the training batch, each against
    its plain version, timed beside its bound and a PyTorch yardstick."""
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    from vqcpcb_tpu_torch.ops import fused_attention_kernels as fk
    import torch.nn.functional as F
    worst = {"k4": 0.0, "fwd": 0.0, "bwd": 0.0, "bwd_bias": 0.0}
    k4_times = {}
    # the absolute decoder's three shapes at the serving batch, and the
    # explicit-bias route's prefill (batch 8) with its real (B*H, T, S) bias
    for name, b, t, s, kind, real in (
            *((name, BATCH, t, s, kind, False) for name, t, s, kind in ABSOLUTE_SHAPES),
            ("explicit relative bias", 8, 384, 384, "causal", True)):
        q, k, v = (_split_heads(x) for x in _projected(gen, b, t, s, torch.float32))
        mask = _fused_mask(kind, t, s)
        bias = (torch.randn((b * HEADS, t, s), generator=gen, device="cuda")
                if real else None)
        err = (fk.fused_attention_cuda(q, k, v, mask, bias)
               - fk.fused_attention_plain(q, k, v, mask, bias)).abs().max().item()
        worst["k4"] = max(worst["k4"], err)
        long = t == s == 384 and not real
        ms = time_cuda(lambda: fk.fused_attention_cuda(q, k, v, mask, bias),
                       5 if long else 20)
        plain_ms = time_cuda(lambda: fk.fused_attention_plain(q, k, v, mask, bias),
                             3 if long else 10, warmup=1)
        attn = mask if bias is None else mask + bias.view(b, HEADS, t, s)
        library_ms = time_cuda(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn, scale=1.0), 3 if long else 10, warmup=1)
        bound_ms, bound_by = k4_bound(b, t, s, mask, real)
        k4_times[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
        log(f"# fused_attention (K4) {name} (B={b}, H={HEADS}, T={t}, S={s}, "
            f"d={HEAD_DIM}, f32, strided views{', real bias' if real else ''}): max "
            f"abs err {err:.3e} (tolerance {K4_ATOL}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by})")
        if not err <= K4_ATOL:
            raise AssertionError(f"fused_attention {name}: max abs err {err}")
        del q, k, v, bias, attn
        torch.cuda.empty_cache()

    # K6 at the training batch, packed bf16 as the training route gives it:
    # the absolute decoder's three shapes at dropout 0 and 0.2 with the
    # placeholder (K6-bwd-nobias; dmask once), and the explicit-bias route's
    # two shapes with a real bias (K6-bwd: dbias). Each result against the
    # plain version on the same inputs (dbias and dmask to DS_FRACS); the f32
    # twin's against both dot rules (8x contrast); the bf16 results equal to
    # the twin's rounded to bf16, bit for bit.
    cuda = (fk.fused_attention_train_fwd_cuda, fk.fused_attention_train_bwd_cuda)
    plain = (fk.fused_attention_train_fwd_plain, fk.fused_attention_train_bwd_plain)
    cases = [("decoder self-attention", 384, 384, "causal", 0.0, False),
             ("decoder self-attention", 384, 384, "causal", TRAIN_DROPOUT, False),
             ("cross-attention", 384, 24, None, 0.0, False),
             ("cross-attention", 384, 24, None, TRAIN_DROPOUT, False),
             ("code encoder", 24, 24, "anticausal", 0.0, False),
             ("code encoder", 24, 24, "anticausal", TRAIN_DROPOUT, False),
             ("explicit relative bias", 384, 384, "causal", TRAIN_DROPOUT, True),
             ("explicit relative bias, code encoder", 24, 24, "anticausal",
              TRAIN_DROPOUT, True)]
    for i, (name, t, s, kind, rate, real) in enumerate(cases):
        q, k, v = _projected(gen, TRAIN_BATCH, t, s, torch.bfloat16)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        mask = _fused_mask(kind, t, s)
        bias = (torch.randn((TRAIN_BATCH * HEADS, t, s), generator=gen, device="cuda")
                if real else None)
        need_dmask = i == 1
        kw = dict(num_heads=HEADS, dropout=rate, seed=3, need_dmask=need_dmask)
        inputs = (q, k, v, mask, bias, g)
        twin = (q.float(), k.float(), v.float(), mask, bias, g.float())
        got, got32 = _fused_fwd_bwd(*cuda, *inputs, **kw), _fused_fwd_bwd(*cuda, *twin, **kw)
        torch.cuda.synchronize()
        bwd_key = "bwd_bias" if real else "bwd"
        line = _hold(f"K6 {name} B={TRAIN_BATCH} dropout {rate} bf16 inputs", got,
                     _fused_fwd_bwd(*plain, *inputs, **kw), None, worst,
                     FUSED_RESULTS, bwd_key, DS_FRACS)
        # dmask and dbias are the f32 ds, which comes before every rounding
        # point of the dot rule: on the twin's bf16-exact inputs both rules
        # give the same values, so no contrast applies and DS_FRACS holds them
        rule32 = _fused_fwd_bwd(*plain, *twin, dot_dtype=torch.float32, **kw)
        rule32[4:] = [None, None]
        line32 = _hold(f"K6 {name} B={TRAIN_BATCH} dropout {rate} f32 twin", got32,
                       _fused_fwd_bwd(*plain, *twin, **kw), rule32, worst,
                       FUSED_RESULTS, bwd_key, DS_FRACS)
        for res, a, a32 in zip(FUSED_RESULTS, got, got32):
            # dmask sums by atomics, in an order that changes between runs
            if a is not None and res != "dmask" and not torch.equal(a, a32.to(a.dtype)):
                raise AssertionError(f"K6 {name}: {res} from bf16 inputs is not "
                                     "the f32 twin's rounded to bf16")
        if (got[-1] is not None) != real or (got[4] is not None) != need_dmask:
            raise AssertionError(f"K6 {name}: dbias / dmask returned where not asked")
        del got, got32, twin
        line_s = _hold_scratch(f"K6 {name} B={TRAIN_BATCH} dropout {rate}", cuda[1],
                               fk.fused_attention_train_bwd_weights_plain, inputs, kw)
        if t == 384:
            line_s += "; " + _hold_weights(
                f"K6 {name} B={TRAIN_BATCH} dropout {rate}", cuda[0],
                fk.fused_attention_train_bwd_weights_plain, inputs, kw)
        log(f"# K6 {name} (B={TRAIN_BATCH}, T={t}, S={s}, packed bf16, dropout "
            f"{rate}, {'real bias' if real else 'placeholder'}"
            f"{', dmask' if need_dmask else ''}): bf16 inputs err/max|value| "
            f"{line}; f32 twin err/rule gap/max|value| {line32}; bf16 results = "
            f"the twin's rounded to bf16, bit for bit (dmask aside); {line_s}")
    # timed as the training route calls them, dropout 0.2: the decoder's
    # self-attention and the cross-attention with the placeholder, and the
    # self-attention with a real bias (the explicit-bias route)
    kw = dict(num_heads=HEADS, dropout=TRAIN_DROPOUT, seed=3)
    times = {}
    for label, t, s, kind, real in (("self", 384, 384, "causal", False),
                                    ("cross", 384, 24, None, False),
                                    ("bias", 384, 384, "causal", True)):
        q, k, v = _projected(gen, TRAIN_BATCH, t, s, torch.bfloat16)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        mask = _fused_mask(kind, t, s)
        bias = (torch.randn((TRAIN_BATCH * HEADS, t, s), generator=gen, device="cuda")
                if real else None)
        fwd_ms = time_cuda(lambda: fk.fused_attention_train_fwd_cuda(
            q, k, v, mask, bias, **kw), 20)
        bwd_ms = time_cuda(lambda: fk.fused_attention_train_bwd_cuda(
            q, k, v, mask, bias, g, need_dmask=False, **kw), 10)
        fwd_plain = time_cuda(lambda: fk.fused_attention_train_fwd_plain(
            q, k, v, mask, bias, **kw), 5, warmup=1)
        bwd_plain = time_cuda(lambda: fk.fused_attention_train_bwd_plain(
            q, k, v, mask, bias, g, need_dmask=False, **kw), 3, warmup=1)
        q4, k4, v4, g4 = (_split_heads(x).contiguous() for x in (q, k, v, g))
        leaves = [x.detach().requires_grad_(True) for x in (q4, k4, v4)]
        attn = None
        if real:     # mask + bias as one additive bf16 tensor, with its gradient
            attn = (mask + bias.view(TRAIN_BATCH, HEADS, t, s)).to(
                torch.bfloat16).requires_grad_(True)
        sdpa = lambda: F.scaled_dot_product_attention(       # noqa: E731
            *leaves, attn_mask=attn, is_causal=kind == "causal" and not real,
            dropout_p=TRAIN_DROPOUT, scale=1.0)
        lib_fwd = time_cuda(sdpa, 10, warmup=2)
        # its autograd backward alone, over one retained graph, by device
        # time (host-bound at these sizes: its event time varied from 0.17
        # to 0.78 ms between calls on an H100); the event time beside it
        out = sdpa()
        sdpa_bwd = lambda: torch.autograd.grad(               # noqa: E731
            out, leaves + ([attn] if real else []), g4, retain_graph=True)
        lib_bwd_events = time_cuda(sdpa_bwd, 10, warmup=2)
        lib_bwd = device_ms(sdpa_bwd, 10)
        del out
        fwd_bound, bwd_bound = _fused_bounds(TRAIN_BATCH, t, s, real)
        times[label] = dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms, fwd_plain=fwd_plain,
                            bwd_plain=bwd_plain, lib_fwd=lib_fwd, lib_bwd=lib_bwd,
                            lib_bwd_events=lib_bwd_events,
                            fwd_bound=fwd_bound, bwd_bound=bwd_bound)
        log(f"# K6 {label} at B={TRAIN_BATCH}, T={t}, S={s}, packed bf16, dropout "
            f"{TRAIN_DROPOUT}, {'real bias' if real else 'placeholder'}: fwd kernel "
            f"{fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, sdpa {lib_fwd:.4f} ms, "
            f"bound {fwd_bound[0]:.4f} ms ({fwd_bound[1]}); bwd kernels {bwd_ms:.4f} "
            f"ms, plain {bwd_plain:.4f} ms, sdpa autograd bwd {lib_bwd:.4f} ms device "
            f"time ({lib_bwd_events:.4f} ms by events), bound {bwd_bound[0]:.4f} ms "
            f"({bwd_bound[1]})")
        del leaves, attn, q4, k4, v4, g4, q, k, v, g, bias
        torch.cuda.empty_cache()

    # the dropout mask, bit for bit: with v the one-hot columns of a block of
    # 64 keys, K6's output is its dropped weight row there (stream
    # seed + b*H + h)
    for name, t, s, kind in ABSOLUTE_SHAPES[:2]:
        q, k, _ = (_split_heads(x).contiguous()
                   for x in _projected(gen, 4, t, s, torch.float32))
        mask = _fused_mask(kind, t, s)
        keep = ak.dropout_keep_plain((t, s), TRAIN_DROPOUT,
                                     fk.flat_stream_seeds(99, 4, HEADS, "cuda"))
        # the weights that are not 0 before dropout, by the kernel's rule
        rd = lambda x: x.to(torch.bfloat16).float()       # noqa: E731
        w = torch.softmax(torch.einsum("bhtd,bhsd->bhts", rd(q), rd(k))
                          + (0 if mask is None else mask.clamp_min(-1e30)), -1) > 0
        mismatched = 0
        for c0 in range(0, s, HEAD_DIM):
            n = min(HEAD_DIM, s - c0)
            v = torch.zeros((4, HEADS, s, HEAD_DIM), device="cuda")
            v[:, :, c0:c0 + n, :n] = torch.eye(n, device="cuda")
            out = fk.fused_attention_train_fwd_cuda(q, k, v, mask, None,
                                                    dropout=TRAIN_DROPOUT, seed=99)
            mismatched += (((out[..., :n] != 0) & w[..., c0:c0 + n])
                           != (keep[..., c0:c0 + n] & w[..., c0:c0 + n])).sum().item()
        log(f"# K6 {name}: dropout mask vs the hash on stream seed + b*H + h, "
            f"{mismatched} of {4 * HEADS * t * s} entries differ (need 0)")
        if mismatched:
            raise AssertionError(f"K6 dropout mask differs at {mismatched} entries")
    torch.cuda.empty_cache()
    self_t, bias_t = times["self"], times["bias"]
    return {
        "k4": dict(k4_times["decoder self-attention"], max_abs_err=worst["k4"],
                   cross=k4_times["cross-attention"],
                   code_encoder=k4_times["code encoder"],
                   real_bias=k4_times["explicit relative bias"]),
        "fwd": dict(ms=self_t["fwd_ms"], plain_ms=self_t["fwd_plain"],
                    library_ms=self_t["lib_fwd"], bound_ms=self_t["fwd_bound"][0],
                    bound_by=self_t["fwd_bound"][1], max_abs_err=worst["fwd"],
                    cross={k: times["cross"][k] for k in ("fwd_ms", "fwd_plain", "lib_fwd")}),
        "bwd_nobias": dict(ms=self_t["bwd_ms"], plain_ms=self_t["bwd_plain"],
                           library_ms=self_t["lib_bwd"],
                           library_event_ms=self_t["lib_bwd_events"],
                           bound_ms=self_t["bwd_bound"][0],
                           bound_by=self_t["bwd_bound"][1], max_abs_err=worst["bwd"],
                           cross={k: times["cross"][k] for k in
                                  ("bwd_ms", "bwd_plain", "lib_bwd", "lib_bwd_events")}),
        "bwd": dict(ms=bias_t["bwd_ms"], plain_ms=bias_t["bwd_plain"],
                    library_ms=bias_t["lib_bwd"],
                    library_event_ms=bias_t["lib_bwd_events"],
                    bound_ms=bias_t["bwd_bound"][0],
                    bound_by=bias_t["bwd_bound"][1], max_abs_err=worst["bwd_bias"]),
    }


# ---- phase 7 ---------------------------------------------------------------

def synthetic_vocabulary():
    """4 voices of 56 pitches 'p<midi>' plus the 6 special symbols: 62
    tokens per voice, the vocabulary size of the flagship decoder."""
    from vqcpcb_tpu_torch.data.vocab import Vocabulary, midi_of_plain_name
    return Vocabulary.from_note_sets(
        [{f"p{m}" for m in range(36 + 6 * v, 36 + 6 * v + 56)} for v in range(4)],
        midi_of_plain_name)


# Decoder configurations at full width: the flagship AC/D/C of
# configs/decoder_relative_AC_D_C_random.py and the absolute decoder of
# configs/decoder_random.py (decoder_type 'transformer', getters.py:283).
DECODERS = {"flagship": dict(transformer_type="relative",
                             cross_attention_type="diagonal"),
            "absolute": dict(transformer_type="absolute",
                             cross_attention_type="full")}
# The kernel one prefill launches, and how often: 3 encoder + 3 decoder
# self-attentions (relative bias), or those and 3 cross-attentions (K4).
PREFILL_LAUNCHES = {"flagship": ("relbias_attention_fwd", 6),
                    "absolute": ("fused_attention", 9)}
# Launches of one train step: the attentions' forward and backward, and K1
# for the frozen encoder's codes. "explicit_bias" is the flagship with
# VQCPCB_PALLAS_RELBIAS=0.
STEP_LAUNCHES = {
    "flagship": {"relbias_attention_fwd": 6, "relbias_attention_bwd": 6,
                 "vq_nearest": 1},
    "absolute": {"fused_attention_train_fwd": 9,
                 "fused_attention_train_bwd_nobias": 9, "vq_nearest": 1},
    "explicit_bias": {"fused_attention_train_fwd": 6,
                      "fused_attention_train_bwd": 6, "vq_nearest": 1}}


def build_models(vocab, dropout: float = 0.0, kind: str = "flagship"):
    """Full width, random weights from torch's init under a fixed seed:
    the encoder of configs/encoder_random_config.py and a decoder of
    DECODERS, d_model 512, 8 heads, 3 + 3 layers, ff 1024, positional 8
    (the configs' dropout 0.2 is the caller's `dropout`; serving runs in
    eval mode)."""
    from vqcpcb_tpu_torch.models.data_processor import (BachCPCDataProcessor,
                                                        BachDataProcessor)
    from vqcpcb_tpu_torch.models.decoder import Decoder
    from vqcpcb_tpu_torch.models.downscalers import GruDownscaler
    from vqcpcb_tpu_torch.models.encoder import Encoder
    from vqcpcb_tpu_torch.models.upscalers import MlpUpscaler
    from vqcpcb_tpu_torch.ops.quantizer import ProductVectorQuantizer
    torch.manual_seed(0)
    vocab_sizes = vocab.num_tokens_per_channel
    encoder = Encoder(
        BachCPCDataProcessor(32, NUM_EVENTS, vocab_sizes, num_tokens_per_block=16),
        GruDownscaler(32, 3, [16], 512, num_layers=2, dropout=0.1,
                      bidirectional=True),
        ProductVectorQuantizer(CODEBOOK_SIZE, 3, 0.25, 1),
        MlpUpscaler(3, 32, 512, 0.1))
    decoder = Decoder(
        BachDataProcessor(32, NUM_EVENTS, vocab_sizes), "anticausal",
        d_model=512, num_encoder_layers=3, num_decoder_layers=3, n_head=HEADS,
        dim_feedforward=1024, positional_embedding_size=8,
        num_channels_encoder=1, num_events_encoder=NUM_CODES,
        num_channels_decoder=4, num_events_decoder=NUM_EVENTS,
        total_upscaling=16, source_vocab_size=CODEBOOK_SIZE, dropout=dropout,
        **DECODERS[kind])
    return encoder, decoder


def init_codebook(encoder, templates, gen) -> None:
    """Data-dependent codebook init (the reference's first-batch init,
    vqcpcb_tpu/ops/quantizer.py:29): codes drawn from the downscaler's
    outputs, so the templates' codes spread over the codebook."""
    from vqcpcb_tpu_torch.ops.quantizer import initialize_codebooks
    with torch.no_grad():
        z = encoder.downscale(templates, training=False).reshape(-1, 3)
        encoder.quantizer.set_codebooks(
            initialize_codebooks(z, 1, CODEBOOK_SIZE, gen))


def random_templates(vocab, gen, batch, events):
    """Random pitch tokens (no special symbols) on the card, (B, events, 4)."""
    pitches = [sorted(i for n, i in d.items() if n.startswith("p"))
               for d in vocab.note2index_dicts]
    cols = [torch.tensor(p, device="cuda")[
        torch.randint(len(p), (batch, events), generator=gen, device="cuda")]
        for p in pitches]
    return torch.stack(cols, dim=-1).int()


def reset_counts():
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    from vqcpcb_tpu_torch.ops import fused_attention_kernels as fk
    from vqcpcb_tpu_torch.ops import vq_kernels as vk
    vk.launches = 0
    vk.launches_by_kind.update(dict.fromkeys(vk.launches_by_kind, 0))
    ak.launches = ak.bwd_launches = 0
    fk.launches = fk.train_fwd_launches = 0
    fk.train_bwd_launches = fk.train_bwd_nobias_launches = 0


class Launches(dict):
    """Launches by kernel, with K1's split by the kernel the shape picked
    (vq_kernels.launches_by_kind) beside them as `by_kind`: not a key, so
    the phases' comparisons of whole counts stay as they are."""
    by_kind: dict


def counts() -> Launches:
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    from vqcpcb_tpu_torch.ops import fused_attention_kernels as fk
    from vqcpcb_tpu_torch.ops import vq_kernels as vk
    out = Launches({"vq_nearest": vk.launches, "relbias_attention_fwd": ak.launches,
                    "relbias_attention_bwd": ak.bwd_launches,
                    "fused_attention": fk.launches,
                    "fused_attention_train_fwd": fk.train_fwd_launches,
                    "fused_attention_train_bwd": fk.train_bwd_launches,
                    "fused_attention_train_bwd_nobias": fk.train_bwd_nobias_launches})
    out.by_kind = dict(vk.launches_by_kind)
    return out


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def synced_seconds(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_serving(gen: torch.Generator, profile: bool, kind: str) -> dict:
    """The re-harmonisation serving path of one decoder of DECODERS."""
    from vqcpcb_tpu_torch.training.decoder_trainer import DecoderGenerator
    vocab = synthetic_vocabulary()
    encoder, decoder = build_models(vocab, kind=kind)
    generator = DecoderGenerator(encoder, decoder, vocab, CODEBOOK_SIZE, seed=0)
    templates = random_templates(vocab, gen, BATCH, NUM_EVENTS)
    init_codebook(encoder, templates, gen)
    key, per_prefill = PREFILL_LAUNCHES[kind]
    # warm-up of every route outside the counted run (cuDNN, cuBLAS plans)
    warm_codes = generator.encode_codes(templates[:8])
    decoder.sample_range(warm_codes, templates[:8], 0, 8, generator.generator,
                         temperature=0.95, top_p=0.8)
    torch.cuda.synchronize()

    reset_counts()
    # (a) encoder codes for 512 templates
    codes, encode_s = synced_seconds(lambda: generator.encode_codes(templates))
    after_a = counts()
    if codes.shape != (BATCH, NUM_CODES) or codes.min() < 0 or codes.max() >= CODEBOOK_SIZE:
        raise AssertionError(f"codes {tuple(codes.shape)} in "
                             f"[{codes.min().item()}, {codes.max().item()}]")
    if after_a["vq_nearest"] < 1:
        raise AssertionError("encode_codes did not launch the vq_nearest kernel")
    log(f"# [{kind}] (a) encode_codes: {BATCH} templates -> codes "
        f"{tuple(codes.shape)}, {len(codes.unique())} distinct of "
        f"{CODEBOOK_SIZE}, {encode_s * 1e3:.3f} ms")

    # (b) KV-cached sampling of all 384 positions at batch 512, int8 caches
    tokens0 = torch.zeros((BATCH, NUM_EVENTS, 4), dtype=torch.int32, device="cuda")
    n_tok = NUM_EVENTS * 4
    sampled, sample_s = synced_seconds(lambda: decoder.sample_range(
        codes, tokens0, 0, n_tok, generator.generator, temperature=0.95,
        top_p=0.8))
    prefill = _delta(counts(), after_a)
    want = {k: per_prefill if k == key else 0 for k in prefill}
    want["vq_nearest"] = 0
    if prefill != want:
        raise AssertionError(f"one prefill launched {prefill}, not {want}")
    sizes = torch.tensor(vocab.num_tokens_per_channel, device="cuda")
    if not ((sampled >= 0) & (sampled < sizes)).all():
        raise AssertionError("sampled tokens outside their channel's vocabulary")
    tokens_per_s = BATCH * n_tok / sample_s
    log(f"# [{kind}] (b) sample_range batch {BATCH} x {n_tok} positions (T 0.95, "
        f"top_p 0.8, int8 caches): {sample_s:.4f} s, {tokens_per_s:.1f} "
        f"tokens/s; one prefill launched {key} {per_prefill} times and no other "
        f"attention kernel")

    # (c) re-harmonisation of a random 40-beat template, 8 variants
    template = random_templates(vocab, gen, 1, 40 * 4).cpu().numpy()
    before_c = counts()
    outs, reharm_s = synced_seconds(lambda: generator.generate_reharmonisation(
        template, 8, temperature=0.95, top_p=0.8, exclude_meta_symbols=True))
    reharm = _delta(counts(), before_c)
    windows, rest = divmod(reharm[key], per_prefill)
    others = {k: c for k, c in reharm.items() if c and k not in (key, "vq_nearest")}
    if rest or not windows or others:
        raise AssertionError(f"re-harmonisation launched {reharm}, not "
                             f"{per_prefill} {key} per window")
    forbidden = generator._forbidden(True)
    for grid in outs:
        if grid.shape != (160, 4):
            raise AssertionError(f"re-harmonisation grid {grid.shape}")
        for c in range(4):
            if np.isin(grid[:, c], forbidden[c]).any():
                raise AssertionError("a meta symbol was sampled while excluded")
    log(f"# [{kind}] (c) generate_reharmonisation 40 beats x 8 variants: "
        f"{reharm_s:.4f} s, {windows} windows, {len(outs) * 160 * 4} tokens")
    # the main path is (a)-(c); what follows launches the kernels outside it
    main_counts = counts()

    with torch.no_grad():
        _, prefill_s = synced_seconds(lambda: decoder.prefill(codes, tokens0,
                                                              torch.int8))
    log(f"# [{kind}] prefill alone at batch {BATCH} (int8 caches): "
        f"{prefill_s * 1e3:.3f} ms")
    if profile:
        phase_profile(decoder, codes, generator.generator, kind)

    # (d) kernel route vs plain route, greedy KV cache vs teacher forcing
    small_codes, small = codes[:8], sampled[:8]
    with torch.no_grad():
        kernel_logits = decoder(small_codes, small)["weights_per_category"]
        plain = copy.deepcopy(decoder).cpu()
        plain_logits = plain(small_codes.cpu(), small.cpu())["weights_per_category"]
    scale = max(lg.abs().max().item() for lg in plain_logits)
    err = max((k.cpu() - p).abs().max().item()
              for k, p in zip(kernel_logits, plain_logits))
    log(f"# [{kind}] (d) decoder logits at batch 8, kernel route vs plain route "
        f"(f32, CPU): max abs err {err:.4e}, max |logit| {scale:.3f} (tolerance "
        f"{LOGITS_RTOL} * max |logit|)")
    if not err <= LOGITS_RTOL * scale:
        raise AssertionError(f"kernel-route logits differ by {err}")
    os.environ["VQCPCB_KV_DTYPE"] = "float32"
    try:
        greedy = decoder.sample_range(small_codes, tokens0[:8], 0, n_tok,
                                      generator.generator, top_k=1)
    finally:
        del os.environ["VQCPCB_KV_DTYPE"]
    with torch.no_grad():
        forced = decoder(small_codes, greedy)["weights_per_category"]
    agree = torch.stack([lg.argmax(-1) for lg in forced], -1) == greedy.long()
    rate = agree.float().mean().item()
    log(f"# [{kind}] (d) greedy f32-cache tokens vs teacher-forced argmax: "
        f"{rate * 100:.3f}% of {agree.numel()} positions agree (need >= 99%)")
    if rate < 0.99:
        raise AssertionError(f"greedy agreement {rate}")
    return dict(launches=main_counts, encode_ms=encode_s * 1e3,
                prefill_ms=prefill_s * 1e3, tokens_per_s=tokens_per_s,
                reharm_s=reharm_s, windows=windows)


def _log_profile(prof, wall_s: float, label: str, top: int) -> None:
    """Device time by kernel from a finished profiler, and the share of the
    wall time the card was busy (kernels only: the aten ops above them carry
    the same device time)."""
    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"# profile: {label}: wall {wall_s * 1e3:.3f} ms (under the profiler), "
        f"device busy {busy_ms:.3f} ms ({busy_ms / (wall_s * 1e3) * 100:.1f}%)")
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:top]:
        log(f"# profile {e.self_device_time_total / 1e3:10.3f} ms "
            f"{e.count:6d} calls  {e.key[:90]}")


def phase_profile(decoder, codes, generator: torch.Generator, kind: str) -> None:
    """Device time by kernel over one sample_range of 64 positions at batch
    512 (a prefill and 64 decode steps), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    tokens0 = torch.zeros((codes.shape[0], NUM_EVENTS, 4), dtype=torch.int32,
                          device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_s = synced_seconds(lambda: decoder.sample_range(
            codes, tokens0, 0, 64, generator, temperature=0.95, top_p=0.8))
    _log_profile(prof, wall_s, f"[{kind}] sample_range batch {codes.shape[0]}, "
                 "64 positions", 12)


# ---- phase 8 ---------------------------------------------------------------

# Decoder loss and gradients, kernel route (bf16 transformer layers, bf16
# dots in the attention kernels) against the CPU f32 plain route at dropout
# 0: every product of the layers rounds its inputs to bf16 (2**-9
# relative), which moves the loss by well under 2% and leaves each
# gradient's direction within cosine 0.99 of the f32 one.
LOSS_RTOL = 2e-2
GRAD_COSINE = 0.99
EXPLICIT_STEPS = 6


def set_dropout(model, rate: float) -> None:
    from vqcpcb_tpu_torch.ops.attention import MultiheadAttention
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = rate
        elif isinstance(m, MultiheadAttention):
            m.dropout = rate


def loss_and_grads(decoder, codes, x, bf16: bool):
    """The decoder's loss and gradients in train mode, its transformer
    layers in bf16 (the decoder trainer's scope on the card) or in f32."""
    from vqcpcb_tpu_torch.utils import default_compute_dtype
    decoder.train()
    decoder.zero_grad(set_to_none=True)
    with default_compute_dtype(torch.bfloat16 if bf16 else torch.float32):
        loss = decoder(codes, x)["loss"]
    loss.backward()
    return loss.item(), {
        n: (torch.zeros(p.shape) if p.grad is None else p.grad.float().cpu())
        for n, p in decoder.named_parameters()}


def compare_routes(what, a, b) -> tuple:
    """(relative loss difference, lowest gradient cosine, its parameter) of
    two (loss, grads) results; raises past LOSS_RTOL / GRAD_COSINE."""
    (loss_a, grads_a), (loss_b, grads_b) = a, b
    loss_err = abs(loss_a - loss_b) / abs(loss_b)
    worst_name, worst_cos = None, 1.0
    for name, gb in grads_b.items():
        ga = grads_a[name]
        norm = gb.norm() * ga.norm()
        if norm == 0:
            if gb.any() or ga.any():
                raise AssertionError(f"{what}: {name}: one route's gradient is zero")
            continue
        cos = float((gb * ga).sum() / norm)
        if cos < worst_cos:
            worst_name, worst_cos = name, cos
    log(f"# {what}: loss {loss_a:.5f} vs {loss_b:.5f} (relative {loss_err:.3e}, "
        f"need <= {LOSS_RTOL}); lowest gradient cosine {worst_cos:.5f} "
        f"({worst_name}) over {len(grads_b)} parameters (need >= {GRAD_COSINE})")
    if not (loss_err <= LOSS_RTOL and worst_cos >= GRAD_COSINE):
        raise AssertionError(f"{what}: the two routes disagree")
    return loss_err, worst_cos, worst_name


def train_steps(trainer, batches, steps: int, kind: str, must_fall: bool) -> dict:
    """`steps` train steps, counted from zero launches; checks the launches
    per step, finite losses and (must_fall) a falling loss."""
    reset_counts()
    losses, step_s = [], []
    for i in range(steps):
        out, sec = synced_seconds(lambda: trainer.train_step(batches[i % len(batches)]))
        losses.append(out["loss"])
        step_s.append(sec)
    main_counts = counts()
    losses = torch.stack(losses).float().cpu().tolist()
    want = {k: STEP_LAUNCHES[kind].get(k, 0) * steps for k in main_counts}
    log(f"# [{kind}] train steps: launches {json.dumps(main_counts)} over "
        f"{steps} steps (need {json.dumps(want)})")
    if main_counts != want:
        raise AssertionError(f"train-step launches {main_counts}, not {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    if must_fall and not last < first:
        raise AssertionError(f"the loss did not fall: {losses}")
    step_ms = float(np.median(step_s)) * 1e3
    tokens_per_s = TRAIN_BATCH * NUM_EVENTS * 4 / (step_ms / 1e3)
    log(f"# [{kind}] decoder training batch {TRAIN_BATCH} x {NUM_EVENTS * 4} "
        f"tokens, bf16 transformer layers, dropout {TRAIN_DROPOUT}, Adam lr 1e-4 clip 5: "
        f"median {step_ms:.3f} ms/step (min {min(step_s) * 1e3:.3f}, max "
        f"{max(step_s) * 1e3:.3f}), {tokens_per_s:.1f} tokens/s; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (mean of first 4 {first:.4f}, "
        f"last 4 {last:.4f})")
    return dict(launches=main_counts, step_ms=step_ms, tokens_per_s=tokens_per_s,
                losses=losses)


def _trainer(gen, kind: str):
    from vqcpcb_tpu_torch.training.decoder_trainer import DecoderTrainer
    vocab = synthetic_vocabulary()
    encoder, decoder = build_models(vocab, dropout=TRAIN_DROPOUT, kind=kind)
    batches = [random_templates(vocab, gen, TRAIN_BATCH, NUM_EVENTS)
               for _ in range(4)]
    trainer = DecoderTrainer(encoder, decoder, CODEBOOK_SIZE, seed=0)
    trainer.init_state(lr=1e-4)               # the configs' lr
    init_codebook(trainer.encoder, torch.cat(batches), gen)
    for x in batches[:2]:                     # warm-up: cuBLAS plans, caches
        trainer.train_step(x)
    torch.cuda.synchronize()
    return trainer, batches


def phase_decoder_training(gen: torch.Generator, profile: bool, kind: str) -> dict:
    trainer, batches = _trainer(gen, kind)
    result = train_steps(trainer, batches, TRAIN_STEPS, kind, must_fall=True)
    evaluated = trainer.epoch([{"x": x} for x in batches], train=False)
    log(f"# [{kind}] eval epoch over the 4 batches: loss {evaluated['loss']:.4f}, "
        f"{evaluated['tokens_per_sec']:.1f} tokens/s")
    if not np.isfinite(evaluated["loss"]):
        raise AssertionError(f"eval loss {evaluated}")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall_s = synced_seconds(lambda: [trainer.train_step(batches[i])
                                                for i in range(3)])
        _log_profile(prof, wall_s, f"[{kind}] 3 decoder train steps at batch "
                     f"{TRAIN_BATCH}", 20)

    # (b) kernel route vs the CPU f32 plain route, batch 2, dropout 0
    dec = trainer.decoder
    set_dropout(dec, 0.0)
    small = batches[0][:2]
    codes = trainer.encode_codes(small)
    kernel = loss_and_grads(dec, codes, small, bf16=True)
    plain = loss_and_grads(copy.deepcopy(dec).cpu(), codes.cpu(), small.cpu(),
                           bf16=False)
    loss_err, worst_cos, _ = compare_routes(
        f"[{kind}] (b) batch 2, dropout 0, kernel route vs CPU f32 plain route",
        kernel, plain)
    return dict(result, loss_err=loss_err, worst_cos=worst_cos)


def phase_explicit_bias(gen: torch.Generator) -> dict:
    """The flagship with VQCPCB_PALLAS_RELBIAS=0: each relative layer builds
    its (B*H, T, S) bias in PyTorch and runs K6 in training (K6-bwd returns
    the bias's gradient) and K4 at inference."""
    os.environ["VQCPCB_PALLAS_RELBIAS"] = "0"
    try:
        trainer, batches = _trainer(gen, "flagship")
        result = train_steps(trainer, batches, EXPLICIT_STEPS, "explicit_bias",
                             must_fall=False)
        dec = trainer.decoder
        codes = trainer.encode_codes(batches[0][:8])
        reset_counts()
        with torch.no_grad():
            dec.eval().prefill(codes, batches[0][:8], torch.int8)
        torch.cuda.synchronize()
        prefill = counts()
        want = {k: 6 if k == "fused_attention" else 0 for k in prefill}
        log(f"# [explicit_bias] one prefill at batch 8: launches "
            f"{json.dumps(prefill)} (need {json.dumps(want)})")
        if prefill != want:
            raise AssertionError(f"explicit-bias prefill launched {prefill}")
        set_dropout(dec, 0.0)
        small, small_codes = batches[0][:2], codes[:2]
        explicit = loss_and_grads(dec, small_codes, small, bf16=True)
    finally:
        del os.environ["VQCPCB_PALLAS_RELBIAS"]
    in_kernel = loss_and_grads(dec, small_codes, small, bf16=True)
    loss_err, worst_cos, _ = compare_routes(
        "[explicit_bias] batch 2, dropout 0, explicit-bias route vs in-kernel "
        "relbias route, same weights", explicit, in_kernel)
    return dict(result, loss_err=loss_err, worst_cos=worst_cos)


# ---- phase 9 ---------------------------------------------------------------

# Loss of one eval forward of the full-width VQ-CPC model on the card
# against the same model on the CPU: f32 on both sides (TF32 off), sums in
# other orders through two GRUs of 512 and the scorers; the codes must be
# equal for this to hold, so a wrong K1 index shows here too.
ENC_LOSS_RTOL = 1e-4


def build_cpc_model(ema: bool, transformer: bool = False):
    """The VQ-CPC model of bench.py:52-88 at full width, random weights from
    torch's init under a fixed seed: embedding 32, two independent 2-layer
    GRUs of 512 over blocks of 16 tokens, codebook 32 x 3 (one codebook,
    commitment 0.25), MLP upscaler 512 -> 32, CModule GRU 512 x 2 -> 32,
    FksModule k_max 6, dropout 0.1; quantization weighting 0.5. With `ema`,
    bench.py's trained-guard twin: the EMA quantizer (decay 0.99) and
    weighting 0.25. With `transformer`, the downscaler of
    configs/encoder_random_transfo_config.py instead of the GRUs: the
    strided relative-transformer downscaler, factors [4, 4], d_model 512, 8
    heads, 4 + 4 layers, ff 2048."""
    from vqcpcb_tpu_torch.models.cpc import CModule, FksModule, VQCPCModel
    from vqcpcb_tpu_torch.models.data_processor import BachCPCDataProcessor
    from vqcpcb_tpu_torch.models.downscalers import (GruDownscaler,
                                                     RelativeTransformerDownscaler)
    from vqcpcb_tpu_torch.models.encoder import Encoder
    from vqcpcb_tpu_torch.models.upscalers import MlpUpscaler
    from vqcpcb_tpu_torch.ops.quantizer import (EMAProductVectorQuantizer,
                                                ProductVectorQuantizer)
    torch.manual_seed(1 if ema else 0)
    ticks = ENC_BLOCKS * 16 // 4
    quantizer = (EMAProductVectorQuantizer(CODEBOOK_SIZE, 3, 0.25, 1, ema_decay=0.99)
                 if ema else ProductVectorQuantizer(CODEBOOK_SIZE, 3, 0.25, 1))
    downscaler = (RelativeTransformerDownscaler(32, 3, [4, 4], 4, 512, HEADS, [4, 4],
                                                2048, 0.1)
                  if transformer else
                  GruDownscaler(32, 3, [16], 512, num_layers=2, dropout=0.1,
                                bidirectional=True))
    encoder = Encoder(
        BachCPCDataProcessor(32, 2 * ticks, [ENC_VOCAB] * 4, num_tokens_per_block=16),
        downscaler, quantizer, MlpUpscaler(3, 32, 512, 0.1))
    return VQCPCModel(encoder, CModule(32, 512, 32, 2, 0.1),
                      FksModule(32, 32, ENC_BLOCKS),
                      quantization_weighting=0.25 if ema else 0.5)


def random_cpc_batch(gen):
    """bench.py's random token batch, on the card: x_left / x_right (16, 24,
    4), negatives (16, 15, 6, 4, 4), tokens in [0, 62)."""
    ticks = ENC_BLOCKS * 16 // 4
    shapes = {"x_left": (ENC_BATCH, ticks, 4), "x_right": (ENC_BATCH, ticks, 4),
              "negative_samples": (ENC_BATCH, ENC_NEG, ENC_BLOCKS, 4, 4)}
    return {k: torch.randint(ENC_VOCAB, shape, generator=gen, device="cuda",
                             dtype=torch.int32) for k, shape in shapes.items()}


def phase_encoder_training(gen: torch.Generator, profile: bool) -> dict:
    """(a) Throughput of VQCPCEncoderTrainer.train_step at bench.py's
    geometry, the counted main path; (b) bench.py's trained guard on the
    port's own data path; (c) with --profile, 3 profiled steps."""
    from vqcpcb_tpu_torch.training.encoder_trainer import VQCPCEncoderTrainer
    batches = [random_cpc_batch(gen) for _ in range(4)]
    tokens_per_step = sum(batches[0][k].numel() for k in batches[0])
    trainer = VQCPCEncoderTrainer(build_cpc_model(ema=False), seed=0)
    trainer.init_state(batches[0], lr=1e-3)
    codebook = trainer.model.encoder.quantizer.codebooks
    log(f"# [encoder] codebook init from the negatives' latents: "
        f"{tuple(codebook.shape)}, {len(codebook.reshape(-1, 3).unique(dim=0))} "
        f"distinct codewords")

    # kernel route vs the CPU plain route, one eval forward at batch 2
    small = {k: v[:2] for k, v in batches[0].items()}
    with torch.no_grad():
        card = trainer.model(small, training=False)[1]
        cpu = copy.deepcopy(trainer.model).cpu()(
            {k: v.cpu() for k, v in small.items()}, training=False)[1]
    loss_err = abs(card["loss"].item() - cpu["loss"].item()) / abs(cpu["loss"].item())
    log(f"# [encoder] eval forward at batch 2, card vs CPU f32 plain route: loss "
        f"{card['loss'].item():.6f} vs {cpu['loss'].item():.6f} (relative "
        f"{loss_err:.3e}, need <= {ENC_LOSS_RTOL}), codewords "
        f"{card['num_codewords'].item()} vs {cpu['num_codewords'].item()}")
    if not (loss_err <= ENC_LOSS_RTOL
            and card["num_codewords"].item() == cpu["num_codewords"].item()):
        raise AssertionError("the encoder-training forward differs from the CPU's")

    for i in range(ENC_WARMUP):
        trainer.train_step(batches[i % len(batches)])
    torch.cuda.synchronize()
    # (a) the counted main path: 100 steps timed as one window with one sync
    # at the end (bench.py:131-136), then 30 steps synced one by one
    reset_counts()
    t0 = time.perf_counter()
    for i in range(ENC_STEPS):
        metrics = trainer.train_step(batches[i % len(batches)])
    window_loss = metrics["loss"].item()
    window_s = time.perf_counter() - t0
    tokens_per_s = tokens_per_step * ENC_STEPS / window_s
    step_s, losses = [], []
    for i in range(ENC_SYNCED):
        out, sec = synced_seconds(lambda: trainer.train_step(batches[i % len(batches)]))
        step_s.append(sec)
        losses.append(out["loss"])
    main_counts = counts()
    losses = torch.stack(losses).cpu().tolist() + [window_loss]
    steps = ENC_STEPS + ENC_SYNCED
    want = {k: 3 * steps if k == "vq_nearest" else 0 for k in main_counts}
    step_ms = float(np.median(step_s)) * 1e3
    log(f"# [encoder] (a) encoder_train_tokens_per_sec {tokens_per_s:.1f} "
        f"({ENC_STEPS} steps of {tokens_per_step} tokens in {window_s:.4f} s, one "
        f"sync at the end); median {step_ms:.3f} ms/step over {ENC_SYNCED} synced "
        f"steps (min {min(step_s) * 1e3:.3f}, max {max(step_s) * 1e3:.3f}); loss "
        f"{losses[0]:.4f} .. {losses[-2]:.4f}")
    log(f"# [encoder] (a) launches over {steps} steps: {json.dumps(main_counts)} "
        f"(need {json.dumps(want)}: K1 on the negatives, the left and the right "
        "windows of every step)")
    if main_counts != want:
        raise AssertionError(f"encoder-training launches {main_counts}, not {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite encoder-training loss: {losses}")

    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall_s = synced_seconds(lambda: [trainer.train_step(batches[i])
                                                for i in range(3)])
        _log_profile(prof, wall_s, f"[encoder] 3 encoder train steps at batch "
                     f"{ENC_BATCH}", 20)
    guard = phase_trained_guard()
    return dict(launches=main_counts, tokens_per_s=tokens_per_s, step_ms=step_ms,
                **guard)


def phase_trained_guard() -> dict:
    """bench.py:187-278 on the port: the EMA twin trained for 300 steps on
    the synthetic corpus must beat max(3 / 16, untrained + 0.05) CPC
    accuracy over 8 held-out batches, with codebook perplexity >= 3 over 64
    held-out windows."""
    import shutil
    from vqcpcb_tpu_torch.data.corpora import SyntheticChoraleCorpus
    from vqcpcb_tpu_torch.data.dataloaders import BachCPCDataloaderGenerator
    from vqcpcb_tpu_torch.models.cpc import codebook_usage
    from vqcpcb_tpu_torch.models.encoder import merge_codes
    from vqcpcb_tpu_torch.training.encoder_trainer import VQCPCEncoderTrainer
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "cpc_data")
    shutil.rmtree(cache, ignore_errors=True)      # build the windows anew
    t0 = time.perf_counter()
    data = BachCPCDataloaderGenerator(
        num_tokens_per_block=16, num_blocks_left=ENC_BLOCKS,
        num_blocks_right=ENC_BLOCKS, negative_sampling_method="random",
        num_negative_samples=ENC_NEG,
        corpus=SyntheticChoraleCorpus(num_chorales=24, min_beats=16,
                                      max_beats=48, seed=0),
        cache_root=cache, seed=7)

    def corpus_batches(split, limit):
        """split 0 (train, fresh loaders until `limit`) or 1 (val, one pass),
        as bench.py:corpus_batches."""
        count = 0
        while count < limit:
            for b in data.dataloaders(batch_size=ENC_BATCH)[split]:
                if count >= limit:
                    return
                yield b
                count += 1
            if split:
                return

    first = next(corpus_batches(0, 1))
    log(f"# [encoder] (b) synthetic corpus: {len(data.dataset_positive.windows)} "
        f"positive and {len(data.dataset_negative.windows)} negative windows, "
        f"built in {time.perf_counter() - t0:.2f} s")
    trainer = VQCPCEncoderTrainer(build_cpc_model(ema=True), seed=1)
    trainer.init_state(first, lr=1e-3)
    quantizer = trainer.model.encoder.quantizer

    def heldout():
        accs, windows = [], []
        for b in corpus_batches(1, 8):
            accs.append(trainer.eval_step(b)["accuracy"].cpu().numpy())
            windows += [b["x_left"], b["x_right"]]
        codes = merge_codes(trainer.encode(np.concatenate(windows)[:64])[1],
                            quantizer.codebook_size)
        return (float(np.mean(accs)), len(accs),
                codebook_usage(codes, quantizer.codebook_size)[1].item())

    untrained_acc, n_val, _ = heldout()
    t0 = time.perf_counter()
    for b in corpus_batches(0, GUARD_STEPS):
        metrics = trainer.train_step(b)
    last_loss = metrics["loss"].item()
    train_s = time.perf_counter() - t0
    acc, _, ppl = heldout()
    chance = 1.0 / (1 + ENC_NEG)
    need = max(3 * chance, untrained_acc + 0.05)
    ok = acc > need and ppl >= 3.0
    log(f"# [encoder] (b) trained guard: {GUARD_STEPS} steps in {train_s:.2f} s "
        f"(last loss {last_loss:.4f}); held-out CPC accuracy {acc:.4f} over "
        f"{n_val} val batches (untrained {untrained_acc:.4f}, need > {need:.4f}), "
        f"codebook perplexity {ppl:.4f} over 64 held-out windows (need >= 3.0)")
    if not ok:
        raise AssertionError("the trained guard failed")
    return dict(heldout_cpc_accuracy=acc, untrained_cpc_accuracy=untrained_acc,
                trained_codebook_perplexity=ppl)


# ---- phase 10 --------------------------------------------------------------

# The student of configs/encoder_student_synthetic.py at full width (its
# widths are configs/encoder_student_config.py's): batch 8 of 96 events x 4
# voices from the synthetic corpus, teacher 8 x 512 / ff 2048, the linear
# transformer downscaler [4, 4] layers, the relative auxiliary decoder [4, 4]
# layers, 8 heads, dropout 0.1, f32, Adam lr 1e-5 (both optimizers).
STUDENT_CONFIG = os.path.join("configs", "encoder_student_synthetic.py")
STUDENT_WARMUP = 5
STUDENT_SYNCED = 30
# The masked event of the route comparisons. They run at the training
# batch: at batch 2 two small gradients (the relative auxiliary decoder's
# stage-0 table, a linear bias) read cosines down to 0.9937 on an H100, the
# bf16 dot rule's own spread that close to GRAD_COSINE; four times the
# events sum their signal further above it.
STUDENT_INDEX = 40
TRANSFO_WARMUP = 5
TRANSFO_SYNCED = 30
# Launches of one step: K1 once in the quantizer (three times in the VQ-CPC
# step: negatives, left, right), the relative-bias forward and backward in
# every relative layer (teacher 8, downscaler 4 + 4, auxiliary decoder 4 +
# 4; the VQ-CPC step's three downscaler calls 3 x 8), and with the absolute
# auxiliary decoder K6 in its 8 layers.
STEP_LAUNCHES.update({
    "student": {"vq_nearest": 1, "relbias_attention_fwd": 24,
                "relbias_attention_bwd": 24},
    "student_absolute": {"vq_nearest": 1, "relbias_attention_fwd": 16,
                         "relbias_attention_bwd": 16,
                         "fused_attention_train_fwd": 8,
                         "fused_attention_train_bwd_nobias": 8},
    "transfo_encoder": {"vq_nearest": 3, "relbias_attention_fwd": 24,
                        "relbias_attention_bwd": 24}})
# one eval step with the absolute auxiliary decoder: K3-fwd in the teacher
# and the downscaler, K4 in the decoder
STUDENT_ABSOLUTE_EVAL = {"vq_nearest": 1, "relbias_attention_fwd": 16,
                         "fused_attention": 8}


def student_at_full_width(aux_type: str = "relative"):
    """(trainer, 4 batches on the card): the StudentEncoderTrainer the
    encoder CLI builds from STUDENT_CONFIG (weights from torch's init under
    seed 0), with the auxiliary decoder `aux_type`, and 4 batches of its
    data loader (the corpus windows built into build/student_data)."""
    from vqcpcb_tpu_torch import getters, main_encoder
    from vqcpcb_tpu_torch.utils import load_config_module
    root = os.path.dirname(os.path.abspath(__file__))
    config = load_config_module(os.path.join(root, STUDENT_CONFIG))
    config["auxiliary_networks_kwargs"]["auxiliary_decoder_type"] = aux_type
    data = getters.get_dataloader_generator(
        config["dataset"], "student", config["dataloader_generator_kwargs"], config,
        cache_root=os.path.join(root, "build", "student_data"))
    torch.manual_seed(0)
    trainer = main_encoder.student_trainer(
        config, data, getters.get_encoder(data, config), None, None)
    train = data.dataloaders(batch_size=STUDENT_BATCH)[0]
    batches = [torch.as_tensor(next(train)["x"], device="cuda") for _ in range(4)]
    trainer.init_state(batches[0], lr=config["lr"])
    return trainer, batches


def student_loss_and_grads(trainer, x, index: int):
    """One training forward and backward at the masked event `index` (no
    update): ((teacher loss, encoder-decoder loss), every parameter's
    gradient on the CPU, zeros where none)."""
    trainer.model.zero_grad(set_to_none=True)
    loss_t, loss_e, _ = trainer.losses(x, index)
    (loss_t + loss_e).backward()
    return (loss_t.item(), loss_e.item()), {
        n: (torch.zeros(p.shape) if p.grad is None else p.grad.float().cpu())
        for n, p in trainer.model.named_parameters()}


def card_codes(trainer, run):
    """(run()'s result, the indices of every quantizer forward in it), read
    from the quantizer's output by a forward hook."""
    found = []
    handle = trainer.model["encoder"].quantizer.register_forward_hook(
        lambda module, args, out: found.append(out[1].reshape(-1, module.num_codebooks)))
    try:
        return run(), found
    finally:
        handle.remove()


def _cpu_twin(trainer, codes):
    """The trainer's modules copied to the CPU, in a trainer there (the
    plain route, f32), its quantizer decoding `codes`, the card's indices
    of the same call, one forward each: the CPU route then decodes the
    card's codes, as phase 8 (b) feeds both decoders the card's codes, so a
    latent that the bf16 dots move across a Voronoi boundary does not
    stand for a kernel's error (K1 is held in phase 3 at these shapes)."""
    from vqcpcb_tpu_torch.training.student_trainer import StudentEncoderTrainer
    model = copy.deepcopy(trainer.model).cpu()
    pinned = iter(codes)

    def search(x, codebooks):
        indices = next(pinned).cpu()
        if indices.shape != x.shape[:2]:
            raise AssertionError(f"the card's codes {tuple(indices.shape)} do not "
                                 f"fit the CPU route's latents {tuple(x.shape)}")
        return indices

    model["encoder"].quantizer.search = search
    return StudentEncoderTrainer(model["encoder"], model["teacher"],
                                 model["auxiliary_decoder"],
                                 trainer.num_events_masked,
                                 trainer.quantization_weighting, device="cpu")


def compare_student_routes(what, trainer, x) -> tuple:
    """One training forward and backward of `trainer` on the card and of its
    CPU twin (on the card's codes) at dropout 0 and STUDENT_INDEX: each
    loss within LOSS_RTOL, every parameter's gradient within cosine
    GRAD_COSINE."""
    set_dropout(trainer.model, 0.0)
    kernel, codes = card_codes(
        trainer, lambda: student_loss_and_grads(trainer, x, STUDENT_INDEX))
    plain = student_loss_and_grads(_cpu_twin(trainer, codes), x.cpu(), STUDENT_INDEX)
    for name, a, b in zip(("teacher", "encoder-decoder"), kernel[0], plain[0]):
        err = abs(a - b) / abs(b)
        log(f"# {what}: {name} loss {a:.6f} vs {b:.6f} (relative {err:.3e}, "
            f"need <= {LOSS_RTOL})")
        if not err <= LOSS_RTOL:
            raise AssertionError(f"{what}: the {name} losses disagree")
    return compare_routes(what, (sum(kernel[0]), kernel[1]),
                          (sum(plain[0]), plain[1]))


def student_steps(trainer, batches, steps: int, kind: str) -> tuple:
    """`steps` synced train steps, counted from zero launches (checked
    against STEP_LAUNCHES[kind]); returns (counts, per-step seconds, the
    steps' metrics on the host)."""
    reset_counts()
    step_s, metrics = [], []
    for i in range(steps):
        out, sec = synced_seconds(lambda: trainer.train_step(batches[i % len(batches)]))
        step_s.append(sec)
        metrics.append(out)
    main_counts = counts()
    want = {k: STEP_LAUNCHES[kind].get(k, 0) * steps for k in main_counts}
    log(f"# [{kind}] train steps: launches {json.dumps(main_counts)} over {steps} "
        f"steps (need {json.dumps(want)})")
    if main_counts != want:
        raise AssertionError(f"{kind} launches {main_counts}, not {want}")
    host = [{k: v.tolist() for k, v in m.items()} for m in metrics]
    for m in host:
        if not all(np.isfinite(v).all() for v in m.values()):
            raise AssertionError(f"{kind}: non-finite metrics {m}")
    return main_counts, step_s, host


def phase_student(gen: torch.Generator, profile: bool, card: str) -> dict:
    """(a) StudentEncoderTrainer at full width: 5 warm-up steps, then 30
    synced (median ms/step, student_train_tokens_per_sec, launches per
    step, finite losses, the teacher's loss lower over the last 5 of the 35
    steps than over the first 5), the counted main path; (b) one training
    forward and backward at batch 8, dropout 0, kernel route vs the CPU f32
    plain route; (c) the same with the absolute auxiliary decoder (K6 in
    training, after 2 counted steps), and one of its eval steps vs the
    plain route (K4); (d) VQCPCEncoderTrainer with the relative-transformer
    downscaler at bench.py's geometry (5 warm-up, 30 synced steps, counted);
    (e) with --profile, 3 profiled student steps."""
    from vqcpcb_tpu_torch.training.encoder_trainer import VQCPCEncoderTrainer
    trainer, batches = student_at_full_width()
    warm = [trainer.train_step(batches[i % 4]) for i in range(STUDENT_WARMUP)]
    torch.cuda.synchronize()
    warm = [{k: v.item() for k, v in m.items()} for m in warm]
    main_counts, step_s, synced = student_steps(trainer, batches, STUDENT_SYNCED,
                                                "student")
    teacher = [m["loss_teacher"] for m in warm + synced]
    first, last = np.mean(teacher[:5]), np.mean(teacher[-5:])
    step_ms = float(np.median(step_s)) * 1e3
    tokens_per_s = STUDENT_BATCH * NUM_EVENTS * 4 / (step_ms / 1e3)
    log(f"# [student] (a) {card}: student_train_tokens_per_sec {tokens_per_s:.1f} "
        f"(batch {STUDENT_BATCH} x {NUM_EVENTS * 4} tokens, f32, dropout 0.1, two "
        f"Adams lr 1e-5); median {step_ms:.3f} ms/step over {STUDENT_SYNCED} synced "
        f"steps (min {min(step_s) * 1e3:.3f}, max {max(step_s) * 1e3:.3f}); "
        f"loss_teacher mean of the first 5 of {len(teacher)} steps {first:.4f}, of "
        f"the last 5 {last:.4f}; last step {json.dumps(synced[-1])}")
    if not last < first:
        raise AssertionError(f"the teacher's loss did not fall: {teacher}")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall_s = synced_seconds(lambda: [trainer.train_step(batches[i])
                                                for i in range(3)])
        _log_profile(prof, wall_s, f"[student] 3 student train steps at batch "
                     f"{STUDENT_BATCH}", 20)
    loss_err, worst_cos, _ = compare_student_routes(
        f"[student] (b) batch {STUDENT_BATCH}, dropout 0, kernel route vs CPU f32 "
        "plain route", trainer, batches[0])
    del trainer
    torch.cuda.empty_cache()

    absolute, abs_batches = student_at_full_width("absolute")
    absolute.train_step(abs_batches[0])               # warm-up
    torch.cuda.synchronize()
    abs_counts, abs_step_s, _ = student_steps(absolute, abs_batches, 2,
                                              "student_absolute")
    abs_err, abs_cos, _ = compare_student_routes(
        f"[student] (c) absolute auxiliary decoder, batch {STUDENT_BATCH}, dropout "
        "0, kernel route vs CPU f32 plain route", absolute, abs_batches[0])
    reset_counts()
    card_eval, codes = card_codes(
        absolute, lambda: absolute.eval_step(abs_batches[0], STUDENT_INDEX))
    torch.cuda.synchronize()
    eval_counts = counts()
    want = {k: STUDENT_ABSOLUTE_EVAL.get(k, 0) for k in eval_counts}
    plain_eval = _cpu_twin(absolute, codes).eval_step(abs_batches[0].cpu(),
                                                      STUDENT_INDEX)
    errs = {k: abs(card_eval[k].item() - v.item()) / abs(v.item())
            for k, v in plain_eval.items() if v.item() != 0}
    log(f"# [student] (c) eval step, kernel route vs CPU f32 plain route: "
        f"relative differences {json.dumps(errs)} (need <= {LOSS_RTOL}); "
        f"launches {json.dumps(eval_counts)} (need {json.dumps(want)})")
    if eval_counts != want or not all(e <= LOSS_RTOL for e in errs.values()):
        raise AssertionError("the absolute auxiliary decoder's eval step disagrees")
    del absolute
    torch.cuda.empty_cache()

    cpc_batches = [random_cpc_batch(gen) for _ in range(4)]
    tokens_per_step = sum(cpc_batches[0][k].numel() for k in cpc_batches[0])
    cpc = VQCPCEncoderTrainer(build_cpc_model(ema=False, transformer=True), seed=0)
    cpc.init_state(cpc_batches[0], lr=1e-4)        # the transfo configs' lr
    for i in range(TRANSFO_WARMUP):
        cpc.train_step(cpc_batches[i % 4])
    torch.cuda.synchronize()
    cpc_counts, cpc_step_s, cpc_metrics = student_steps(
        cpc, cpc_batches, TRANSFO_SYNCED, "transfo_encoder")
    cpc_ms = float(np.median(cpc_step_s)) * 1e3
    cpc_tokens = tokens_per_step / (cpc_ms / 1e3)
    log(f"# [transfo encoder] (d) {card}: VQ-CPC with the relative-transformer "
        f"downscaler, batch {ENC_BATCH}, {tokens_per_step} tokens a step, f32: "
        f"median {cpc_ms:.3f} ms/step over {TRANSFO_SYNCED} synced steps (min "
        f"{min(cpc_step_s) * 1e3:.3f}, max {max(cpc_step_s) * 1e3:.3f}), "
        f"{cpc_tokens:.1f} tokens/s; loss {cpc_metrics[0]['loss']:.4f} .. "
        f"{cpc_metrics[-1]['loss']:.4f}")
    del cpc
    torch.cuda.empty_cache()
    return dict(launches=main_counts, absolute_launches=abs_counts,
                transfo_launches=cpc_counts, step_ms=step_ms,
                tokens_per_s=tokens_per_s, loss_err=loss_err, worst_cos=worst_cos,
                absolute_loss_err=abs_err, absolute_worst_cos=abs_cos,
                transfo_step_ms=cpc_ms, transfo_tokens_per_s=cpc_tokens)


# ---- phase 11 --------------------------------------------------------------

# The entry points as a user calls them, at full width: the encoder CLI on
# configs/encoder_random_synthetic.py (GRU 512 x 2, codebook 32 x 3, batch
# 16), the decoder CLI on copies of configs/decoder_synthetic.py (the
# flagship AC/D/C: d_model 512, 3+3 layers, 8 heads, 384 tokens from 24
# codes, batch 64) and of it with decoder_type 'transformer_relative' (the
# AC/AC/C decoder, cross relbias at ratio 16), each over the encoder the
# first call trained; then the encoder CLI on STUDENT_CONFIG (the student)
# and the flagship decoder over the student's encoder. Epochs and batches
# are cut; widths are not. The flagship's -l -r runs a second time with the
# sampler's two knobs set, as a user sets them (KNOBS).
ENTRY_ENCODER_BATCHES = 60
ENTRY_DECODER_BATCHES = 40
ENTRY_RELATIVE_BATCHES = 10
ENTRY_STUDENT_BATCHES = 20
ENTRY_STUDENT_DECODER_BATCHES = 10
ENTRY_PRIOR_BATCHES = 20
KNOBS = {"VQCPCB_CODES_PER_WINDOW": "2", "VQCPCB_EXACT_TOPP_TIES": "1"}
# the CLI calls of the counted main path, and the kernels each must launch
# (K1 = vq_nearest; K2-fwd / K3-fwd = relbias_attention_fwd, in training /
# at inference; K2-bwd = relbias_attention_bwd)
ENTRY_KERNELS = {
    "encoder -t": ("vq_nearest",),
    "decoder -t": ("vq_nearest", "relbias_attention_fwd", "relbias_attention_bwd"),
    "decoder -l -r": ("vq_nearest", "relbias_attention_fwd"),
    "decoder -l --num_examples 1": ("vq_nearest", "relbias_attention_fwd"),
    "decoder -l -r (knobs)": ("vq_nearest", "relbias_attention_fwd"),
    "AC/AC/C -t": ("vq_nearest", "relbias_attention_fwd", "relbias_attention_bwd"),
    "AC/AC/C -l -r": ("vq_nearest", "relbias_attention_fwd"),
    "student -t": ("vq_nearest", "relbias_attention_fwd", "relbias_attention_bwd"),
    "student -l": ("vq_nearest", "relbias_attention_fwd"),
    "student decoder -t": ("vq_nearest", "relbias_attention_fwd",
                           "relbias_attention_bwd"),
    "student decoder -l -r": ("vq_nearest", "relbias_attention_fwd"),
    # -l -g decodes sampled codes: nothing is encoded
    "prior -t": ("vq_nearest", "relbias_attention_fwd", "relbias_attention_bwd"),
    "prior -l -g": ("relbias_attention_fwd",),
}


def _decoder_config_copy(work: str, name: str, encoder_config: str,
                         decoder_type: str) -> str:
    """configs/decoder_synthetic.py copied to {work}/configs/{name}.py (its
    savename), its config_encoder the trained encoder's config.py."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "configs", "decoder_synthetic.py")) as f:
        text = f.read()
    for old, new in (("'configs/encoder_random_synthetic.py'", repr(encoder_config)),
                     ("'transformer_relative_diagonal'", repr(decoder_type))):
        if old not in text:
            raise AssertionError(f"configs/decoder_synthetic.py has no {old}")
        text = text.replace(old, new)
    path = os.path.join(work, "configs", f"{name}.py")
    with open(path, "w") as f:
        f.write(text)
    return path


def _prior_config_copy(work: str, encoder_config: str, decoder_config: str) -> str:
    """prior_config() written to {work}/configs/prior_synthetic.py (its
    savename), over the trained encoder's and decoder's config.py, one
    epoch of ENTRY_PRIOR_BATCHES batches."""
    root = os.path.dirname(os.path.abspath(__file__))
    config = dict(prior_config(root), config_encoder=encoder_config,
                  config_decoder=decoder_config, num_batches=ENTRY_PRIOR_BATCHES,
                  num_epochs=1, savename="prior_synthetic")
    path = os.path.join(work, "configs", "prior_synthetic.py")
    with open(path, "w") as f:
        f.write('"""configs/prior_config.py on the synthetic corpus."""\n'
                f"config = {config!r}\n")
    return path


def _check_model_dir(model_dir: str, epochs: int, loss: str = "loss") -> list:
    """config.py, both slots and one metrics row per epoch, its `loss`
    finite; returns the rows."""
    for name in ("config.py", "overfitted", "early_stopped", "metrics.jsonl"):
        if not os.path.exists(os.path.join(model_dir, name)):
            raise AssertionError(f"{model_dir} holds no {name}")
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if [r["epoch"] for r in rows] != list(range(epochs)) or not all(
            np.isfinite(r[f"{loss}/train"]) and np.isfinite(r[f"{loss}/val"])
            for r in rows):
        raise AssertionError(f"{model_dir}/metrics.jsonl: {rows}")
    return rows


def phase_entry_points(card: str) -> dict:
    """The port's CLIs in process (main([...])) in a fresh working directory
    under build/: (a) encoder -t, with the cluster dumps; (b) the flagship
    decoder -t over that encoder, -l -r, -l --num_examples 1; (c) the
    AC/AC/C decoder -t, -l -r; (d) the student encoder -t and -l, and the
    flagship decoder -t and -l -r over the student's encoder; (e) the
    checks: every call returns 0, the model directories, the written grids'
    tokens, the reloaded decoders' and student's eval losses, and one
    AC/AC/C step on the kernel route against the f32 plain route. The
    launches of the calls are counted from zero (the main path); the
    trainers the calls build are recorded for (e)."""
    import glob
    import shutil
    from vqcpcb_tpu_torch import main_decoder, main_encoder, main_prior
    from vqcpcb_tpu_torch.data.dataloaders import BachDataloaderGenerator
    from vqcpcb_tpu_torch.training.decoder_trainer import DecoderTrainer
    from vqcpcb_tpu_torch.training.prior_trainer import PriorTrainer
    from vqcpcb_tpu_torch.training.student_trainer import StudentEncoderTrainer
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "entry_points")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "configs"))

    trainers, grids, reharm_s, current = {}, [], {}, {}
    patched = ((DecoderTrainer, "train_model"), (DecoderTrainer, "load"),
               (DecoderTrainer, "generate_reharmonisation"),
               (StudentEncoderTrainer, "train_model"),
               (StudentEncoderTrainer, "load"), (PriorTrainer, "train_model"),
               (PriorTrainer, "load"), (BachDataloaderGenerator, "write"))
    originals = {(cls, name): getattr(cls, name) for cls, name in patched}

    # the trainers by model directory, the first of each kind kept
    def recording(cls, name, key):
        def method(self, *args, **kw):
            trainers.setdefault(key, {}).setdefault(
                os.path.abspath(self.model_dir), self)
            return originals[(cls, name)](self, *args, **kw)
        return method

    def generate_reharmonisation(self, *args, **kw):
        out, sec = synced_seconds(lambda: originals[(
            DecoderTrainer, "generate_reharmonisation")](self, *args, **kw))
        reharm_s[current["label"]] = sec
        return out

    def write(self, x, path):
        grids.append((current["label"],
                      self.dataset.vocabulary.num_tokens_per_channel,
                      np.asarray(x)))
        return originals[(BachDataloaderGenerator, "write")](self, x, path)

    calls, per_call = {}, {}
    cwd = os.getcwd()
    os.chdir(work)
    for cls in (DecoderTrainer, StudentEncoderTrainer, PriorTrainer):
        cls.train_model = recording(cls, "train_model", "trained")
        cls.load = recording(cls, "load", "loaded")
    DecoderTrainer.generate_reharmonisation = generate_reharmonisation
    BachDataloaderGenerator.write = write
    try:
        def run(label, cli, argv):
            current["label"] = label
            before = counts()
            code, sec = synced_seconds(lambda: cli.main(argv))
            per_call[label] = _delta(counts(), before)
            calls[label] = sec
            log(f"# [entry] {label}: exit {code} in {sec:.2f} s, launches "
                f"{json.dumps({k: v for k, v in per_call[label].items() if v})}")
            if code != 0:
                raise AssertionError(f"{label} returned {code}")

        reset_counts()
        run("encoder -t", main_encoder, [
            "-t", "-c", os.path.join(root, "configs", "encoder_random_synthetic.py"),
            "--num_epochs", "1", "--num_batches", str(ENTRY_ENCODER_BATCHES)])
        (encoder_dir,) = glob.glob(os.path.join(work, "models",
                                                "encoder_random_synthetic_*"))
        encoder_config = os.path.join(encoder_dir, "config.py")
        dirs = {"encoder": encoder_dir}
        for kind, decoder_type, batches in (
                ("decoder", "transformer_relative_diagonal", ENTRY_DECODER_BATCHES),
                ("AC/AC/C", "transformer_relative", ENTRY_RELATIVE_BATCHES)):
            name = ("decoder_synthetic" if kind == "decoder"
                    else "decoder_relative_AC_AC_C_synthetic")
            config = _decoder_config_copy(work, name, encoder_config, decoder_type)
            run(f"{kind} -t", main_decoder, ["-t", "-c", config, "--num_epochs",
                                             "1", "--num_batches", str(batches)])
            (dirs[kind],) = glob.glob(os.path.join(work, "models", f"{name}_*"))
            model_config = os.path.join(dirs[kind], "config.py")
            run(f"{kind} -l -r", main_decoder, ["-l", "-r", "-c", model_config])
            if kind == "decoder":
                run(f"{kind} -l --num_examples 1", main_decoder,
                    ["-l", "--num_examples", "1", "-c", model_config])
                # the sampler's knobs, read where JAX reads them: two codes a
                # window, the exact tie rule at the nucleus boundary (-r
                # samples at top-p 0.8)
                os.environ.update(KNOBS)
                try:
                    run(f"{kind} -l -r (knobs)", main_decoder,
                        ["-l", "-r", "-c", model_config])
                finally:
                    for name in KNOBS:
                        del os.environ[name]
                # the prior over the same encoder, generating through this
                # decoder
                config = _prior_config_copy(work, encoder_config, model_config)
                run("prior -t", main_prior, ["-t", "-c", config])
                (dirs["prior"],) = glob.glob(os.path.join(work, "models",
                                                          "prior_synthetic_*"))
                run("prior -l -g", main_prior,
                    ["-l", "-g", "-c", os.path.join(dirs["prior"], "config.py")])
        # (d) the student, and the flagship decoder over its encoder
        run("student -t", main_encoder, [
            "-t", "-c", os.path.join(root, STUDENT_CONFIG), "--num_epochs", "1",
            "--num_batches", str(ENTRY_STUDENT_BATCHES)])
        (dirs["student"],) = glob.glob(os.path.join(
            work, "models", "encoder_student_synthetic_*"))
        student_config = os.path.join(dirs["student"], "config.py")
        run("student -l", main_encoder, ["-l", "-c", student_config])
        config = _decoder_config_copy(work, "decoder_student_synthetic",
                                      student_config, "transformer_relative_diagonal")
        run("student decoder -t", main_decoder, [
            "-t", "-c", config, "--num_epochs", "1", "--num_batches",
            str(ENTRY_STUDENT_DECODER_BATCHES)])
        (dirs["student decoder"],) = glob.glob(os.path.join(
            work, "models", "decoder_student_synthetic_*"))
        run("student decoder -l -r", main_decoder,
            ["-l", "-r", "-c", os.path.join(dirs["student decoder"], "config.py")])
        main_counts = counts()
    finally:
        os.chdir(cwd)
        for (cls, name), method in originals.items():
            setattr(cls, name, method)

    # (e) the checks
    for label, kernels in ENTRY_KERNELS.items():
        missing = [k for k in kernels if not per_call[label][k]]
        others = [k for k, c in per_call[label].items() if c and k not in kernels]
        if missing or others:
            raise AssertionError(f"{label}: launched {per_call[label]}: "
                                 f"missing {missing}, unexpected {others}")
    rows = {kind: _check_model_dir(d, 1, "loss_monitor" if kind == "student"
                                   else "loss") for kind, d in dirs.items()}
    for kind in ("decoder", "AC/AC/C", "student decoder"):
        written = glob.glob(os.path.join(dirs[kind], "reharmonisations", "*.mid"))
        if len(written) < 3:
            raise AssertionError(f"{kind}: {len(written)} re-harmonisations")
    for kind in ("encoder", "student"):
        if not glob.glob(os.path.join(dirs[kind], "clusters_train", "*.mid")):
            raise AssertionError(f"the {kind} CLI wrote no cluster dump")
    if len(glob.glob(os.path.join(dirs["decoder"], "generations", "*.mid"))) != 6:
        raise AssertionError("--num_examples 1 did not write 6 scores")
    if len(glob.glob(os.path.join(dirs["prior"], "generations", "*.mid"))) != 1:
        raise AssertionError("the prior's -l -g did not write 1 score")
    for label, vocab, grid in grids:
        if grid.min() < 0 or (grid >= np.asarray(vocab)).any():
            raise AssertionError(f"{label}: a written grid's tokens leave the "
                                 f"vocabulary {vocab}")
    knob_grids = sum(label == "decoder -l -r (knobs)" for label, _, _ in grids)
    if knob_grids != 3:
        raise AssertionError(f"-l -r with {KNOBS} wrote {knob_grids} grids, not 3")
    log(f"# [entry] (e) every call returned 0; {len(grids)} written grids "
        f"(cluster dumps, re-harmonisations, {knob_grids} of them with "
        f"{json.dumps(KNOBS)}, generations, the prior's generation), every "
        f"token inside its voice's vocabulary")

    # the reloaded decoders and student against the trained ones, one fixed
    # val batch (the student's at a fixed masked event)
    trained, reloaded = trainers["trained"], trainers["loaded"]
    for kind in ("decoder", "AC/AC/C", "student decoder", "student", "prior"):
        a, b = trained[dirs[kind]], reloaded[dirs[kind]]
        if kind == "student":
            x = next(a.dataloader_generator.dataloaders(batch_size=STUDENT_BATCH)[1])["x"]
            la, lb = (t.eval_step(x, STUDENT_INDEX)["loss_encdec"].item()
                      for t in (a, b))
        else:
            x = next(a.dataloader_generator.dataloaders(
                batch_size=DECODER_CLI_BATCH)[1])["x"]
            la, lb = a.eval_step(x)["loss"].item(), b.eval_step(x)["loss"].item()
        log(f"# [entry] (e) {kind}: eval loss of val batch 0, trained in memory "
            f"{la!r}, reloaded by -l {lb!r} (need equal)")
        if la != lb:
            raise AssertionError(f"{kind}: the reloaded model's eval loss differs")

    # one AC/AC/C step, kernel route vs the CPU f32 plain route, dropout 0
    acac = trained[dirs["AC/AC/C"]]
    dec = acac.decoder
    set_dropout(dec, 0.0)
    small = torch.as_tensor(next(acac.dataloader_generator.dataloaders(
        batch_size=2)[0])["x"], device=acac.device)
    codes = acac.encode_codes(small)
    kernel = loss_and_grads(dec, codes, small, bf16=True)
    plain = loss_and_grads(copy.deepcopy(dec).cpu(), codes.cpu(), small.cpu(),
                           bf16=False)
    loss_err, worst_cos, _ = compare_routes(
        "[entry] (e) AC/AC/C (cross relbias at ratio 16), batch 2, dropout 0, "
        "kernel route vs CPU f32 plain route", kernel, plain)

    # (f) the numbers
    tokens = {kind: r[0]["tokens_per_sec/train"] for kind, r in rows.items()}
    log(f"# [entry] (f) {card}: encoder epoch {tokens['encoder']:.1f} tokens/s "
        f"({ENTRY_ENCODER_BATCHES} steps at batch 16), flagship decoder epoch "
        f"{tokens['decoder']:.1f} tokens/s ({ENTRY_DECODER_BATCHES} steps at batch "
        f"64), AC/AC/C epoch {tokens['AC/AC/C']:.1f} tokens/s "
        f"({ENTRY_RELATIVE_BATCHES} steps), student epoch {tokens['student']:.1f} "
        f"tokens/s ({ENTRY_STUDENT_BATCHES} steps at batch {STUDENT_BATCH}), "
        f"decoder over the student's encoder {tokens['student decoder']:.1f} "
        f"tokens/s ({ENTRY_STUDENT_DECODER_BATCHES} steps), prior epoch "
        f"{tokens['prior']:.1f} tokens/s ({ENTRY_PRIOR_BATCHES} steps at batch "
        f"{PRIOR_BATCH}); re-harmonisation (3 "
        f"variants of the corpus's first score) {reharm_s['decoder -l -r']:.3f} s "
        f"flagship ({reharm_s['decoder -l -r (knobs)']:.3f} s with "
        f"{json.dumps(KNOBS)}), {reharm_s['AC/AC/C -l -r']:.3f} s AC/AC/C, "
        f"{reharm_s['student decoder -l -r']:.3f} s over the student's "
        f"encoder; CLI seconds "
        f"{json.dumps({k: round(v, 2) for k, v in calls.items()})}")
    # one counter serves the training forward (K2-fwd) and the inference
    # forward (K3-fwd: val epochs and -l); each training forward has one
    # backward, so K2-fwd = K2-bwd launches and K3-fwd the rest
    by_kernel = {"K1": {l: c["vq_nearest"] for l, c in per_call.items()},
                 "K2-fwd": {l: c["relbias_attention_bwd"] for l, c in per_call.items()},
                 "K2-bwd": {l: c["relbias_attention_bwd"] for l, c in per_call.items()},
                 "K3-fwd": {l: c["relbias_attention_fwd"] - c["relbias_attention_bwd"]
                            for l, c in per_call.items()}}
    for name, calls_ in by_kernel.items():
        log(f"# [entry] (f) {card}: {name} launches {sum(calls_.values())} on this "
            f"path: {json.dumps({l: n for l, n in calls_.items() if n})}")
    return dict(launches=main_counts, tokens_per_s=tokens, reharm_s=reharm_s,
                cli_s=calls, by_kernel=by_kernel, acac_loss_err=loss_err,
                acac_worst_cos=worst_cos)


# ---- phase 12 --------------------------------------------------------------

# The prior of configs/prior_config.py at full width (d_model 512, 6 relative
# layers, 8 heads, FF 1024, embedding 32, dropout 0.1, lr 1e-4, batch 64 of
# 24 beats = 384 tokens = 24 codes) on the synthetic corpus of
# configs/decoder_synthetic.py (the 'bach' corpus waits on M6 (h)), over the
# encoder of configs/encoder_random_synthetic.py (blocks of 16 tokens, one
# codebook of 32): random weights from seed 0 and the data-dependent codebook
# init, as in phase 7. f32, as the JAX trainer.
PRIOR_CONFIG = os.path.join("configs", "prior_config.py")
PRIOR_WARMUP = 5
PRIOR_SYNCED = 30
PRIOR_ROUTE_BATCH = 8
# codes sampled per row: one window of 24, then six chunks of 12 (half the
# window, generate_codes' default)
PRIOR_SAMPLE_CODES = 96
# the greedy check's second start: codes [0, 12) are a fixed prefix
PRIOR_GREEDY_START = 12
# K1 once for the frozen encoder's codes, K2-fwd and K2-bwd in each layer
STEP_LAUNCHES["prior"] = {"vq_nearest": 1, "relbias_attention_fwd": 6,
                          "relbias_attention_bwd": 6}


def prior_config(root: str) -> dict:
    """configs/prior_config.py on the synthetic corpus of
    configs/decoder_synthetic.py, its config_encoder
    configs/encoder_random_synthetic.py."""
    from vqcpcb_tpu_torch.utils import load_config_module
    config = load_config_module(os.path.join(root, PRIOR_CONFIG))
    config.update(
        dataset="synthetic",
        corpus_kwargs=load_config_module(os.path.join(
            root, "configs", "decoder_synthetic.py"))["corpus_kwargs"],
        config_encoder=os.path.join(root, "configs", "encoder_random_synthetic.py"))
    return config


def prior_at_full_width(gen):
    """(trainer, 4 batches on the card): the PriorTrainer the prior CLI
    builds from prior_config() (weights from torch's init under seed 0, the
    encoder's codebook initialised from the 4 batches' latents), and 4
    batches of its data loader (the corpus windows built into
    build/prior_data)."""
    from vqcpcb_tpu_torch import getters
    from vqcpcb_tpu_torch.training.prior_trainer import PriorTrainer
    from vqcpcb_tpu_torch.utils import load_config_module
    root = os.path.dirname(os.path.abspath(__file__))
    cache = os.path.join(root, "build", "prior_data")
    config = prior_config(root)
    enc_config = load_config_module(config["config_encoder"])
    data = getters.get_dataloader_generator(
        config["dataset"], "prior", config["dataloader_generator_kwargs"], config,
        cache_root=cache)
    torch.manual_seed(0)
    encoder = getters.get_encoder(getters.get_dataloader_generator(
        enc_config["dataset"], "vqcpc", enc_config["dataloader_generator_kwargs"],
        enc_config, cache_root=cache), enc_config)
    prior = getters.get_prior(data, encoder, enc_config, config["prior_type"],
                              config["prior_kwargs"])
    trainer = PriorTrainer(encoder, prior,
                           enc_config["quantizer_kwargs"]["codebook_size"], seed=0)
    train = data.dataloaders(batch_size=config["batch_size"])[0]
    batches = [torch.as_tensor(next(train)["x"], device="cuda") for _ in range(4)]
    init_codebook(trainer.encoder, torch.cat(batches), gen)
    trainer.init_state(lr=config["lr"])
    return trainer, batches


def prior_loss_and_grads(prior, codes):
    """One training forward and backward (no update): (loss, every
    parameter's gradient on the CPU, zeros where none)."""
    prior.train()
    prior.zero_grad(set_to_none=True)
    loss = prior(codes)["loss"]
    loss.backward()
    return loss.item(), {
        n: (torch.zeros(p.shape) if p.grad is None else p.grad.float().cpu())
        for n, p in prior.named_parameters()}


def phase_prior(gen: torch.Generator, profile: bool, card: str) -> dict:
    """(a) PriorTrainer at full width: 5 warm-up steps, then 30 synced
    (median ms/step, prior_train_tokens_per_sec and codes/s, launches per
    step, finite losses, the loss lower over the last 5 of the 35 steps
    than over the first 5), the counted main path; (b) one training
    forward and backward at batch 8, dropout 0, kernel route vs the CPU f32
    plain route on the card's codes; (c) generate_codes at batch 512, 96
    codes a row (a window, then six chunks; int8 caches), the counted main
    path, with the launches of one prefill, and greedy (top_k 1) f32-cache
    codes, from position 0 and from 12 after a fixed prefix, against the
    teacher-forced argmax of the logits on the card; (d)
    with --profile, 3 profiled steps and one profiled window of sampling."""
    trainer, batches = prior_at_full_width(gen)
    warm = [trainer.train_step(batches[i % 4]) for i in range(PRIOR_WARMUP)]
    torch.cuda.synchronize()
    warm = [{k: v.item() for k, v in m.items()} for m in warm]
    main_counts, step_s, synced = student_steps(trainer, batches, PRIOR_SYNCED,
                                                "prior")
    losses = [m["loss"] for m in warm + synced]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    step_ms = float(np.median(step_s)) * 1e3
    tokens_per_s = PRIOR_BATCH * NUM_EVENTS * 4 / (step_ms / 1e3)
    codes_per_s = PRIOR_BATCH * PRIOR_CODES / (step_ms / 1e3)
    log(f"# [prior] (a) {card}: prior_train_tokens_per_sec {tokens_per_s:.1f} "
        f"(batch {PRIOR_BATCH} x {NUM_EVENTS * 4} tokens = {PRIOR_CODES} codes, "
        f"f32, dropout 0.1, Adam lr 1e-4), {codes_per_s:.1f} codes/s; median "
        f"{step_ms:.3f} ms/step over {PRIOR_SYNCED} synced steps (min "
        f"{min(step_s) * 1e3:.3f}, max {max(step_s) * 1e3:.3f}); loss mean of the "
        f"first 5 of {len(losses)} steps {first:.4f}, of the last 5 {last:.4f}")
    if not last < first:
        raise AssertionError(f"the prior's loss did not fall: {losses}")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall_s = synced_seconds(lambda: [trainer.train_step(batches[i])
                                                for i in range(3)])
        _log_profile(prof, wall_s, f"[prior] 3 prior train steps at batch "
                     f"{PRIOR_BATCH}", 20)

    # (b) the routes, on the card's codes
    prior = trainer.prior
    set_dropout(prior, 0.0)
    codes = trainer.encode_codes(batches[0][:PRIOR_ROUTE_BATCH])
    kernel = prior_loss_and_grads(prior, codes)
    plain = prior_loss_and_grads(copy.deepcopy(prior).cpu(), codes.cpu())
    loss_err, worst_cos, _ = compare_routes(
        f"[prior] (b) batch {PRIOR_ROUTE_BATCH}, dropout 0, kernel route vs CPU "
        "f32 plain route", kernel, plain)

    # (c) sampling
    prior.eval()
    reset_counts()
    sampled, sample_s = synced_seconds(lambda: trainer.generate_codes(
        PRIOR_SAMPLE_CODES, num_generated_codes=PRIOR_SAMPLE_BATCH))
    sampling_counts = counts()
    windows = 1 + (PRIOR_SAMPLE_CODES - PRIOR_CODES) // (PRIOR_CODES // 2)
    # the first window, sampled from position 0, has no context to prefill
    want = {k: 6 * (windows - 1) if k == "relbias_attention_fwd" else 0
            for k in sampling_counts}
    if sampling_counts != want:
        raise AssertionError(f"generate_codes launched {sampling_counts}, not {want}")
    if sampled.shape != (PRIOR_SAMPLE_BATCH, PRIOR_SAMPLE_CODES) or not (
            (sampled >= 0) & (sampled < CODEBOOK_SIZE)).all():
        raise AssertionError(f"sampled codes {sampled.shape} outside [0, "
                             f"{CODEBOOK_SIZE})")
    reset_counts()
    with torch.no_grad():
        prior.prefill(torch.as_tensor(sampled[:, :PRIOR_CODES], device="cuda"),
                      torch.int8)
    torch.cuda.synchronize()
    prefill = counts()
    if prefill != {k: 6 if k == "relbias_attention_fwd" else 0 for k in prefill}:
        raise AssertionError(f"one prefill launched {prefill}")
    sample_codes_per_s = PRIOR_SAMPLE_BATCH * PRIOR_SAMPLE_CODES / sample_s
    log(f"# [prior] (c) {card}: generate_codes batch {PRIOR_SAMPLE_BATCH} x "
        f"{PRIOR_SAMPLE_CODES} codes ({windows} windows, int8 caches, T 1.0): "
        f"{sample_s:.4f} s, {sample_codes_per_s:.1f} codes/s, "
        f"{len(np.unique(sampled))} distinct codes of {CODEBOOK_SIZE}; launches "
        f"{json.dumps({k: v for k, v in sampling_counts.items() if v})} (the "
        f"{windows - 1} windows after the first); one prefill launched "
        "relbias_attention_fwd 6 times and no other kernel")
    # greedy from position 0 (zero caches), and from the middle of the
    # window after a fixed prefix of sampled codes, so that the codes
    # compared read the prefill's caches
    os.environ["VQCPCB_KV_DTYPE"] = "float32"
    try:
        greedy = prior.sample_window(
            torch.zeros((PRIOR_SAMPLE_BATCH, PRIOR_CODES), dtype=torch.long,
                        device="cuda"), 0, PRIOR_CODES, trainer.generator, top_k=1)
        prefix = torch.as_tensor(sampled[:, :PRIOR_CODES], device="cuda").long()
        prefix[:, PRIOR_GREEDY_START:] = 0
        tail = prior.sample_window(prefix, PRIOR_GREEDY_START,
                                   PRIOR_CODES - PRIOR_GREEDY_START,
                                   trainer.generator, top_k=1)
    finally:
        del os.environ["VQCPCB_KV_DTYPE"]
    if not torch.equal(tail[:, :PRIOR_GREEDY_START], prefix[:, :PRIOR_GREEDY_START]):
        raise AssertionError("sample_window changed its fixed prefix")
    agreement = {}
    for start, codes in ((0, greedy), (PRIOR_GREEDY_START, tail)):
        with torch.no_grad():
            forced = prior.logits(codes).argmax(-1)
        agreement[start] = (forced == codes)[:, start:].float().mean().item()
        log(f"# [prior] (c) greedy f32-cache codes from position {start} vs the "
            f"teacher-forced argmax: {agreement[start] * 100:.3f}% of "
            f"{codes[:, start:].numel()} positions agree (need >= 99%)")
    if min(agreement.values()) < 0.99:
        raise AssertionError(f"greedy agreement {agreement}")
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall_s = synced_seconds(lambda: prior.sample_window(
                torch.zeros((PRIOR_SAMPLE_BATCH, PRIOR_CODES), dtype=torch.long,
                            device="cuda"), 0, PRIOR_CODES, trainer.generator))
        _log_profile(prof, wall_s, f"[prior] sample_window batch "
                     f"{PRIOR_SAMPLE_BATCH}, {PRIOR_CODES} codes (int8 caches)", 15)
    del trainer, prior
    torch.cuda.empty_cache()
    return dict(launches=main_counts, sampling_launches=sampling_counts,
                step_ms=step_ms, tokens_per_s=tokens_per_s, codes_per_s=codes_per_s,
                sample_s=sample_s, sample_codes_per_s=sample_codes_per_s,
                loss_err=loss_err, worst_cos=worst_cos,
                agreement=min(agreement.values()))


# ---- phase 14 --------------------------------------------------------------

# The scale-up MIDI chain of scripts/r5_chain9.sh, through the CLIs, at the
# configs' full width: configs/encoder_scaleup_midi.py (the linear
# relative-transformer downscaler, d_model 512, [4, 4] layers, FF 2048, 8
# heads; the EMA product quantizer of 2 x 16 codes of dimension 4; batch
# 64, 6 + 6 blocks, 15 random negatives), configs/decoder_scaleup_midi.py
# (the flagship AC/D/C over its 256 merged codes, batch 32) and
# configs/prior_scaleup_midi.py (d_model 512, 6 layers, batch 64), over the
# 512 .mid files the port's writer gives with its defaults. Only batches and epochs are cut. The
# encoder runs three times: as configured, with VQCPCB_REMAT=1 (the decoder
# and the prior then run over this one, REMAT on, as the chain runs them),
# and a few steps with VQCPCB_COMPUTE_DTYPE=bfloat16.
SCALEUP_FILES = 512
SCALEUP_ENCODER_BATCHES = 40
SCALEUP_BF16_BATCHES = 6
SCALEUP_DECODER_BATCHES = 20
SCALEUP_PRIOR_BATCHES = 20
# VQCPCB_WARMUP_STEPS as the chain sets it: the encoder's config asks for
# 2000, scripts/r5_chain9.sh sets 300 for the decoder and the prior
SCALEUP_ENCODER_WARMUP = "2000"
SCALEUP_WARMUP = "300"
SCALEUP_CODES = 16 ** 2
# the calls of the chain and the kernels each must launch
SCALEUP_KERNELS = {
    "encoder -t": ("vq_nearest", "relbias_attention_fwd", "relbias_attention_bwd"),
    "encoder -t (remat)": ("vq_nearest", "relbias_attention_fwd",
                           "relbias_attention_bwd"),
    "encoder -t (bf16)": ("vq_nearest", "relbias_attention_fwd",
                          "relbias_attention_bwd"),
    "decoder -t": ("vq_nearest", "relbias_attention_fwd", "relbias_attention_bwd"),
    "decoder -l -r --num_examples 1": ("vq_nearest", "relbias_attention_fwd"),
    "prior -t": ("vq_nearest", "relbias_attention_fwd", "relbias_attention_bwd"),
    # -l -g decodes sampled codes: nothing is encoded
    "prior -l -g": ("relbias_attention_fwd",),
}


def _scaleup_copy(work: str, name: str, savename: str, midi_root: str,
                  num_batches: int) -> str:
    """configs/{name} copied to {work}/configs/{savename}.py (its savename),
    midi_root pointing at the written corpus, one epoch of num_batches."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "configs", name)) as f:
        text = f.read()
    batches = ("'num_batches': None" if name.startswith("encoder")
               else "'num_batches':                 512")
    epochs = ("'num_epochs': 6" if name.startswith("encoder")
              else "'num_epochs':                  3")
    for old, new in (("'data/midi_corpus'", repr(midi_root)),
                     (batches, f"'num_batches': {num_batches}"),
                     (epochs, "'num_epochs': 1")):
        if old not in text:
            raise AssertionError(f"configs/{name} has no {old}")
        text = text.replace(old, new)
    path = os.path.join(work, "configs", f"{savename}.py")
    with open(path, "w") as f:
        f.write(text)
    return path


def phase_scaleup_midi(card: str) -> dict:
    """(a) the corpus: the port's writer, its cache key, the windows built
    (count, seconds); (b) encoder -t three times (as configured, remat, bf16)
    with the epoch tokens/s, the CLI seconds, the median ms/step (CUDA
    events between consecutive steps) and the peak memory of the training
    steps; (c) decoder -t and -l -r --num_examples 1 over the remat run's
    copied config.py (VQCPCB_MIDI_ENCODER_CONFIG); (d) prior -t and -l -g
    (VQCPCB_MIDI_DECODER_CONFIG too); (e) the checks: exit codes, model
    directories and metrics rows, written tokens in the vocabulary, codes <
    256, every written .mid parsed back, reloaded eval losses equal to the
    trained ones, the launches of each call (K1 only as d4_s16)."""
    import gc
    import glob
    import shutil
    from vqcpcb_tpu_torch import getters, main_decoder, main_encoder, main_prior
    from vqcpcb_tpu_torch.data import dataset as port_dataset
    from vqcpcb_tpu_torch.data import midi
    from vqcpcb_tpu_torch.data.dataloaders import BachDataloaderGenerator
    from vqcpcb_tpu_torch.make_midi_corpus import write_corpus
    from vqcpcb_tpu_torch.models.decoder import Decoder
    from vqcpcb_tpu_torch.models.prior import PriorRelative
    from vqcpcb_tpu_torch.training.decoder_trainer import DecoderTrainer
    from vqcpcb_tpu_torch.training.encoder_trainer import VQCPCEncoderTrainer
    from vqcpcb_tpu_torch.training.prior_trainer import PriorTrainer
    from vqcpcb_tpu_torch.utils import load_config_module
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "scaleup_midi")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "configs"))
    corpus_dir = os.path.join(work, "midi_corpus")

    # (a) the corpus, and its windows built into the work directory
    t0 = time.perf_counter()
    n_files = write_corpus(corpus_dir, num=SCALEUP_FILES)
    write_s = time.perf_counter() - t0
    key = midi.MidiCorpus(corpus_dir).cache_key
    saved_cache_root = port_dataset.DEFAULT_CACHE_ROOT
    port_dataset.DEFAULT_CACHE_ROOT = os.path.join(work, "data")
    configs = {
        "encoder": _scaleup_copy(work, "encoder_scaleup_midi.py", "encoder_scaleup_midi",
                                 corpus_dir, SCALEUP_ENCODER_BATCHES),
        "encoder (remat)": _scaleup_copy(work, "encoder_scaleup_midi.py",
                                         "encoder_scaleup_midi_remat", corpus_dir,
                                         SCALEUP_ENCODER_BATCHES),
        "encoder (bf16)": _scaleup_copy(work, "encoder_scaleup_midi.py",
                                        "encoder_scaleup_midi_bf16", corpus_dir,
                                        SCALEUP_BF16_BATCHES),
        "decoder": _scaleup_copy(work, "decoder_scaleup_midi.py", "decoder_scaleup_midi",
                                 corpus_dir, SCALEUP_DECODER_BATCHES),
        "prior": _scaleup_copy(work, "prior_scaleup_midi.py", "prior_scaleup_midi",
                               corpus_dir, SCALEUP_PRIOR_BATCHES)}
    windows = {}
    for label, name, method in (("encoder", "encoder", "vqcpc"),
                                ("decoder and prior", "decoder", "decoder")):
        config = load_config_module(configs[name])
        t0 = time.perf_counter()
        gen = getters.get_dataloader_generator(
            config["dataset"], method, config["dataloader_generator_kwargs"], config)
        windows[label] = (len(gen.dataset.windows), time.perf_counter() - t0)
    log(f"# [scaleup] (a) {n_files} .mid files written in {write_s:.2f} s, "
        f"{sum(os.path.getsize(p) for p in glob.glob(os.path.join(corpus_dir, '*.mid')))} "
        f"bytes, MidiCorpus.cache_key {key}; windows: "
        + ", ".join(f"{label} {n} in {s:.2f} s" for label, (n, s) in windows.items()))

    # what the calls leave: trainers, written grids, codes, step times
    trainers, grids, codes, current = {}, [], [], {}
    steps = {}
    patched = ((DecoderTrainer, "train_model"), (DecoderTrainer, "load"),
               (PriorTrainer, "train_model"), (PriorTrainer, "load"),
               (VQCPCEncoderTrainer, "train_step"), (BachDataloaderGenerator, "write"),
               (Decoder, "forward"), (Decoder, "sample_range"),
               (PriorRelative, "forward"), (PriorTrainer, "generate_codes"))
    originals = {(cls, name): getattr(cls, name) for cls, name in patched}

    def recording(cls, name, kind):
        def method(self, *args, **kw):
            trainers.setdefault(kind, {}).setdefault(os.path.abspath(self.model_dir), self)
            return originals[(cls, name)](self, *args, **kw)
        return method

    def train_step(self, *args, **kw):
        record = steps.setdefault(current["label"], {"events": []})
        if not record["events"]:
            torch.cuda.reset_peak_memory_stats()
            record["baseline"] = torch.cuda.memory_allocated()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        record["events"].append(event)
        out = originals[(VQCPCEncoderTrainer, "train_step")](self, *args, **kw)
        record["peak"] = torch.cuda.max_memory_allocated()
        return out

    def write(self, x, path):
        grids.append((current["label"], self.dataset.vocabulary.num_tokens_per_channel,
                      np.asarray(x)))
        return originals[(BachDataloaderGenerator, "write")](self, x, path)

    def seeing(cls, name, pick):
        def method(self, *args, **kw):
            out = originals[(cls, name)](self, *args, **kw)
            codes.append((current["label"], pick(args, out)))
            return out
        return method

    calls, per_call = {}, {}
    env_before = {k: os.environ.get(k) for k in (
        "VQCPCB_REMAT", "VQCPCB_COMPUTE_DTYPE", "VQCPCB_WARMUP_STEPS",
        "VQCPCB_MIDI_ENCODER_CONFIG", "VQCPCB_MIDI_DECODER_CONFIG")}
    cwd = os.getcwd()
    os.chdir(work)
    for cls in (DecoderTrainer, PriorTrainer):
        cls.train_model = recording(cls, "train_model", "trained")
        cls.load = recording(cls, "load", "loaded")
    VQCPCEncoderTrainer.train_step = train_step
    BachDataloaderGenerator.write = write
    Decoder.forward = seeing(Decoder, "forward", lambda a, o: a[0])
    Decoder.sample_range = seeing(Decoder, "sample_range", lambda a, o: a[0])
    PriorRelative.forward = seeing(PriorRelative, "forward", lambda a, o: a[0])
    PriorTrainer.generate_codes = seeing(PriorTrainer, "generate_codes", lambda a, o: o)
    try:
        def run(label, cli, argv, **env):
            current["label"] = label
            for name in env_before:
                os.environ.pop(name, None)
            os.environ.update(env)
            gc.collect()
            torch.cuda.empty_cache()
            before = counts()
            code, sec = synced_seconds(lambda: cli.main(argv))
            after = counts()
            per_call[label] = dict(_delta(after, before), by_kind=_delta(
                after.by_kind, before.by_kind))
            calls[label] = sec
            log(f"# [scaleup] {label}: exit {code} in {sec:.2f} s, launches "
                f"{json.dumps({k: v for k, v in per_call[label].items() if v})}")
            if code != 0:
                raise AssertionError(f"{label} returned {code}")

        def model_dir(savename):
            # {savename}_{timestamp}: the other savenames go on with a letter
            (path,) = glob.glob(os.path.join(work, "models", f"{savename}_[0-9]*"))
            return path

        reset_counts()
        # (b) the encoder: as configured, with remat, in bf16
        for label, name, env in (
                ("encoder -t", "encoder", {}),
                ("encoder -t (remat)", "encoder (remat)", {"VQCPCB_REMAT": "1"}),
                ("encoder -t (bf16)", "encoder (bf16)",
                 {"VQCPCB_COMPUTE_DTYPE": "bfloat16"})):
            run(label, main_encoder, ["-t", "-c", configs[name]],
                VQCPCB_WARMUP_STEPS=SCALEUP_ENCODER_WARMUP, **env)
        dirs = {"encoder": model_dir("encoder_scaleup_midi"),
                "encoder (remat)": model_dir("encoder_scaleup_midi_remat"),
                "encoder (bf16)": model_dir("encoder_scaleup_midi_bf16")}
        chain_env = dict(VQCPCB_REMAT="1", VQCPCB_WARMUP_STEPS=SCALEUP_WARMUP,
                         VQCPCB_MIDI_ENCODER_CONFIG=os.path.join(
                             dirs["encoder (remat)"], "config.py"))
        # (c) the decoder over the remat run's encoder
        run("decoder -t", main_decoder, ["-t", "-c", configs["decoder"]], **chain_env)
        dirs["decoder"] = model_dir("decoder_scaleup_midi")
        run("decoder -l -r --num_examples 1", main_decoder,
            ["-l", "-r", "--num_examples", "1", "-c",
             os.path.join(dirs["decoder"], "config.py")], **chain_env)
        # (d) the prior over both
        chain_env["VQCPCB_MIDI_DECODER_CONFIG"] = os.path.join(dirs["decoder"],
                                                              "config.py")
        run("prior -t", main_prior, ["-t", "-c", configs["prior"]], **chain_env)
        dirs["prior"] = model_dir("prior_scaleup_midi")
        run("prior -l -g", main_prior,
            ["-l", "-g", "-c", os.path.join(dirs["prior"], "config.py")], **chain_env)
        main_counts = counts()
        # the reloaded decoder and prior against the trained ones, one fixed
        # val batch, in the env of their calls
        os.environ.update(chain_env)
        reloaded = {}
        for kind in ("decoder", "prior"):
            a = trainers["trained"][dirs[kind]]
            b = trainers["loaded"][dirs[kind]]
            x = next(a.dataloader_generator.dataloaders(batch_size=8)[1])["x"]
            reloaded[kind] = (a.eval_step(x)["loss"].item(), b.eval_step(x)["loss"].item())
    finally:
        os.chdir(cwd)
        port_dataset.DEFAULT_CACHE_ROOT = saved_cache_root
        for (cls, name), method in originals.items():
            setattr(cls, name, method)
        for name, value in env_before.items():
            os.environ.pop(name, None)
            if value is not None:
                os.environ[name] = value

    # (e) the checks
    for label, kernels in SCALEUP_KERNELS.items():
        got = per_call[label]
        missing = [k for k in kernels if not got[k]]
        others = [k for k, c in got.items() if c and k not in kernels and k != "by_kind"]
        if missing or others:
            raise AssertionError(f"{label}: launched {got}: missing {missing}, "
                                 f"unexpected {others}")
        if got["by_kind"]["d4_s16"] != got["vq_nearest"]:
            raise AssertionError(f"{label}: K1 ran {got['by_kind']}, not only d4_s16")
    rows = {kind: _check_model_dir(d, 1, "loss_monitor" if kind.startswith("encoder")
                                   else "loss") for kind, d in dirs.items()}
    for label, vocab, grid in grids:
        if grid.min() < 0 or (grid >= np.asarray(vocab)).any():
            raise AssertionError(f"{label}: a written grid's tokens leave the "
                                 f"vocabulary {vocab}")
    seen = {}
    for label, c in codes:
        c = torch.as_tensor(c)
        lo, hi = seen.get(label, (SCALEUP_CODES, -1))
        seen[label] = (min(lo, int(c.min())), max(hi, int(c.max())))
    if not seen or any(lo < 0 or hi >= SCALEUP_CODES for lo, hi in seen.values()):
        raise AssertionError(f"codes outside [0, {SCALEUP_CODES}): {seen}")
    written = sorted(glob.glob(os.path.join(work, "models", "**", "*.mid"),
                               recursive=True))
    # every file parses (a sample of a barely trained decoder may hold no
    # note at all); notes are counted over all of them
    notes = 0
    for path in written:
        with open(path, "rb") as f:
            smf = midi.parse_smf(f.read())
        notes += sum(len(midi.track_notes(t)) for t in smf["tracks"])
    if not notes:
        raise AssertionError("the written .mid files hold no note")
    kinds = {os.path.relpath(p, work).split(os.sep)[2] for p in written}
    if not {"clusters_train", "reharmonisations", "generations"} <= kinds:
        raise AssertionError(f"the chain wrote .mid files only under {kinds}")
    for kind, (la, lb) in reloaded.items():
        log(f"# [scaleup] (e) {kind}: eval loss of val batch 0, trained in memory "
            f"{la!r}, reloaded by -l {lb!r} (need equal)")
        if la != lb:
            raise AssertionError(f"{kind}: the reloaded model's eval loss differs")
    log(f"# [scaleup] (e) every call returned 0; {len(grids)} written grids inside "
        f"the vocabulary; codes seen {json.dumps(seen)} (< {SCALEUP_CODES}); "
        f"{len(written)} written .mid files parsed back ({sorted(kinds)}; {notes} "
        f"notes); every K1 launch ran d4_s16")

    # (f) the numbers
    encoder = {}
    for label in ("encoder -t", "encoder -t (remat)", "encoder -t (bf16)"):
        record = steps[label]
        events = record["events"]
        torch.cuda.synchronize()
        gaps = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
        encoder[label] = dict(
            steps=len(events), median_ms=float(np.median(gaps[2:] or gaps)),
            peak_gib=record["peak"] / 2 ** 30, baseline_gib=record["baseline"] / 2 ** 30)
    tokens = {kind: r[0]["tokens_per_sec/train"] for kind, r in rows.items()}
    for label, e in encoder.items():
        kind = label.replace(" -t", "")
        log(f"# [scaleup] (f) {card}: {label}: epoch {tokens[kind]:.1f} tokens/s "
            f"(metrics.jsonl), CLI {calls[label]:.2f} s, median {e['median_ms']:.3f} "
            f"ms/step over {e['steps']} steps (CUDA events between step starts, the "
            f"first two left out), peak {e['peak_gib']:.3f} GiB allocated over the "
            f"train steps ({e['baseline_gib']:.3f} GiB before the first)")
    log(f"# [scaleup] (f) {card}: decoder epoch {tokens['decoder']:.1f} tokens/s "
        f"({SCALEUP_DECODER_BATCHES} steps at batch 32, remat), prior epoch "
        f"{tokens['prior']:.1f} tokens/s ({SCALEUP_PRIOR_BATCHES} steps at batch 64, "
        f"remat); CLI seconds {json.dumps({k: round(v, 2) for k, v in calls.items()})}")
    return dict(launches=main_counts, encoder=encoder, tokens_per_s=tokens,
                cli_s=calls, windows=windows, cache_key=key)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    try:
        import vqcpcb_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the vqcpcb_tpu_torch package is missing ({exc}); "
              "run from the root of the repository", file=sys.stderr)
        return 2
    card = phase_environment()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    vq = phase_vq(gen)
    rb = phase_relbias(gen)
    rb_train = phase_relbias_train(gen)
    rb_unmasked = phase_relbias_unmasked(gen)
    rb_prior = phase_relbias_prior(gen)
    fused = phase_fused(gen)
    profile = "--profile" in sys.argv[1:]
    by_path = {}
    by_path["serving"] = phase_serving(gen, profile, "flagship")["launches"]
    by_path["decoder_training"] = phase_decoder_training(gen, profile, "flagship")["launches"]
    by_path["absolute_serving"] = phase_serving(gen, profile, "absolute")["launches"]
    by_path["absolute_training"] = phase_decoder_training(gen, profile, "absolute")["launches"]
    by_path["explicit_bias"] = phase_explicit_bias(gen)["launches"]
    by_path["encoder_training"] = phase_encoder_training(gen, profile)["launches"]
    student = phase_student(gen, profile, card)
    by_path["student_training"] = student["launches"]
    by_path["student_absolute_training"] = student["absolute_launches"]
    by_path["transfo_encoder_training"] = student["transfo_launches"]
    by_path["entry_points"] = phase_entry_points(card)["launches"]
    prior = phase_prior(gen, profile, card)
    by_path["prior_training"] = prior["launches"]
    by_path["prior_sampling"] = prior["sampling_launches"]
    by_path["scaleup_midi"] = phase_scaleup_midi(card)["launches"]
    launches = {k: sum(path[k] for path in by_path.values()) for k in counts()}
    log(f"# main-path launches: {json.dumps(by_path)}")
    # every main path's K1 launches run a compiled instance
    k1_kinds = {kind: sum(path.by_kind[kind] for path in by_path.values())
                for kind in counts().by_kind}
    log(f"# main-path K1 launches by kernel: {json.dumps(k1_kinds)}; by path "
        f"{json.dumps({p: c.by_kind for p, c in by_path.items()})}")
    if k1_kinds["runtime"] or sum(k1_kinds.values()) != launches["vq_nearest"]:
        raise AssertionError(f"the main paths' K1 launches {k1_kinds} are not all "
                             "compiled instances")

    def entry(name, source, replaces, counterpart, also, numbers, **extra):
        # ms_bhld: the same call on the (B, H, L, d) layout, where timed
        # library_event_ms: the library call by CUDA events, beside its
        # device time (library_ms), where both were taken
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_event_ms", "ms_bhld")
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    pallas_counterpart=counterpart, also_replaces=also,
                    launches=launches[name],
                    launches_by_path={p: c[name] for p, c in by_path.items()},
                    max_abs_err=numbers["max_abs_err"],
                    **{k: numbers[k] for k in keys if k in numbers}, **extra)

    train_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "ms_bhld")
    pa = "vqcpcb_tpu/ops/pallas_attention.py"
    kernels = [
        # top-level times at the serving shape; every timed shape, the
        # encoder-training ones among them, under "shapes", each with the
        # empty and I/O-floor kernels' times on the run-time kernel's grid;
        # redesigned: the compiled instances (vq_nearest_instance), the
        # main paths' launches by kernel under "launches_by_kind"
        entry("vq_nearest", "vqcpcb_tpu_torch/csrc/vq_nearest.cu",
              "vqcpcb_tpu/ops/pallas_vq.py:28", "vqcpcb_tpu/ops/pallas_vq.py:_kernel",
              [], vq, shapes=vq["shapes"], kinds=vq["kinds"],
              launches_by_kind=k1_kinds, redesigned=True),
        # top-level times at the serving prefill's shape (B=512, T=S=384, f32
        # inputs), as since the kernel was first ported; the training shape
        # (B=32, T=S=384, packed bf16, dropout 0.2) under "training"
        # redesigned: the bf16-dot kernel of attention_fwd_mma.cuh, launched
        # from relbias_attention.cu (the f32-dot kernel stays there)
        # the student slice's unmasked shapes (f32 inputs) under
        # "student_shapes": K2-fwd (training) and K3-fwd (inference) each
        entry("relbias_attention_fwd", "vqcpcb_tpu_torch/csrc/attention_fwd_mma.cuh",
              f"{pa}:571", f"{pa}:_relbias_fwd_kernel", [f"{pa}:875"],
              dict(rb, max_abs_err=max(rb["max_abs_err"],
                                       rb_train["fwd"]["max_abs_err"],
                                       rb_unmasked["max_abs_err"]["fwd"],
                                       rb_prior["max_abs_err"]["fwd"])),
              training={k: rb_train["fwd"][k] for k in train_keys},
              student_shapes={label: dict(batch=v["batch"], t=v["t"],
                                          training=v["k2_fwd"], inference=v["k3_fwd"])
                              for label, v in rb_unmasked["shapes"].items()},
              prior_shapes={label: dict(batch=v["batch"], t=v["t"], causal=True,
                                        training=v.get("k2_fwd"),
                                        inference=v["k3_fwd"])
                            for label, v in rb_prior["shapes"].items()},
              redesigned=True, via="vqcpcb_tpu_torch/csrc/relbias_attention.cu"),
        # times at the flagship training shape; the student slice's
        # unmasked shapes under "student_shapes"
        entry("relbias_attention_bwd",
              "vqcpcb_tpu_torch/csrc/relbias_attention_bwd.cu",
              f"{pa}:895", f"{pa}:_relbias_bwd_kernel_packed", [f"{pa}:582"],
              dict(rb_train["bwd"], max_abs_err=max(
                  rb_train["bwd"]["max_abs_err"], rb_unmasked["max_abs_err"]["bwd"],
                  rb_prior["max_abs_err"]["bwd"])),
              student_shapes={label: dict(batch=v["batch"], t=v["t"], **v["k2_bwd"])
                              for label, v in rb_unmasked["shapes"].items()},
              prior_shapes={label: dict(batch=v["batch"], t=v["t"], causal=True,
                                        **v["k2_bwd"])
                            for label, v in rb_prior["shapes"].items()
                            if "k2_bwd" in v}),
        # K4: times at the absolute prefill's decoder self-attention (B=512,
        # T=S=384, f32); the cross-attention's, the code encoder's and the
        # explicit-bias prefill's (B=8, real bias) beside
        # redesigned: the f32-dot kernel of attention_fwd_f32.cuh, launched
        # from fused_attention.cu
        entry("fused_attention", "vqcpcb_tpu_torch/csrc/attention_fwd_f32.cuh",
              f"{pa}:32", f"{pa}:_kernel", [], fused["k4"],
              cross=fused["k4"]["cross"], code_encoder=fused["k4"]["code_encoder"],
              real_bias=fused["k4"]["real_bias"], redesigned=True,
              via="vqcpcb_tpu_torch/csrc/fused_attention.cu"),
        # K6: times at the training batch's decoder self-attention (B=32,
        # T=S=384, packed bf16, dropout 0.2); the cross-attention's beside
        # redesigned: the bf16-dot kernel of attention_fwd_mma.cuh, launched
        # from fused_attention.cu
        entry("fused_attention_train_fwd", "vqcpcb_tpu_torch/csrc/attention_fwd_mma.cuh",
              f"{pa}:194", f"{pa}:_train_fwd_kernel", [], fused["fwd"],
              cross=fused["fwd"]["cross"], redesigned=True,
              via="vqcpcb_tpu_torch/csrc/fused_attention.cu"),
        entry("fused_attention_train_bwd_nobias",
              "vqcpcb_tpu_torch/csrc/fused_attention_bwd.cu",
              f"{pa}:244", f"{pa}:_train_bwd_kernel_nobias", [], fused["bwd_nobias"],
              cross=fused["bwd_nobias"]["cross"]),
        # with the explicit relative bias (VQCPCB_PALLAS_RELBIAS=0)
        entry("fused_attention_train_bwd", "vqcpcb_tpu_torch/csrc/fused_attention_bwd.cu",
              f"{pa}:211", f"{pa}:_train_bwd_kernel", [], fused["bwd"]),
    ]
    # the error is read under two names by readers of this line; one number
    for k in kernels:
        k["max_err"] = k["max_abs_err"]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
