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
     last, after phases 14 to 19);
 14. the scale-up MIDI chain (scripts/r5_chain9.sh) through the CLIs in
     process in build/scaleup_midi, at the configs' full width: (a) 512
     .mid files from the port's writer (make_midi_corpus.py), their cache
     key, the encoder's and the decoder's windows built with the native
     tokenizer (count, seconds), and the encoder's again with
     VQCPCB_NATIVE=0 (the NumPy paths; seconds, equal bit for bit);
     (b) the encoder CLI -t on configs/encoder_scaleup_midi.py (12 batches)
     as configured, again with VQCPCB_REMAT=1, and 6 batches with
     VQCPCB_COMPUTE_DTYPE=bfloat16: epoch tokens/s, CLI seconds, median
     ms/step, peak memory of the train steps; (c) the decoder CLI -t on
     configs/decoder_scaleup_midi.py (20 batches) over the remat run's
     config.py, then -l -r --num_examples 1; (d) the prior CLI -t on
     configs/prior_scaleup_midi.py (20 batches), then -l -g; (e) the
     checks: exit codes, model directories, tokens inside the vocabulary,
     codes below 256, every written .mid parsed back, reloaded eval losses
     equal to the trained ones, every K1 launch on the d4_s16 instance;
 15. the decoder over an unquantized encoder, grouped-query attention and
     the hooks, at full width: (a) the encoder CLI -t on
     configs/encoder_random_no_quantization_config.py (no quantizer, no K1),
     the decoder CLI -t on
     configs/decoder_relative_AC_D_C_random_noQuantization.py over it, -l
     --num_examples 1, and -l -r, which must raise where the JAX CLI fails
     (the glued z loses its feature axis); then serving at batch 512 over
     the trained encoder's z and 30 train steps at batch 32, each held
     against the CPU f32 plain route; (b) n_head_kv 4 of 8 heads: the
     flagship's serving at batch 512 (its int8 KV-cache bytes beside the
     ungrouped decoder's) and 30 steps beside phases 7 and 8, the cost of
     expanding k and v, the absolute decoder's 5 steps (K6) and one prefill
     at batch 64 (K4), the prior's 30 steps, sampling at batch 512 and
     greedy codes, each held against its plain route, and the grouped
     decoder and prior CLIs (-t, -l --num_examples 1; -t, -l -g); (c) a
     decoder -t with VQCPCB_PROFILE_DIR (a Chrome trace naming a port
     kernel) and a prior -t with VQCPCB_DEBUG_NANS=1 (exit 0);
 16. reference (PyTorch VQCPCB) checkpoints migrated into the port, in
     build/phase16: reference directories written at full width from
     seeded random weights (the flagship pipeline's encoder of
     configs/encoder_random_synthetic.py, both slots, four files each; its
     decoder of configs/decoder_synthetic.py, one whole file with the
     `encoder.*` entries, both slots; a prior at configs/prior_config.py's
     width; the flat layout of a transformer-downscaler encoder,
     configs/encoder_random_transfo_config.py on the synthetic corpus), each
     through the migrate CLI (seconds); then (a) the decoder CLI -l -r and
     -l --num_examples 1 and the prior CLI -l -g through the migrated
     decoder; (b) the loaded modules equal to the written tensors bit for
     bit, the GRU encoder's codes at batch 512 on the card equal to the CPU
     plain route's (the transformer downscaler's z within a bf16 step, its
     codes equal where that cannot move them), the decoder's eval loss over
     those codes within
     LOSS_RTOL of the CPU f32 plain route's; (c) the decoder CLI -t -l for
     one epoch of 10 batches, Adam's moments at zero after the load;
 17. the (data, model) mesh (vqcpcb_tpu_torch/parallel/): (a) the K7 shard
     wrappers on simulated shards of (2, 2), (1, 4) and (4, 1) meshes at
     the training shapes (the flagship's packed bf16 B=32, T=S=384 and its
     (B, H, L, d) twin, the absolute decoder's K6, the prior's B=64, T=S=24
     f32), each shard against the wrapper's plain version (the bf16 w_drop
     bit for bit), at dropout 0 against the unsharded kernel bit for bit,
     and K1 on row shards; (b) one NCCL rank through maybe_initialize
     (torchrun's variables): the decoder and prior CLIs -t, then the
     decoder's -l -r and -l --num_examples 1 and the prior's -l -g
     (generation over the mesh, seconds of each); one NCCL rank from
     VQCPCB_COORDINATOR: the encoder CLI -t, VQ-CPC and student; then the
     encoder's -l on the one-GPU path;
     (c) four ranks sharing the card over gloo (launch.run_ranks): gloo's
     collectives on CUDA tensors probed, a (2, 2) flagship and absolute
     decoder at dropout 0.2, and the flagship decoder, the prior, the
     VQ-CPC (BatchNorm, EMA, transformer downscaler) and the student at
     dropout 0 in f32 against one rank on the same global batches (losses,
     gathered clipped gradients; the encoder side's codebook init, quantizer
     buffers and K1 codes); (d) with two or more GPUs, NCCL ranks one per
     GPU; (e) the KV-cached samplers over four gloo ranks sharing the card
     on (2, 2) and (4, 1): the flagship's encode (K1 on each rank's rows)
     and sample_range at batch 512 x 384 positions (int8 caches), greedy
     and at T 0.95 / top-p 0.8, the prior's generate_codes at 512 x 96,
     the absolute decoder's prefill (K4) and 32 positions (f32 caches), each
     against one rank's run on the card: greedy tokens equal but at near
     ties (counted), the codes equal, every rank the same tokens, the
     stochastic run's share of equal tokens, tokens/s (not speeds of the
     mesh);
 18. the f32 route (VQCPCB_PALLAS_BF16_DOTS=0 with
     VQCPCB_COMPUTE_DTYPE=float32, the in-kernel relative bias): (a) the
     f32-dot kernels at the flagship's shapes against their plain versions
     within 1e-5 of max(1, max |value|), the dropout masks bit for bit, a
     second backward bit for bit: K2-fwd and K2-bwd at batch 32, T = S =
     384 causal, packed, dropout 0.2; K3-fwd at batch 512, causal 384 x 384
     and 384 x 24 (ratio 16); K6-bwd with a real bias at batch 32; each
     timed beside its plain version, its bound and one f32 SDPA call with
     the mask and bias as a float mask (its backward by device time);
     (b) the flagship's serving at full width: encode, sample_range at 512
     x 384 (tokens/s, the prefill's ms and launches), logits at batch 8
     against the CPU plain route; (c) 30 train steps at batch 32, dropout
     0.2 (ms/step, tokens/s, a falling loss), and the kernel route against
     the CPU f32 plain route at batch 2 (the loss within 1e-5 relative,
     every gradient's relative L2 gap within 1e-4);
 19. attention maps of the flagship, the AC/AC/C
     (configs/decoder_relative_AC_AC_C_random.py) and the absolute decoder
     at full width, batch 8: (a) encode_codes and
     Decoder.forward(collect_attentions=True), the dump's path, launch K1
     once and K3-fwd or K4 once a memory-encoder layer (3); the decoder
     stack takes the plain route and returns every map, within 1e-5 of the
     CPU plain route's on the same memory (TF32 off), each row summing to
     1 within 1e-5;
     (b) the forward without collection launches K3-fwd (6, 9) or K4 (9)
     once a layer and returns no map, (a)'s loss within 1e-4 relative of
     its; (c) DecoderTrainer.dump_attention_maps writes one PDF a map under
     the expected names in build/phase19 where matplotlib and seaborn are
     installed (a line says which case held).
The five runs of phases 7 and 8, the run of phase 9 (a), the three runs of
phase 10 (a), (c) and (d), the CLI calls of phase 11, the runs of phase 12
(a) and (c), the CLI calls of phase 14, the runs and CLI calls of phase 15,
the CLI calls and the two encodes at batch 512 of phase 16, and the CLI
calls of phase 17 (b) with the ranks' steps of (c) and samplers of (e)
(their launches counted in each rank and summed), the serving run and
the 30 steps of phase 18, and the encode and collected forward of each
decoder in phase 19 (a) are the main paths: each
is driven with the launch counts set to 0 just before it and read just
after. Every K1 launch on them must run a compiled instance.

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


# torch.profiler (CUPTI) now and then ends a session with no device event
# at all, though the calls ran: such a session is run again, up to
# PROFILER_TRIES sessions; after that device_ms times with CUDA events
# (which then include the host's gaps between launches) and says so.
PROFILER_TRIES = 3
DEVICE_TIME_FALLBACKS = []


def device_ms(fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds of device time per call: the kernels' own time, summed
    by torch.profiler over `reps` calls after warm-up, without the host's
    gaps between them. A session that records no device time is run again;
    after PROFILER_TRIES such sessions the CUDA events' time is returned
    and the fallback logged and kept in DEVICE_TIME_FALLBACKS."""
    import gc
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILER_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)
        if busy_us > 0:
            return busy_us / 1e3 / reps
        log(f"# device_ms: torch.profiler session {attempt} of {PROFILER_TRIES} "
            "recorded no device time")
        del prof
        gc.collect()
    ms = time_cuda(fn, reps, warmup=0)
    DEVICE_TIME_FALLBACKS.append(ms)
    log(f"# device_ms: timed with CUDA events instead: {ms:.5f} ms a call "
        "(host gaps included)")
    return ms


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


def _dropped_rows(fwd, q, k, v, mask, extra, kw, s):
    """The forward's dropped weights (B, H, T, S) in f32: with v the one-hot
    columns of a block of d keys, its output is that block of w_drop (one
    product of a weight and 1, and zeros, summed in f32). v shares k's
    strides, as the kernels ask (k, v may be slices of one projection)."""
    from vqcpcb_tpu_torch.ops._kernel_io import heads
    nh = kw.get("num_heads")
    b, h, t, d = heads(q, nh).shape
    rows = torch.empty((b, h, t, s), device="cuda")
    for c0 in range(0, s, d):
        n = min(d, s - c0)
        one_hot = torch.zeros((b, h, s, d), device="cuda")
        one_hot[:, :, c0:c0 + n, :n] = torch.eye(n, device="cuda")
        if nh:
            one_hot = one_hot.transpose(1, 2).reshape(b, s, h * d)
        vv = torch.empty_strided(k.shape, k.stride(), dtype=v.dtype, device="cuda")
        vv.copy_(one_hot)
        rows[..., c0:c0 + n] = heads(fwd(q, k, vv, mask, *extra, **kw), nh)[..., :n]
        del one_hot, vv
    return rows


def _hold_weights(what, fwd, weights_plain, inputs, kw) -> str:
    """The forward's bf16 w_drop against the plain version's f32 w_drop
    rounded to bf16: equal at every entry (the forward's counterpart of
    _hold_scratch), read through _dropped_rows. `inputs` is (q, k, v, mask,
    *extra, dout) as weights_plain takes them; fwd takes them without dout."""
    q, k, v, mask, *extra, g = inputs
    kw = {key: val for key, val in kw.items() if key != "need_dmask"}
    w_drop, _ = weights_plain(*inputs, **kw)
    b, h, t, s = w_drop.shape
    rows = _dropped_rows(fwd, q, k, v, mask, extra, kw, s)
    differ = (rows != w_drop.to(torch.bfloat16).float()).sum().item()
    del rows
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
                             cross_attention_type="full"),
            # configs/decoder_relative_AC_AC_C_random.py (decoder_type
            # 'transformer_relative'): relative cross-attention (phase 19)
            "relative_acac": dict(transformer_type="relative",
                                  cross_attention_type="anticausal")}
# The kernel one prefill launches, and how often: 3 encoder + 3 decoder
# self-attentions (relative bias), or those and 3 cross-attentions (K4).
PREFILL_LAUNCHES = {"flagship": ("relbias_attention_fwd", 6),
                    "absolute": ("fused_attention", 9)}
# Launches of one train step: the attentions' forward and backward, and K1
# for the frozen encoder's codes. "explicit_bias" is the flagship with
# VQCPCB_PALLAS_RELBIAS=0, "flagship_f32" with f32 dots (phase 18).
STEP_LAUNCHES = {
    "flagship": {"relbias_attention_fwd": 6, "relbias_attention_bwd": 6,
                 "vq_nearest": 1},
    "absolute": {"fused_attention_train_fwd": 9,
                 "fused_attention_train_bwd_nobias": 9, "vq_nearest": 1},
    "explicit_bias": {"fused_attention_train_fwd": 6,
                      "fused_attention_train_bwd": 6, "vq_nearest": 1},
    "flagship_f32": {"relbias_attention_fwd": 6, "relbias_attention_bwd": 6,
                     "relbias_attention_fwd_f32": 6, "relbias_attention_bwd_f32": 6,
                     "vq_nearest": 1}}


def build_models(vocab, dropout: float = 0.0, kind: str = "flagship",
                 n_head_kv=None):
    """Full width, random weights from torch's init under a fixed seed:
    the encoder of configs/encoder_random_config.py and a decoder of
    DECODERS, d_model 512, 8 heads, 3 + 3 layers, ff 1024, positional 8
    (the configs' dropout 0.2 is the caller's `dropout`; serving runs in
    eval mode); n_head_kv: grouped-query attention in every attention of
    the decoder."""
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
        n_head_kv=n_head_kv,
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
    """Every kernel wrapper's count to 0, the K7 wrappers' too."""
    from torch_mesh_harness import reset_launch_counts
    reset_launch_counts()


class Launches(dict):
    """Launches by kernel, with K1's split by the kernel the shape picked
    (vq_kernels.launches_by_kind) beside them as `by_kind`: not a key, so
    the phases' comparisons of whole counts stay as they are."""
    by_kind: dict


KERNELS = ("vq_nearest", "relbias_attention_fwd", "relbias_attention_bwd",
           "fused_attention", "fused_attention_train_fwd",
           "fused_attention_train_bwd", "fused_attention_train_bwd_nobias",
           # of those, the calls with f32 dots (VQCPCB_PALLAS_BF16_DOTS=0)
           "relbias_attention_fwd_f32", "relbias_attention_bwd_f32",
           "fused_attention_train_fwd_f32", "fused_attention_train_bwd_f32")


def counts() -> Launches:
    """The kernels' launch counts (torch_mesh_harness.launch_counts, the
    one count of every wrapper, which the mesh's rank processes read too),
    K1's by kind beside them."""
    from torch_mesh_harness import launch_counts
    now = launch_counts()
    out = Launches({k: now[k] for k in KERNELS})
    out.by_kind = {k.split("/", 1)[1]: n for k, n in now.items()
                   if k.startswith("vq_nearest/")}
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
    from vqcpcb_tpu_torch.ops.gru import GRU
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = rate
        elif isinstance(m, MultiheadAttention):
            m.dropout = rate
        elif isinstance(m, GRU) and m.num_layers > 1:
            m.layer_dropout = rate


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
    layers = "f32 transformer layers, f32 dots" if kind.endswith("_f32") else \
        "bf16 transformer layers"
    log(f"# [{kind}] decoder training batch {TRAIN_BATCH} x {NUM_EVENTS * 4} "
        f"tokens, {layers}, dropout {TRAIN_DROPOUT}, Adam lr 1e-4 clip 5: "
        f"median {step_ms:.3f} ms/step (min {min(step_s) * 1e3:.3f}, max "
        f"{max(step_s) * 1e3:.3f}), {tokens_per_s:.1f} tokens/s; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (mean of first 4 {first:.4f}, "
        f"last 4 {last:.4f})")
    return dict(launches=main_counts, step_ms=step_ms, tokens_per_s=tokens_per_s,
                losses=losses)


def _trainer(gen, kind: str, n_head_kv=None):
    from vqcpcb_tpu_torch.training.decoder_trainer import DecoderTrainer
    vocab = synthetic_vocabulary()
    encoder, decoder = build_models(vocab, dropout=TRAIN_DROPOUT, kind=kind,
                                    n_head_kv=n_head_kv)
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


def build_cpc_model(ema: bool, transformer: bool = False, batch_norm: bool = False):
    """The VQ-CPC model of bench.py:52-88 at full width, random weights from
    torch's init under a fixed seed: embedding 32, two independent 2-layer
    GRUs of 512 over blocks of 16 tokens, codebook 32 x 3 (one codebook,
    commitment 0.25), MLP upscaler 512 -> 32, CModule GRU 512 x 2 -> 32,
    FksModule k_max 6, dropout 0.1; quantization weighting 0.5. With `ema`,
    bench.py's trained-guard twin: the EMA quantizer (decay 0.99) and
    weighting 0.25. With `transformer`, the downscaler of
    configs/encoder_random_transfo_config.py instead of the GRUs: the
    strided relative-transformer downscaler, factors [4, 4], d_model 512, 8
    heads, 4 + 4 layers, ff 2048. With `batch_norm`, the commitment
    quantizer's search normalised by its BatchNorm."""
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
                 if ema else ProductVectorQuantizer(CODEBOOK_SIZE, 3, 0.25, 1,
                                                    use_batch_norm=batch_norm))
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


def student_at_full_width(aux_type: str = "relative", mesh=None):
    """(trainer, 4 batches on the card): the StudentEncoderTrainer the
    encoder CLI builds from STUDENT_CONFIG (weights from torch's init under
    seed 0), with the auxiliary decoder `aux_type`, over `mesh` (None:
    make_mesh()), and 4 batches of its data loader (the corpus windows
    built into build/student_data)."""
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
        config, data, getters.get_encoder(data, config), None, None, mesh)
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
                acac_worst_cos=worst_cos, encoder_config=encoder_config)


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


def prior_parts(gen, n_head_kv=None):
    """(encoder, prior, codebook size, 4 batches on the card, lr): the
    modules the prior CLI builds from prior_config() (weights from torch's
    init under seed 0, the encoder on the card with its codebook
    initialised from the 4 batches' latents), and 4 batches of its data
    loader (the corpus windows built into build/prior_data); n_head_kv in
    its prior_kwargs when given."""
    from vqcpcb_tpu_torch import getters
    from vqcpcb_tpu_torch.utils import load_config_module
    root = os.path.dirname(os.path.abspath(__file__))
    cache = os.path.join(root, "build", "prior_data")
    config = prior_config(root)
    if n_head_kv is not None:
        config["prior_kwargs"] = dict(config["prior_kwargs"], n_head_kv=n_head_kv)
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
    train = data.dataloaders(batch_size=config["batch_size"])[0]
    batches = [torch.as_tensor(next(train)["x"], device="cuda") for _ in range(4)]
    encoder.cuda()
    init_codebook(encoder, torch.cat(batches), gen)
    return (encoder, prior, enc_config["quantizer_kwargs"]["codebook_size"],
            batches, config["lr"])


def prior_at_full_width(gen, n_head_kv=None):
    """(trainer, 4 batches on the card): a PriorTrainer over prior_parts'
    modules, its optimizer initialised."""
    from vqcpcb_tpu_torch.training.prior_trainer import PriorTrainer
    encoder, prior, codebook_size, batches, lr = prior_parts(gen, n_head_kv)
    trainer = PriorTrainer(encoder, prior, codebook_size, seed=0)
    trainer.init_state(lr=lr)
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
SCALEUP_ENCODER_BATCHES = 12
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
    windows, arrays = {}, {}

    def build_windows(name, method):
        config = load_config_module(configs[name])
        t0 = time.perf_counter()
        gen = getters.get_dataloader_generator(
            config["dataset"], method, config["dataloader_generator_kwargs"], config)
        return gen.dataset.windows, time.perf_counter() - t0

    for label, name, method in (("encoder", "encoder", "vqcpc"),
                                ("decoder and prior", "decoder", "decoder")):
        arrays[label], seconds = build_windows(name, method)
        windows[label] = (len(arrays[label]), seconds)
    # the encoder's windows once more on the NumPy paths (VQCPCB_NATIVE=0),
    # into a cache of their own: equal to the native route's bit for bit
    from torch_mesh_harness import with_env
    port_dataset.DEFAULT_CACHE_ROOT = os.path.join(work, "data_numpy")
    try:
        numpy_windows, numpy_s = with_env({"VQCPCB_NATIVE": "0"},
                                          lambda: build_windows("encoder", "vqcpc"))
    finally:
        port_dataset.DEFAULT_CACHE_ROOT = os.path.join(work, "data")
    if not (numpy_windows.dtype == arrays["encoder"].dtype
            and np.array_equal(numpy_windows, arrays["encoder"])):
        raise AssertionError("(a) the NumPy route's windows differ from the native "
                             "tokenizer's")
    native_s = windows["encoder"][1]
    log(f"# [scaleup] (a) {n_files} .mid files written in {write_s:.2f} s, "
        f"{sum(os.path.getsize(p) for p in glob.glob(os.path.join(corpus_dir, '*.mid')))} "
        f"bytes, MidiCorpus.cache_key {key}; windows (native tokenizer): "
        + ", ".join(f"{label} {n} in {s:.2f} s" for label, (n, s) in windows.items())
        + f"; the encoder's again with VQCPCB_NATIVE=0 (NumPy): {len(numpy_windows)} "
        f"in {numpy_s:.2f} s ({numpy_s / native_s:.2f}x the native build), equal "
        "bit for bit")

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
                cli_s=calls, windows=windows, numpy_window_s=numpy_s, cache_key=key)


# ---- phase 15 --------------------------------------------------------------

# The decoder over an unquantized encoder and grouped-query attention, at
# the configs' full width, random weights from seeds; only batch counts are
# cut. (a) configs/encoder_random_no_quantization_config.py's encoder (GRU
# 512 x 2, no quantizer, MLP upscaler to 32), trained by the encoder CLI,
# under configs/decoder_relative_AC_D_C_random_noQuantization.py's flagship
# (d_model 512, 3 + 3 layers, 8 heads, FF 1024, dropout 0.2), over z: no K1.
# The encoder is trained first, as a user does, because an untrained one
# gives nearly the same z at every position (its spread across positions is
# 3% of its size), which leaves the decoder's encoder stack nothing to
# attend to. (b) n_head_kv 4 of 8 heads (scripts/measure_gqa_quality.py's
# n_head / 2 arm) in phase 7's flagship, configs/prior_config.py's prior and
# configs/decoder_random.py's absolute decoder: k and v expanded to 8 heads
# before K2 / K3-fwd, K4 and K6, the caches kept at 4 heads. (c) the hooks,
# VQCPCB_PROFILE_DIR and VQCPCB_DEBUG_NANS, on CLI calls. The CLI calls run
# in process in build/phase15 on the synthetic corpus (the 'bach' corpus of
# the configs needs music21).
GQA_KV_HEADS = 4
GQA_ABSOLUTE_STEPS = 5
GQA_PREFILL_BATCH = 64
P15_ENCODER_BATCHES = 60
P15_CLI_BATCHES = 20
P15_HOOK_BATCHES = 3
# grouped against ungrouped in one stretch of the call: chunks of AB_REPS
# synced runs in the order A, B, B, A, repeated AB_ROUNDS times
AB_ROUNDS = 2
AB_REPS = 5
STEP_LAUNCHES["unquantized"] = {"relbias_attention_fwd": 6,
                                "relbias_attention_bwd": 6}
STEP_LAUNCHES["gqa_flagship"] = STEP_LAUNCHES["flagship"]
STEP_LAUNCHES["gqa_absolute"] = STEP_LAUNCHES["absolute"]
STEP_LAUNCHES["gqa_prior"] = STEP_LAUNCHES["prior"]
# the CLI calls and the kernels each must launch (the unquantized encoder
# launches none; -l -r over z raises at the first window's source
# embedding, where the JAX CLI fails, before any)
P15_KERNELS = {
    "unquantized encoder -t": (),
    "unquantized -t": ("relbias_attention_fwd", "relbias_attention_bwd"),
    "unquantized -l --num_examples 1": ("relbias_attention_fwd",),
    "unquantized -l -r": (),
    "gqa decoder -t": ("vq_nearest", "relbias_attention_fwd",
                       "relbias_attention_bwd"),
    "gqa decoder -l --num_examples 1": ("vq_nearest", "relbias_attention_fwd"),
    "gqa prior -t": ("vq_nearest", "relbias_attention_fwd", "relbias_attention_bwd"),
    "gqa prior -l -g": ("relbias_attention_fwd",),
    "unquantized -t (VQCPCB_PROFILE_DIR)": ("relbias_attention_fwd",
                                            "relbias_attention_bwd"),
    "gqa prior -t (VQCPCB_DEBUG_NANS=1)": ("vq_nearest", "relbias_attention_fwd",
                                           "relbias_attention_bwd"),
}
# the port's kernels that the relative decoder's train epoch launches (K2-fwd
# and K2-bwd), by their qualified names in csrc/; the profiler's trace of
# the VQCPCB_PROFILE_DIR call must name every one
TRACED_PORT_KERNELS = ("fwd_mma::fwd_kernel", "bwd_mma::rows_kernel",
                       "bwd_mma::row_term_kernel", "bwd_mma::cols_kernel",
                       "bwd_mma::dqe_kernel", "bwd_mma::table_kernel",
                       "bwd_mma::table_sum_kernel")


def _traced_functions(names) -> set:
    """The qualified function names in a trace's event names: each event's
    first identifier that a template or parameter list follows, so that
    'void bwd_mma::rows_kernel<__nv_bfloat16>(...)' gives
    'bwd_mma::rows_kernel' and no other kernel's name matches it."""
    import re
    pattern = re.compile(r"([A-Za-z_][\w:]*)\s*[<(]")
    return {m.group(1) for n in names for m in pattern.finditer(n)}


def _cache_bytes(caches) -> int:
    """Bytes of a prefill's caches: every layer's k and v, int8 rows and
    their f32 scales."""
    return sum(t.numel() * t.element_size() for layer in caches for cache in layer
               for t in (cache if isinstance(cache, tuple) else (cache,)))


def _p15_serving(label: str, encoder, decoder, templates, vocab, k1: bool) -> dict:
    """One decoder's serving path at batch 512, counted from zero launches:
    the encoder's source for the templates (codes through K1, or z), then
    KV-cached sampling of all 384 positions (T 0.95, top-p 0.8, int8
    caches: one prefill, K3-fwd in the 6 relative layers). Outside it: the
    prefill alone (ms, cache bytes), the kernel route's logits against the
    CPU f32 plain route at batch 8, and greedy f32-cache tokens against the
    teacher-forced argmax."""
    from vqcpcb_tpu_torch.training.decoder_trainer import DecoderGenerator
    generator = DecoderGenerator(encoder, decoder, vocab, CODEBOOK_SIZE, seed=0)
    warm = generator.encode_codes(templates[:8])
    decoder.sample_range(warm, templates[:8], 0, 8, generator.generator,
                         temperature=0.95, top_p=0.8)
    torch.cuda.synchronize()
    reset_counts()
    source, encode_s = synced_seconds(lambda: generator.encode_codes(templates))
    tokens0 = torch.zeros((BATCH, NUM_EVENTS, 4), dtype=torch.int32, device="cuda")
    n_tok = NUM_EVENTS * 4
    sampled, sample_s = synced_seconds(lambda: decoder.sample_range(
        source, tokens0, 0, n_tok, generator.generator, temperature=0.95,
        top_p=0.8))
    main_counts = counts()
    want = {k: 0 for k in main_counts}
    want.update(relbias_attention_fwd=6, vq_nearest=int(k1))
    if main_counts != want:
        raise AssertionError(f"{label} serving launched {main_counts}, not {want}")
    sizes = torch.tensor(vocab.num_tokens_per_channel, device="cuda")
    if not ((sampled >= 0) & (sampled < sizes)).all():
        raise AssertionError(f"{label}: sampled tokens outside the vocabulary")
    tokens_per_s = BATCH * n_tok / sample_s
    with torch.no_grad():
        (caches, _), prefill_s = synced_seconds(lambda: decoder.prefill(
            source, tokens0, torch.int8))
    cache_bytes = _cache_bytes(caches)
    heads = caches[0][0][0].shape[1]
    del caches
    log(f"# [{label}] serving: source {tuple(source.shape)} {source.dtype} in "
        f"{encode_s * 1e3:.3f} ms; sample_range batch {BATCH} x {n_tok} positions "
        f"(T 0.95, top_p 0.8, int8 caches) {sample_s:.4f} s, {tokens_per_s:.1f} "
        f"tokens/s; launches {json.dumps({k: v for k, v in main_counts.items() if v})}; "
        f"prefill alone {prefill_s * 1e3:.3f} ms, caches of {heads} heads, "
        f"{cache_bytes} bytes over {len(decoder.decoder_layers)} layers")
    small, small_source = sampled[:8], source[:8]
    with torch.no_grad():
        kernel = decoder(small_source, small)["weights_per_category"]
        plain = copy.deepcopy(decoder).cpu()(small_source.cpu(), small.cpu())[
            "weights_per_category"]
    scale = max(lg.abs().max().item() for lg in plain)
    err = max((k.cpu() - p).abs().max().item() for k, p in zip(kernel, plain))
    os.environ["VQCPCB_KV_DTYPE"] = "float32"
    try:
        greedy = decoder.sample_range(small_source, tokens0[:8], 0, n_tok,
                                      generator.generator, top_k=1)
    finally:
        del os.environ["VQCPCB_KV_DTYPE"]
    with torch.no_grad():
        forced = decoder(small_source, greedy)["weights_per_category"]
    rate = (torch.stack([lg.argmax(-1) for lg in forced], -1)
            == greedy.long()).float().mean().item()
    log(f"# [{label}] logits at batch 8, kernel route vs CPU f32 plain route: max "
        f"abs err {err:.4e}, max |logit| {scale:.3f} (tolerance {LOGITS_RTOL} * max "
        f"|logit|); greedy f32-cache tokens vs teacher-forced argmax "
        f"{rate * 100:.3f}% agree (need >= 99%)")
    if not (err <= LOGITS_RTOL * scale and rate >= 0.99):
        raise AssertionError(f"{label}: kernel-route logits or greedy tokens")
    return dict(launches=main_counts, tokens_per_s=tokens_per_s, encode_ms=encode_s * 1e3,
                prefill_ms=prefill_s * 1e3, cache_bytes=cache_bytes,
                logits_err=err, greedy_agreement=rate, source=source)


def _p15_training(label: str, step_kind: str, trainer, batches, steps: int,
                  must_fall: bool) -> dict:
    """`steps` synced DecoderTrainer steps at batch 32 (bf16 layers, dropout
    0.2), counted from zero launches (train_steps), then the kernel route's
    loss and gradients against the CPU f32 plain route at batch 2, dropout
    0, the CPU route on the card's source (codes or z)."""
    result = train_steps(trainer, batches, steps, step_kind, must_fall=must_fall)
    dec = trainer.decoder
    set_dropout(dec, 0.0)
    small = batches[0][:2]
    source = trainer.encode_codes(small)
    kernel = loss_and_grads(dec, source, small, bf16=True)
    plain = loss_and_grads(copy.deepcopy(dec).cpu(), source.cpu(), small.cpu(),
                           bf16=False)
    loss_err, worst_cos, _ = compare_routes(
        f"[{label}] batch 2, dropout 0, kernel route vs CPU f32 plain route",
        kernel, plain)
    return dict(result, loss_err=loss_err, worst_cos=worst_cos)


def _alternate(fns: dict, reps: int) -> dict:
    """The two callables of `fns` (name -> fn), each run `reps` times a
    chunk, synced one by one, chunks in the order A, B, B, A, AB_ROUNDS
    times: the median seconds of each."""
    a, b = fns
    times = {a: [], b: []}
    for name in (a, b, b, a) * AB_ROUNDS:
        for _ in range(reps):
            times[name].append(synced_seconds(fns[name])[1])
    return {name: float(np.median(t)) for name, t in times.items()}


def _expansion_ms(trainer, x, step_device_ms: float) -> dict:
    """What expanding k and v costs a grouped flagship train step, read from
    the step: expand_kv_heads is wrapped for one train step to record the
    shape of every k and v it expands (the decoder's self-attentions over
    384 positions, the encoder's and the cross-attentions' over the 24
    codes); each shape is then expanded to 8 heads and its gradient summed
    back (forward and backward) and timed by device time, and the times are
    summed over the step's calls; beside the bytes they move and the grouped
    step's device time."""
    from collections import Counter
    from vqcpcb_tpu_torch.ops import attention
    expand = attention.expand_kv_heads
    calls = Counter()

    def recording(t, num_kv_heads, g):
        calls[(tuple(t.shape), t.dtype, num_kv_heads, g)] += 1
        return expand(t, num_kv_heads, g)
    attention.expand_kv_heads = recording
    try:
        trainer.train_step(x)
    finally:
        attention.expand_kv_heads = expand
    torch.cuda.synchronize()
    if not calls:
        raise AssertionError("the grouped train step expanded no k or v")
    per_step, moved, shapes = 0.0, 0, []
    for (shape, dtype, kv_heads, g), n in sorted(calls.items(), key=str):
        src = torch.randn(shape, device="cuda", dtype=dtype, requires_grad=True)
        grad = torch.randn_like(expand(src.detach(), kv_heads, g))

        def run():
            expand(src, kv_heads, g).backward(grad)
        ms = device_ms(run, 20)
        per_step += ms * n
        moved += n * 2 * (src.numel() * src.element_size()
                          + grad.numel() * grad.element_size())
        shapes.append(dict(shape=list(shape), dtype=str(dtype), calls=n,
                           device_ms=ms))
        log(f"# [gqa] expansion of k or v {shape} {dtype} ({kv_heads} heads -> "
            f"{kv_heads * g}), forward and backward: device {ms:.4f} ms, "
            f"{n} calls a step")
    log(f"# [gqa] expansion in one grouped flagship train step: "
        f"{sum(calls.values())} calls, {per_step:.4f} ms of device time "
        f"({moved} bytes, {moved / HBM_BYTES_PER_S * 1e3:.4f} ms at the HBM "
        f"rate), {per_step / step_device_ms * 100:.2f}% of the grouped step's "
        f"device time")
    return dict(shapes=shapes, expand_device_ms_per_step=per_step,
                expand_bytes_per_step=moved,
                expand_share=per_step / step_device_ms)


class _P15Work:
    """build/phase15: config copies on the synthetic corpus (each file's
    savename its name) and the CLI calls in process, each call's launches
    and seconds recorded."""

    def __init__(self):
        import shutil
        from vqcpcb_tpu_torch.utils import load_config_module
        self.root = os.path.dirname(os.path.abspath(__file__))
        self.path = os.path.join(self.root, "build", "phase15")
        shutil.rmtree(self.path, ignore_errors=True)
        os.makedirs(os.path.join(self.path, "configs"))
        self.corpus = load_config_module(os.path.join(
            self.root, "configs", "decoder_synthetic.py"))["corpus_kwargs"]
        self.per_call, self.calls = {}, {}

    def config(self, name: str, **changes) -> dict:
        """configs/{name} on the synthetic corpus, with `changes`."""
        from vqcpcb_tpu_torch.utils import load_config_module
        return dict(load_config_module(os.path.join(self.root, "configs", name)),
                    dataset="synthetic", corpus_kwargs=self.corpus, **changes)

    def write(self, name: str, config: dict) -> str:
        path = os.path.join(self.path, "configs", f"{name}.py")
        with open(path, "w") as f:
            f.write(f'"""chip_smoke.py phase 15: {name}."""\n'
                    f"config = {dict(config, savename=name)!r}\n")
        return path

    def model_dir(self, name: str) -> str:
        import glob
        (path,) = glob.glob(os.path.join(self.path, "models", f"{name}_*"))
        return path

    def run(self, label, cli, argv, env=None, raises=None) -> None:
        """cli.main(argv) in the working directory with `env` set; with
        raises = (exception type, text), the call must raise it."""
        before = counts()
        saved = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        cwd = os.getcwd()
        os.chdir(self.path)
        t0 = time.perf_counter()
        try:
            if raises is None:
                outcome = f"exit {cli.main(argv)}"
            else:
                try:
                    cli.main(argv)
                except raises[0] as exc:
                    if raises[1] not in str(exc):
                        raise
                    outcome = f"raised {type(exc).__name__}: {exc}"
                else:
                    raise AssertionError(f"{label} did not raise {raises}")
            torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
            for k, v in saved.items():
                if v is None:
                    del os.environ[k]
                else:
                    os.environ[k] = v
            # the CLIs set the NaN checks from the variable: off again
            from vqcpcb_tpu_torch.training.profiling import enable_debug_checks
            enable_debug_checks()
        self.calls[label] = time.perf_counter() - t0
        self.per_call[label] = _delta(counts(), before)
        log(f"# [p15 entry] {label}: {outcome} in {self.calls[label]:.2f} s, launches "
            f"{json.dumps({k: v for k, v in self.per_call[label].items() if v})}")
        if raises is None and outcome != "exit 0":
            raise AssertionError(f"{label}: {outcome}")
        kernels = P15_KERNELS[label]
        missing = [k for k in kernels if not self.per_call[label][k]]
        others = [k for k, c in self.per_call[label].items() if c and k not in kernels]
        if missing or others:
            raise AssertionError(f"{label}: launched {self.per_call[label]}: missing "
                                 f"{missing}, unexpected {others}")


def _p15_generations(model_dir: str, want: int) -> None:
    import glob
    written = glob.glob(os.path.join(model_dir, "generations", "*.mid"))
    if len(written) != want:
        raise AssertionError(f"{model_dir}: {len(written)} generated scores, not {want}")


def _p15_unquantized(gen, card: str, work: _P15Work) -> dict:
    """(a) the CLIs, counted from zero launches: encoder -t on the
    unquantized config, decoder -t over it, -l --num_examples 1, -l -r
    (which must raise the port's error at the first window, as JAX's CLI
    fails there); then, at full width over that trained encoder and the
    config's data, serving at batch 512 over z and 30 train steps at batch
    32, each with its routes."""
    from vqcpcb_tpu_torch import getters, main_decoder, main_encoder
    from vqcpcb_tpu_torch.training.decoder_trainer import DecoderTrainer
    encoder_path = work.write("encoder_no_quantization_synthetic",
                              work.config("encoder_random_no_quantization_config.py"))
    reset_counts()
    work.run("unquantized encoder -t", main_encoder,
             ["-t", "-c", encoder_path, "--num_epochs", "1", "--num_batches",
              str(P15_ENCODER_BATCHES)])
    encoder_config = os.path.join(work.model_dir("encoder_no_quantization_synthetic"),
                                  "config.py")
    config = work.config("decoder_relative_AC_D_C_random_noQuantization.py",
                         config_encoder=encoder_config)
    work.write("decoder_nq_hooks", config)
    work.run("unquantized -t", main_decoder,
             ["-t", "-c", work.write("decoder_nq_synthetic", config),
              "--num_epochs", "1", "--num_batches", str(P15_CLI_BATCHES)])
    model_dir = work.model_dir("decoder_nq_synthetic")
    loaded = os.path.join(model_dir, "config.py")
    work.run("unquantized -l --num_examples 1", main_decoder,
             ["-l", "--num_examples", "1", "-c", loaded])
    work.run("unquantized -l -r", main_decoder, ["-l", "-r", "-c", loaded],
             raises=(ValueError, "feature axis"))
    cli_counts = counts()
    rows = _check_model_dir(model_dir, 1)
    _p15_generations(model_dir, 6)

    # full width, the trained encoder, fresh decoder weights from seed 0
    encoder, encoder_cfg = main_decoder.load_encoder_stack(config)
    data = getters.get_dataloader_generator(
        config["dataset"], config["training_method"],
        config["dataloader_generator_kwargs"], config)
    torch.manual_seed(0)
    decoder = getters.get_decoder(
        data, getters.get_data_processor(data, config["data_processor_type"],
                                         config["data_processor_kwargs"]),
        encoder, encoder_cfg, config["decoder_type"], config["decoder_kwargs"])
    if decoder.source_embeddings.in_features != 32:
        raise AssertionError(f"the source Linear {decoder.source_embeddings}")
    vocab = data.dataset.vocabulary
    rows_x, loader = [], data.dataloaders(batch_size=TRAIN_BATCH)[0]
    while sum(len(x) for x in rows_x) < BATCH:
        for batch in loader:
            rows_x.append(torch.as_tensor(batch["x"], device="cuda"))
        loader = data.dataloaders(batch_size=TRAIN_BATCH)[0]
    batches = rows_x[:4]
    templates = torch.cat(rows_x)[:BATCH]
    serving = _p15_serving("unquantized", encoder, decoder, templates, vocab,
                           k1=False)
    z = serving.pop("source")
    spread = (z.std(1).mean() / z.std()).item()
    if z.dtype != torch.float32 or z.shape != (BATCH, NUM_CODES, 32):
        raise AssertionError(f"z {z.shape} {z.dtype}")
    log(f"# [unquantized] {card}: z (B, 24, 32) f32 from the trained encoder, its "
        f"spread across positions {spread:.4f} of its size; the CLI's epoch "
        f"{rows[0]['tokens_per_sec/train']:.1f} tokens/s ({P15_CLI_BATCHES} "
        f"batches at 64)")
    trainer = DecoderTrainer(encoder, decoder, CODEBOOK_SIZE, seed=0)
    trainer.init_state(lr=1e-4)               # the config's lr, no schedule
    for x in batches[:2]:                     # warm-up: cuBLAS plans, caches
        trainer.train_step(x)
    torch.cuda.synchronize()
    training = _p15_training("unquantized", "unquantized", trainer, batches,
                             TRAIN_STEPS, True)
    return dict(cli_launches=cli_counts, serving=serving, training=training,
                spread=spread, cli_tokens_per_s=rows[0]["tokens_per_sec/train"])


def _p15_grouped(gen, card: str, ungrouped: dict) -> dict:
    """(b) at n_head_kv 4: the flagship's serving beside phase 7's and its
    KV-cache bytes beside the ungrouped decoder's, 30 train steps beside
    phase 8's, the expansion's cost, the routes; the absolute decoder's 5
    steps (K6) and one prefill at batch 64 (K4), each held against the
    plain route; the prior's 30 steps, routes, sampling beside phase 12 (c)
    and greedy codes against the teacher-forced argmax."""
    vocab = synthetic_vocabulary()
    out = {}
    encoder, decoder = build_models(vocab, n_head_kv=GQA_KV_HEADS)
    templates = random_templates(vocab, gen, BATCH, NUM_EVENTS)
    encoder = encoder.cuda()
    init_codebook(encoder, templates, gen)
    out["serving"] = _p15_serving("gqa flagship", encoder, decoder.cuda(), templates,
                                  vocab, k1=True)
    codes = out["serving"].pop("source")
    _, ungrouped_decoder = build_models(vocab)
    with torch.no_grad():
        caches, _ = ungrouped_decoder.cuda().eval().prefill(
            codes, torch.zeros((BATCH, NUM_EVENTS, 4), dtype=torch.int32,
                               device="cuda"), torch.int8)
    out["ungrouped_cache_bytes"] = _cache_bytes(caches)
    del caches, ungrouped_decoder, encoder, decoder
    log(f"# [gqa] {card}: serving {out['serving']['tokens_per_s']:.1f} tokens/s "
        f"grouped vs {ungrouped['serving_tokens_per_s']:.1f} ungrouped (phase 7, this "
        f"call); prefill {out['serving']['prefill_ms']:.3f} vs "
        f"{ungrouped['serving_prefill_ms']:.3f} ms; int8 KV caches at batch {BATCH}: "
        f"{out['serving']['cache_bytes']} bytes grouped vs "
        f"{out['ungrouped_cache_bytes']} ungrouped "
        f"({out['serving']['cache_bytes'] / out['ungrouped_cache_bytes']:.4f}x)")
    trainer, batches = _trainer(gen, "flagship", n_head_kv=GQA_KV_HEADS)
    out["training"] = _p15_training("gqa flagship", "gqa_flagship", trainer, batches,
                                    TRAIN_STEPS, True)
    # the ungrouped flagship beside it, in turns: median ms/step and the
    # device time of a step
    twin, twin_batches = _trainer(gen, "flagship")
    set_dropout(trainer.decoder, TRAIN_DROPOUT)       # the routes set it to 0
    step = iter(range(10 ** 6))
    ab = _alternate({
        "ungrouped": lambda: twin.train_step(twin_batches[next(step) % 4]),
        "grouped": lambda: trainer.train_step(batches[next(step) % 4])}, AB_REPS)
    dev = {"ungrouped": device_ms(lambda: twin.train_step(twin_batches[0]), 3),
           "grouped": device_ms(lambda: trainer.train_step(batches[0]), 3)}
    out["training_ab"] = dict(ms={k: v * 1e3 for k, v in ab.items()}, device_ms=dev)
    log(f"# [gqa] {card}: flagship train step {out['training']['step_ms']:.3f} ms "
        f"grouped vs {ungrouped['train_ms']:.3f} ungrouped (phase 8, this call); in "
        f"turns here (A, B, B, A x {AB_ROUNDS}, {AB_REPS} steps a chunk): median "
        f"{ab['grouped'] * 1e3:.3f} grouped vs {ab['ungrouped'] * 1e3:.3f} "
        f"ungrouped ms/step ({(ab['grouped'] / ab['ungrouped'] - 1) * 100:+.1f}%); "
        f"device time a step {dev['grouped']:.3f} vs {dev['ungrouped']:.3f} ms "
        f"({(dev['grouped'] / dev['ungrouped'] - 1) * 100:+.1f}%)")
    out["expansion"] = _expansion_ms(trainer, batches[0], dev["grouped"])
    del trainer, batches, twin, twin_batches
    torch.cuda.empty_cache()

    # the absolute decoder: 5 steps (K6), one prefill at batch 64 (K4)
    trainer, batches = _trainer(gen, "absolute", n_head_kv=GQA_KV_HEADS)
    out["absolute"] = _p15_training("gqa absolute", "gqa_absolute", trainer,
                                    batches, GQA_ABSOLUTE_STEPS, False)
    dec = trainer.decoder.eval()
    x = torch.cat(batches)[:GQA_PREFILL_BATCH]
    codes = trainer.encode_codes(x)
    reset_counts()
    with torch.no_grad():
        (caches, _), prefill_s = synced_seconds(lambda: dec.prefill(codes, x,
                                                                    torch.int8))
    out["absolute_prefill_launches"] = counts()
    want = {k: 9 if k == "fused_attention" else 0
            for k in out["absolute_prefill_launches"]}
    if (out["absolute_prefill_launches"] != want
            or caches[0][0][0].shape[1] != GQA_KV_HEADS):
        raise AssertionError(f"grouped absolute prefill launched "
                             f"{out['absolute_prefill_launches']}")
    with torch.no_grad():
        kernel = dec(codes[:8], x[:8])["weights_per_category"]
        plain = copy.deepcopy(dec).cpu()(codes[:8].cpu(), x[:8].cpu())[
            "weights_per_category"]
    scale = max(lg.abs().max().item() for lg in plain)
    err = max((k.cpu() - p).abs().max().item() for k, p in zip(kernel, plain))
    out["absolute"].update(prefill_ms=prefill_s * 1e3, logits_err=err)
    log(f"# [gqa absolute] {card}: prefill at batch {GQA_PREFILL_BATCH} "
        f"{prefill_s * 1e3:.3f} ms, K4 9 launches, caches of {GQA_KV_HEADS} heads; "
        f"logits at batch 8 (K4), kernel route vs CPU f32 plain route: max abs err "
        f"{err:.4e}, max |logit| {scale:.3f} (tolerance {LOGITS_RTOL} * max |logit|)")
    if not err <= LOGITS_RTOL * scale:
        raise AssertionError(f"grouped absolute logits differ by {err}")
    del trainer, batches, dec, caches
    torch.cuda.empty_cache()

    # the prior
    trainer, batches = prior_at_full_width(gen, n_head_kv=GQA_KV_HEADS)
    warm = [trainer.train_step(batches[i % 4]) for i in range(PRIOR_WARMUP)]
    torch.cuda.synchronize()
    warm = [{k: v.item() for k, v in m.items()} for m in warm]
    out["prior_launches"], step_s, synced = student_steps(
        trainer, batches, PRIOR_SYNCED, "gqa_prior")
    losses = [m["loss"] for m in warm + synced]
    prior_ms = float(np.median(step_s)) * 1e3
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"the grouped prior's loss did not fall: {losses}")
    prior = trainer.prior
    set_dropout(prior, 0.0)
    codes = trainer.encode_codes(batches[0][:PRIOR_ROUTE_BATCH])
    kernel = prior_loss_and_grads(prior, codes)
    plain = prior_loss_and_grads(copy.deepcopy(prior).cpu(), codes.cpu())
    loss_err, worst_cos, _ = compare_routes(
        f"[gqa prior] batch {PRIOR_ROUTE_BATCH}, dropout 0, kernel route vs CPU f32 "
        "plain route", kernel, plain)
    prior.eval()
    reset_counts()
    sampled, sample_s = synced_seconds(lambda: trainer.generate_codes(
        PRIOR_SAMPLE_CODES, num_generated_codes=PRIOR_SAMPLE_BATCH))
    out["prior_sampling_launches"] = counts()
    windows = 1 + (PRIOR_SAMPLE_CODES - PRIOR_CODES) // (PRIOR_CODES // 2)
    want = {k: 6 * (windows - 1) if k == "relbias_attention_fwd" else 0
            for k in out["prior_sampling_launches"]}
    if out["prior_sampling_launches"] != want or not (
            (sampled >= 0) & (sampled < CODEBOOK_SIZE)).all():
        raise AssertionError(f"grouped generate_codes launched "
                             f"{out['prior_sampling_launches']}")
    codes_per_s = PRIOR_SAMPLE_BATCH * PRIOR_SAMPLE_CODES / sample_s
    os.environ["VQCPCB_KV_DTYPE"] = "float32"
    try:
        greedy = prior.sample_window(
            torch.zeros((PRIOR_SAMPLE_BATCH, PRIOR_CODES), dtype=torch.long,
                        device="cuda"), 0, PRIOR_CODES, trainer.generator, top_k=1)
    finally:
        del os.environ["VQCPCB_KV_DTYPE"]
    with torch.no_grad():
        agreement = (prior.logits(greedy).argmax(-1) == greedy).float().mean().item()
    # the ungrouped prior beside it, in turns: train steps and sampling
    twin, twin_batches = prior_at_full_width(gen)
    for i in range(PRIOR_WARMUP):
        twin.train_step(twin_batches[i % 4])
    set_dropout(prior, prior_config(os.path.dirname(os.path.abspath(__file__)))[
        "prior_kwargs"]["dropout"])                   # the routes set it to 0
    step = iter(range(10 ** 6))
    ab_train = _alternate({
        "ungrouped": lambda: twin.train_step(twin_batches[next(step) % 4]),
        "grouped": lambda: trainer.train_step(batches[next(step) % 4])}, AB_REPS)
    ab_sample = _alternate({
        name: (lambda t=t: t.generate_codes(PRIOR_SAMPLE_CODES,
                                            num_generated_codes=PRIOR_SAMPLE_BATCH))
        for name, t in (("ungrouped", twin), ("grouped", trainer))}, 1)
    ab_codes = {k: PRIOR_SAMPLE_BATCH * PRIOR_SAMPLE_CODES / v
                for k, v in ab_sample.items()}
    log(f"# [gqa prior] {card}: in turns (A, B, B, A x {AB_ROUNDS}): train step "
        f"median {ab_train['grouped'] * 1e3:.3f} grouped vs "
        f"{ab_train['ungrouped'] * 1e3:.3f} ungrouped ms "
        f"({(ab_train['grouped'] / ab_train['ungrouped'] - 1) * 100:+.1f}%); "
        f"generate_codes {PRIOR_SAMPLE_BATCH} x {PRIOR_SAMPLE_CODES} "
        f"{ab_codes['grouped']:.1f} grouped vs {ab_codes['ungrouped']:.1f} ungrouped "
        f"codes/s ({(ab_codes['grouped'] / ab_codes['ungrouped'] - 1) * 100:+.1f}%)")
    out["prior"] = dict(step_ms=prior_ms, codes_per_s=codes_per_s, loss_err=loss_err,
                        worst_cos=worst_cos, greedy_agreement=agreement,
                        tokens_per_s=PRIOR_BATCH * NUM_EVENTS * 4 / (prior_ms / 1e3),
                        ab_step_ms={k: v * 1e3 for k, v in ab_train.items()},
                        ab_codes_per_s=ab_codes)
    del twin, twin_batches
    log(f"# [gqa prior] {card}: {prior_ms:.3f} ms/step grouped vs "
        f"{ungrouped['prior_train_ms']:.3f} ungrouped (phase 12, this call), "
        f"{out['prior']['tokens_per_s']:.1f} tokens/s; loss "
        f"{np.mean(losses[:5]):.4f} -> {np.mean(losses[-5:]):.4f}; generate_codes "
        f"{PRIOR_SAMPLE_BATCH} x {PRIOR_SAMPLE_CODES} codes {sample_s:.4f} s, "
        f"{codes_per_s:.1f} codes/s grouped vs {ungrouped['prior_codes_per_s']:.1f} "
        f"ungrouped (phase 12 (c), this call); greedy f32-cache codes vs "
        f"teacher-forced argmax {agreement * 100:.3f}% agree (need >= 99%)")
    if agreement < 0.99:
        raise AssertionError(f"grouped prior greedy agreement {agreement}")
    del trainer, prior, batches
    torch.cuda.empty_cache()
    return out


def _p15_grouped_cli(work: _P15Work, encoder_config: str) -> dict:
    """(b) the CLIs on grouped copies, counted from zero launches: the
    flagship decoder (configs/decoder_synthetic.py at n_head_kv 4) -t over
    `encoder_config` and -l --num_examples 1, the prior
    (configs/prior_config.py at n_head_kv 4) -t and -l -g through that
    decoder; then the checks."""
    from vqcpcb_tpu_torch import main_decoder, main_prior
    config = work.config("decoder_synthetic.py", config_encoder=encoder_config)
    config["decoder_kwargs"] = dict(config["decoder_kwargs"], n_head_kv=GQA_KV_HEADS)
    reset_counts()
    work.run("gqa decoder -t", main_decoder,
             ["-t", "-c", work.write("decoder_gqa_synthetic", config),
              "--num_epochs", "1", "--num_batches", str(P15_CLI_BATCHES)])
    decoder_dir = work.model_dir("decoder_gqa_synthetic")
    decoder_config = os.path.join(decoder_dir, "config.py")
    work.run("gqa decoder -l --num_examples 1", main_decoder,
             ["-l", "--num_examples", "1", "-c", decoder_config])
    prior = dict(prior_config(work.root), config_encoder=encoder_config,
                 config_decoder=decoder_config, num_epochs=1,
                 num_batches=P15_CLI_BATCHES)
    prior["prior_kwargs"] = dict(prior["prior_kwargs"], n_head_kv=GQA_KV_HEADS)
    work.run("gqa prior -t", main_prior,
             ["-t", "-c", work.write("prior_gqa_synthetic", prior)])
    prior_dir = work.model_dir("prior_gqa_synthetic")
    work.run("gqa prior -l -g", main_prior,
             ["-l", "-g", "-c", os.path.join(prior_dir, "config.py")])
    cli_counts = counts()
    rows = {"gqa decoder": _check_model_dir(decoder_dir, 1),
            "gqa prior": _check_model_dir(prior_dir, 1)}
    _p15_generations(decoder_dir, 6)
    _p15_generations(prior_dir, 1)
    return dict(cli_launches=cli_counts, prior=prior,
                tokens_per_s={k: r[0]["tokens_per_sec/train"] for k, r in rows.items()})


def _p15_hooks(work: _P15Work, card: str, prior: dict) -> dict:
    """(c) the unquantized decoder -t with VQCPCB_PROFILE_DIR (a non-empty
    Chrome trace of the train epoch that names a port kernel) and the grouped
    prior -t with VQCPCB_DEBUG_NANS=1 (exit 0), counted from zero
    launches."""
    import glob
    from vqcpcb_tpu_torch import main_decoder, main_prior
    reset_counts()
    for attempt in range(1, PROFILER_TRIES + 1):
        traces = os.path.join(work.path, f"traces_{attempt}")
        work.run("unquantized -t (VQCPCB_PROFILE_DIR)", main_decoder,
                 ["-t", "-c", os.path.join(work.path, "configs", "decoder_nq_hooks.py"),
                  "--num_epochs", "1", "--num_batches", str(P15_HOOK_BATCHES)],
                 env={"VQCPCB_PROFILE_DIR": traces})
        files = glob.glob(os.path.join(traces, "epoch_0_train.*.pt.trace.json"))
        if len(files) != 1 or not os.path.getsize(files[0]):
            raise AssertionError(f"VQCPCB_PROFILE_DIR: trace files {files}")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        # a trace without a single device kernel is the profiler's empty
        # session (see PROFILER_TRIES), not a port fault: the call runs again
        if any(e.get("cat") == "kernel" for e in events):
            break
        log(f"# [p15 hooks] trace {attempt} of {PROFILER_TRIES} holds no device "
            "kernel event")
    else:
        raise AssertionError(f"{PROFILER_TRIES} VQCPCB_PROFILE_DIR traces hold no "
                             "device kernel event")
    work.run("gqa prior -t (VQCPCB_DEBUG_NANS=1)", main_prior,
             ["-t", "-c", work.write("prior_gqa_debug_nans",
                                     dict(prior, num_batches=P15_HOOK_BATCHES))],
             env={"VQCPCB_DEBUG_NANS": "1"})
    cli_counts = counts()
    names = {str(e.get("name")) for e in events}
    functions = _traced_functions(names)
    named = sorted(set(TRACED_PORT_KERNELS) & functions)
    log(f"# [p15 hooks] {card}: the VQCPCB_PROFILE_DIR trace "
        f"{os.path.basename(files[0])}: {os.path.getsize(files[0])} bytes, "
        f"{len(names)} event names, port kernels named {named}; the "
        f"VQCPCB_DEBUG_NANS=1 call exited 0 in "
        f"{work.calls['gqa prior -t (VQCPCB_DEBUG_NANS=1)']:.2f} s")
    missing = sorted(set(TRACED_PORT_KERNELS) - functions)
    if missing:
        raise AssertionError(
            f"the profiler's trace names no {missing}; its kernel-like names: "
            f"{sorted(f for f in functions if 'kernel' in f)}")
    return dict(cli_launches=cli_counts, trace_kernels=named,
                trace_bytes=os.path.getsize(files[0]))


def phase_unquantized_and_grouped(gen: torch.Generator, card: str,
                                  encoder_config: str, ungrouped: dict) -> dict:
    """(a) the unquantized flagship (_p15_unquantized), (b) grouped-query
    attention (_p15_grouped, _p15_grouped_cli over `encoder_config`, phase
    11's trained encoder), (c) the hooks (_p15_hooks); `ungrouped` holds
    phases 7, 8 and 12's numbers of this call, logged beside (b)'s. Returns
    the counted main paths' launches by path."""
    t0 = time.perf_counter()
    work = _P15Work()
    nq = _p15_unquantized(gen, card, work)
    gqa = _p15_grouped(gen, card, ungrouped)
    gqa_cli = _p15_grouped_cli(work, encoder_config)
    hooks = _p15_hooks(work, card, gqa_cli["prior"])
    launches = {"p15_unquantized_cli": nq["cli_launches"],
                "p15_unquantized_serving": nq["serving"].pop("launches"),
                "p15_unquantized_training": nq["training"].pop("launches"),
                "p15_gqa_serving": gqa["serving"].pop("launches"),
                "p15_gqa_training": gqa["training"].pop("launches"),
                "p15_gqa_absolute_training": gqa["absolute"].pop("launches"),
                "p15_gqa_absolute_prefill": gqa["absolute_prefill_launches"],
                "p15_gqa_prior_training": gqa["prior_launches"],
                "p15_gqa_prior_sampling": gqa["prior_sampling_launches"],
                "p15_gqa_cli": gqa_cli["cli_launches"],
                "p15_hooks_cli": hooks["cli_launches"]}
    for result in (nq["training"], gqa["training"], gqa["absolute"]):
        result.pop("losses", None)
    log(f"# [p15] {card}: " + json.dumps(dict(
        unquantized=dict(serving=nq["serving"], training=nq["training"],
                         z_spread=nq["spread"],
                         cli_tokens_per_s=nq["cli_tokens_per_s"]),
        gqa=dict(serving=gqa["serving"], ungrouped_cache_bytes=gqa[
            "ungrouped_cache_bytes"], training=gqa["training"],
                 training_ab=gqa["training_ab"], expansion=gqa["expansion"],
                 absolute=gqa["absolute"], prior=gqa["prior"],
                 cli_tokens_per_s=gqa_cli["tokens_per_s"]),
        ungrouped=ungrouped, hooks=dict(trace_kernels=hooks["trace_kernels"],
                                        trace_bytes=hooks["trace_bytes"]),
        cli_s=work.calls, phase_s=time.perf_counter() - t0)))
    return dict(launches=launches)


# ---- phase 16 --------------------------------------------------------------

# Reference (PyTorch VQCPCB) checkpoints migrated into the port, at full
# width, the reference files written from seeded random weights of the
# port's modules (which keep the reference's names; the CPU tests hold that
# layout against what the JAX importer reads): the flagship pipeline's
# encoder (configs/encoder_random_synthetic.py: GRU 512 x 2, codebook 32 x
# 3; both slots, four files each), its decoder (configs/decoder_synthetic.py:
# relative AC/D/C, d_model 512, 3 + 3 layers, 8 heads; one whole `decoder`
# file with the `encoder.*` entries, both slots), a prior at
# configs/prior_config.py's width (one slot) and the flat layout of a
# transformer-downscaler encoder (configs/encoder_random_transfo_config.py
# on the synthetic corpus: d_model 512, [4, 4] layers, codebook 32 x 3). The
# codebooks are drawn from the encoders' latents, so the codes spread.
# Everything runs in build/phase16; the CLIs in process.
P16_TRAIN_BATCHES = 10
P16_EVAL_ROWS = 16
P16_INIT_ROWS = 16
# the CLI calls over the migrated directories and the kernels each must
# launch (-l -g decodes sampled codes: nothing is encoded)
P16_KERNELS = {
    "migrated decoder -l -r": ("vq_nearest", "relbias_attention_fwd"),
    "migrated decoder -l --num_examples 1": ("vq_nearest", "relbias_attention_fwd"),
    "migrated prior -l -g": ("relbias_attention_fwd",),
    "migrated decoder -t -l": ("vq_nearest", "relbias_attention_fwd",
                               "relbias_attention_bwd"),
}
ENCODER_FILES = ("data_processor", "downscaler", "quantizer", "upscaler")
# The transformer downscaler's K3-fwd rounds q, k, v, the bias table and
# its f32 softmax weights to bf16 before the products. Its plain version
# sums the f32 score chains in another order, so now and then a weight
# lands on the other side of a bf16 rounding step, and over 8 layers z
# moves by up to a bf16 step: its codes cannot be held bit for bit (on an
# H100, 38 of 12,288 rows differ from the CPU plain route's). Its z is held
# within P16_Z_RTOL (bf16's relative step) of max |z| of the CPU plain
# route's, and its codes equal on every row that no such error can move.
P16_Z_RTOL = 2.0 ** -8


def _reference_files(kind: str, sd: dict, encoder_sd=None) -> dict:
    """A port module's state_dict as the reference saves it: an encoder as
    four per-module files, a decoder as one file carrying the frozen
    encoder's entries under `encoder.`, a prior with its head as
    pre_softmaxes.0."""
    if kind == "encoder":
        return {name: {k[len(name) + 1:]: v for k, v in sd.items()
                       if k.startswith(f"{name}.")} for name in ENCODER_FILES}
    if kind == "decoder":
        return {"decoder": {**sd, **{f"encoder.{k}": v for k, v in encoder_sd.items()}}}
    return {"prior": {k.replace("pre_softmax.", "pre_softmaxes.0.", 1): v
                      for k, v in sd.items()}}


def _write_reference(path: str, config: dict, files: dict, slots) -> None:
    """config.py and the files under path/{slot}/ for each slot, or in path
    itself (slots None: the pre-slot layout)."""
    for slot in slots or [None]:
        slot_path = path if slot is None else os.path.join(path, slot)
        os.makedirs(slot_path, exist_ok=True)
        for name, sd in files.items():
            torch.save(sd, os.path.join(slot_path, name))
    with open(os.path.join(path, "config.py"), "w") as f:
        f.write('"""chip_smoke.py phase 16: a reference model directory."""\n'
                f"config = {config!r}\n")


def _spread_codebook(encoder, x) -> None:
    """The codebook from distinct latents of x (the data-dependent init)."""
    with torch.no_grad():
        z = encoder.downscale(x, training=False).reshape(-1, 3).unique(dim=0)
        pick = torch.randperm(len(z), generator=torch.Generator().manual_seed(16))
        encoder.quantizer.set_codebooks(z[pick[:CODEBOOK_SIZE]][None])


def _attend_plain(self, q, k, v, attn_mask=None, need_weights=False):
    """MultiheadAttention.attend's card branch for a relative layer with the
    kernel's plain version in place of the kernel, at its bf16 dots, on the
    CPU or the card (the encoders it serves never ask for weights)."""
    from vqcpcb_tpu_torch.ops.attention import expand_kv_heads
    from vqcpcb_tpu_torch.ops.attention_kernels import relbias_attention_fwd_plain
    k, v = (expand_kv_heads(x, self.num_kv_heads, self.group) for x in (k, v))
    e1, e2 = self.attn_bias.tables()
    out = relbias_attention_fwd_plain(q.float().contiguous(), k.float().contiguous(),
                                      v.float().contiguous(), attn_mask,
                                      e1.contiguous(), e2.contiguous(),
                                      dot_dtype=torch.bfloat16)
    return self._merge_heads(out), None


def _reach(quantizer, z, delta: float) -> tuple:
    """For each row of z: whether a move of z by at most `delta` (in norm)
    could change its nearest codeword, and whether its two nearest lie
    within 1e-6 relative (where two summation orders may differ)."""
    z = z.reshape(-1, z.shape[-1])
    e = quantizer.embeddings[0]
    dist = (z * z).sum(-1, keepdim=True) - 2.0 * z @ e.T + (e * e).sum(-1)
    best = dist.argmin(-1)
    spread = (e[None] - e[best][:, None]).norm(dim=-1)          # |e_j - e_best|
    margin = dist - dist.gather(1, best[:, None]) - 2.0 * spread * delta
    margin.scatter_(1, best[:, None], float("inf"))
    two = dist.topk(2, dim=-1, largest=False).values
    tie = (two[:, 1] - two[:, 0]) <= 1e-6 * two.abs().amax(-1).clamp_min(1.0)
    return (margin <= 0).any(-1), tie


def _hold_codes(label: str, encoder, x, card_codes, card_s: float,
                bf16_attention: bool) -> dict:
    """The card's codes of x against the CPU plain route's (a copy of the
    encoder on the CPU; every relative layer through the kernel's plain
    version at its bf16 dots), bit for bit; with bf16_attention (the
    transformer downscaler), z within P16_Z_RTOL and the codes equal on
    every row that such an error cannot move (P16_Z_RTOL's comment)."""
    from vqcpcb_tpu_torch.ops.attention import MultiheadAttention
    cpu_encoder = copy.deepcopy(encoder).cpu().eval()
    with torch.no_grad():
        z_card = encoder.downscale(x, training=False).cpu()
    attend = MultiheadAttention.attend
    MultiheadAttention.attend = _attend_plain
    try:
        with torch.no_grad():
            t0 = time.perf_counter()
            z = cpu_encoder.downscale(x.cpu(), training=False)
            cpu = cpu_encoder.quantizer(z, training=False)[1]
            cpu_s = time.perf_counter() - t0
    finally:
        MultiheadAttention.attend = attend
    differ = (card_codes.cpu() != cpu).reshape(-1)
    z_err = float((z_card - z).abs().max() / z.abs().max())
    delta = P16_Z_RTOL * float(z.abs().max()) * z.shape[-1] ** 0.5
    movable, tie = _reach(cpu_encoder.quantizer, z, delta)
    result = dict(card_ms=card_s * 1e3, cpu_s=cpu_s, differ=int(differ.sum()),
                  ties=int(tie.sum()), z_err=z_err, distinct=len(cpu.unique()))
    line = (f"# [p16] (b) {label}: codes {tuple(cpu.shape)} at batch {len(x)}, the "
            f"card's in {card_s * 1e3:.3f} ms; the CPU plain route's in {cpu_s:.2f} s: "
            f"{result['differ']} differ; {result['distinct']} distinct codes; "
            f"{result['ties']} rows with their two nearest codewords within 1e-6 "
            f"relative; z max abs err {z_err:.3e} of max |z|")
    if not bf16_attention:
        log(line + " (need 0 differ)")
        if differ.any():
            raise AssertionError(f"{label}: the card's codes differ from the CPU's")
        return result
    result.update(movable=int(movable.sum()),
                  unexplained=int((differ & ~movable).sum()))
    log(line + f" (need <= {P16_Z_RTOL}), {result['movable']} rows that such an "
        f"error can move, {result['unexplained']} differing rows outside them "
        "(need 0)")
    if result["unexplained"] or not z_err <= P16_Z_RTOL:
        raise AssertionError(f"{label}: the card's codes or z differ: {result}")
    return result


def _assert_state_equal(label: str, got: dict, want: dict) -> None:
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: entries {sorted(set(got) ^ set(want))} "
                             "on one side only")
    for k, w in want.items():
        g = got[k].detach().cpu()
        if g.dtype != w.dtype or not torch.equal(g.view(torch.int32),
                                                 w.view(torch.int32)):
            raise AssertionError(f"{label}: {k} differs from the reference tensor")


def phase_migrated(card: str) -> dict:
    """Reference directories written at full width, migrated by the port's
    CLI, then (a) served from: the decoder CLI -l -r and -l --num_examples 1,
    the prior CLI -l -g through the migrated decoder; (b) held: the loaded
    modules' entries equal the written reference tensors bit for bit, the
    migrated encoders' codes at batch 512 on the card against the CPU plain
    route's (the GRU encoder's bit for bit; the transformer downscaler's,
    K3-fwd at T = S = 16 and 4, through z, _hold_codes), and the decoder's
    eval loss over those codes on
    the card the CPU f32 plain route's within phase 8's LOSS_RTOL; (c) the
    decoder CLI -t -l for one epoch of P16_TRAIN_BATCHES batches from the
    migrated weights, Adam's moments at zero after the load. The CLI calls
    and the two encodes at batch 512 are counted from zero launches."""
    import glob
    import shutil
    from vqcpcb_tpu_torch import (getters, main_decoder, main_prior,
                                  migrate_reference_checkpoint as migrate)
    from vqcpcb_tpu_torch.models.encoder import merge_codes
    from vqcpcb_tpu_torch.training.decoder_trainer import DecoderTrainer
    from vqcpcb_tpu_torch.training.prior_trainer import PriorTrainer
    from vqcpcb_tpu_torch.utils import default_compute_dtype, load_config_module
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "phase16")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ref = {k: os.path.join(work, f"reference_{k}")
           for k in ("encoder", "decoder", "prior", "transfo")}
    out = {k: os.path.join(work, f"migrated_{k}") for k in ref}
    out_config = {k: os.path.join(out[k], "config.py") for k in out}
    corpus = load_config_module(os.path.join(root, "configs", "decoder_synthetic.py"))

    # the configs: copies on the synthetic corpus, config_encoder /
    # config_decoder at the migrated directories
    configs = {
        "encoder": load_config_module(os.path.join(root, "configs",
                                                   "encoder_random_synthetic.py")),
        "decoder": dict(corpus, config_encoder=out_config["encoder"]),
        "prior": dict(prior_config(root), config_encoder=out_config["encoder"],
                      config_decoder=out_config["decoder"]),
        "transfo": dict(load_config_module(os.path.join(
            root, "configs", "encoder_random_transfo_config.py")),
            dataset="synthetic", corpus_kwargs=corpus["corpus_kwargs"])}
    for kind, config in configs.items():
        config["savename"] = f"reference_{kind}"

    # the modules, random weights from seeds, on the CPU
    t0 = time.perf_counter()
    data = getters.get_dataloader_generator(
        "synthetic", "decoder", corpus["dataloader_generator_kwargs"], corpus)
    rows = [torch.as_tensor(batch["x"]) for _ in range(BATCH // DECODER_CLI_BATCH)
            for batch in data.dataloaders(batch_size=DECODER_CLI_BATCH)[0]]
    templates = torch.cat(rows)[:BATCH]             # the corpus's windows, repeated
    if len(templates) != BATCH:
        raise AssertionError(f"{len(templates)} templates, not {BATCH}")
    encoders, written = {}, {}
    for i, kind in enumerate(("encoder", "transfo")):
        torch.manual_seed(16 + i)
        encoders[kind] = getters.get_encoder(getters.get_dataloader_generator(
            "synthetic", "vqcpc", configs[kind]["dataloader_generator_kwargs"],
            configs[kind]), configs[kind]).eval()
        _spread_codebook(encoders[kind], templates[:P16_INIT_ROWS])
        written[kind] = encoders[kind].state_dict()
    torch.manual_seed(18)
    decoder = main_decoder.build_decoder_trainer(
        dict(configs["decoder"], config_encoder=None), encoders["encoder"],
        configs["encoder"], "cpu", os.path.join(work, "unused")).decoder
    written["decoder"] = decoder.state_dict()
    torch.manual_seed(19)
    prior = getters.get_prior(
        getters.get_dataloader_generator(
            "synthetic", "prior", configs["prior"]["dataloader_generator_kwargs"],
            configs["prior"]), encoders["encoder"], configs["encoder"],
        "transformer_relative", configs["prior"]["prior_kwargs"])
    written["prior"] = prior.state_dict()
    del decoder, prior
    build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    _write_reference(ref["encoder"], configs["encoder"],
                     _reference_files("encoder", written["encoder"]), ("early_stopped", "overfitted"))
    _write_reference(ref["decoder"], configs["decoder"],
                     _reference_files("decoder", written["decoder"], written["encoder"]),
                     ("early_stopped", "overfitted"))
    _write_reference(ref["prior"], configs["prior"],
                     _reference_files("prior", written["prior"]), ["early_stopped"])
    _write_reference(ref["transfo"], configs["transfo"],
                     _reference_files("encoder", written["transfo"]), None)
    write_s = time.perf_counter() - t0
    sizes = {k: sum(os.path.getsize(p) for p in glob.glob(os.path.join(v, "**", "*"),
                                                          recursive=True)
                    if os.path.isfile(p)) for k, v in ref.items()}

    migrate_s = {}
    for kind in ("encoder", "decoder", "prior", "transfo"):
        t0 = time.perf_counter()
        if migrate.main([ref[kind], "-o", out[kind]]) != 0:
            raise AssertionError(f"migrating {ref[kind]} failed")
        migrate_s[kind] = time.perf_counter() - t0
    log(f"# [p16] {card}: modules built in {build_s:.2f} s, reference files "
        f"written in {write_s:.2f} s ({json.dumps(sizes)} bytes); migrated in "
        f"{json.dumps({k: round(v, 3) for k, v in migrate_s.items()})} s")

    # (a) and (c): the CLIs in process, counted from zero launches; each
    # load recorded with whether the optimizers' state was fresh after it
    loaded = {}
    originals = {cls: cls.load for cls in (DecoderTrainer, PriorTrainer)}
    current = {}

    def recording(cls):
        def load(self, *args, **kw):
            originals[cls](self, *args, **kw)
            fresh = self.step == 0 and all(
                opt.count == 0 and not any(m.any() for m in opt.mu + opt.nu)
                for opt in self._optimizers().values())
            loaded[(current["label"], cls.__name__)] = (self, fresh)
        return load

    per_call, calls = {}, {}
    cwd = os.getcwd()
    os.chdir(work)
    for cls in originals:
        cls.load = recording(cls)
    try:
        def run(label, cli, argv):
            current["label"] = label
            before = counts()
            code, sec = synced_seconds(lambda: cli.main(argv))
            per_call[label], calls[label] = _delta(counts(), before), sec
            log(f"# [p16 entry] {label}: exit {code} in {sec:.2f} s, launches "
                f"{json.dumps({k: v for k, v in per_call[label].items() if v})}")
            if code != 0:
                raise AssertionError(f"{label} returned {code}")
            kernels = P16_KERNELS[label]
            missing = [k for k in kernels if not per_call[label][k]]
            others = [k for k, c in per_call[label].items() if c and k not in kernels]
            if missing or others:
                raise AssertionError(f"{label}: launched {per_call[label]}: missing "
                                     f"{missing}, unexpected {others}")

        reset_counts()
        run("migrated decoder -l -r", main_decoder, ["-l", "-r", "-c", out_config["decoder"]])
        run("migrated decoder -l --num_examples 1", main_decoder,
            ["-l", "--num_examples", "1", "-c", out_config["decoder"]])
        run("migrated prior -l -g", main_prior, ["-l", "-g", "-c", out_config["prior"]])
        run("migrated decoder -t -l", main_decoder, [
            "-t", "-l", "-c", out_config["decoder"], "--num_epochs", "1",
            "--num_batches", str(P16_TRAIN_BATCHES)])
        cli_counts = counts()
    finally:
        os.chdir(cwd)
        for cls, method in originals.items():
            cls.load = method

    # (b) the loaded modules against the written tensors
    served = loaded[("migrated decoder -l -r", "DecoderTrainer")][0]
    prior_trainer = loaded[("migrated prior -l -g", "PriorTrainer")][0]
    through_prior = loaded[("migrated prior -l -g", "DecoderTrainer")][0]
    transfo, _ = main_decoder.load_encoder_stack({"config_encoder": out_config["transfo"]})
    transfo = transfo.cuda().eval()
    checks = {"decoder": (served.decoder, "decoder"),
              "its encoder": (served.encoder, "encoder"),
              "prior": (prior_trainer.prior, "prior"),
              "the prior's encoder": (prior_trainer.encoder, "encoder"),
              "decoder of the prior's -g": (through_prior.decoder, "decoder"),
              "transformer-downscaler encoder": (transfo, "transfo")}
    for label, (module, kind) in checks.items():
        got = module.state_dict()
        if any(v.device.type != "cuda" for v in got.values()):
            raise AssertionError(f"{label} was not loaded on the card")
        _assert_state_equal(label, got, written[kind])
    log(f"# [p16] (b) loaded on the card, equal to the written reference tensors "
        f"bit for bit: {', '.join(checks)} "
        f"({sum(len(written[kind]) for _, kind in checks.values())} entries)")

    # the migrated encoders' codes at batch 512, counted from zero launches
    x = templates.cuda()
    held_encoders = {"GRU encoder": (served.encoder, False),
                  "transformer-downscaler encoder": (transfo, True)}
    card_codes, card_s, encode_launches = {}, {}, {}
    with torch.no_grad():
        served.encoder.eval()(x[:8])
        transfo(x[:8])                       # warm-up: cuDNN and cuBLAS plans
    torch.cuda.synchronize()
    reset_counts()
    for label, (encoder, _) in held_encoders.items():
        before = counts()
        with torch.no_grad():
            card_codes[label], card_s[label] = synced_seconds(lambda: encoder(x)[1])
        encode_launches[label] = _delta(counts(), before)
    encode_counts = counts()
    codes = {label: _hold_codes(label, encoder, x, card_codes[label], card_s[label],
                                bf16)
             for label, (encoder, bf16) in held_encoders.items()}
    for label, c in codes.items():
        c["launches"] = encode_launches[label]

    # the decoder's eval loss over those codes, card vs the CPU f32 plain route
    merged = merge_codes(card_codes["GRU encoder"][:P16_EVAL_ROWS], CODEBOOK_SIZE)
    dec = served.decoder.eval()
    with torch.no_grad(), default_compute_dtype(served.compute_dtype):
        card_loss = dec(merged, x[:P16_EVAL_ROWS])["loss"].item()
    with torch.no_grad():
        cpu_loss = copy.deepcopy(dec).cpu()(merged.cpu(), templates[:P16_EVAL_ROWS])[
            "loss"].item()
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    log(f"# [p16] (b) the migrated decoder's eval loss over the first "
        f"{P16_EVAL_ROWS} rows' codes: card ({served.compute_dtype} layers) "
        f"{card_loss!r} vs CPU f32 plain route {cpu_loss!r} (relative "
        f"{loss_err:.3e}, need <= {LOSS_RTOL})")
    if not loss_err <= LOSS_RTOL:
        raise AssertionError("the migrated decoder's eval loss differs")

    # (c) the continued training
    continued, fresh = loaded[("migrated decoder -t -l", "DecoderTrainer")]
    (row,) = _check_model_dir(out["decoder"], 1)
    if not (fresh and continued.step == P16_TRAIN_BATCHES
            and np.isfinite(row["loss/train"])):
        raise AssertionError(f"-t -l: optimizer state fresh after the load {fresh}, "
                             f"{continued.step} steps, metrics {row}")
    written_scores = {k: len(glob.glob(os.path.join(out[k2], sub, "*.mid")))
                      for k, k2, sub in (("-r", "decoder", "reharmonisations"),
                                         ("--num_examples 1", "decoder", "generations"),
                                         ("-g", "prior", "generations"))}
    if written_scores != {"-r": 3, "--num_examples 1": 6, "-g": 1}:
        raise AssertionError(f"scores written by the CLIs: {written_scores}")
    log(f"# [p16] (c) -t -l from the migrated decoder: Adam's moments and count 0 "
        f"and step 0 after the load, {continued.step} steps, loss "
        f"{row['loss/train']!r} train / {row['loss/val']!r} val, "
        f"{row['tokens_per_sec/train']:.1f} tokens/s; scores written "
        f"{json.dumps(written_scores)}")
    by_kernel = {"K1": {l: c["vq_nearest"] for l, c in per_call.items()},
                 "K2-fwd": {l: c["relbias_attention_bwd"] for l, c in per_call.items()},
                 "K2-bwd": {l: c["relbias_attention_bwd"] for l, c in per_call.items()},
                 "K3-fwd": {l: c["relbias_attention_fwd"] - c["relbias_attention_bwd"]
                            for l, c in per_call.items()}}
    for label, c in encode_launches.items():
        by_kernel["K1"][f"{label} at batch {BATCH}"] = c["vq_nearest"]
        by_kernel["K3-fwd"][f"{label} at batch {BATCH}"] = c["relbias_attention_fwd"]
    for name, by_call in by_kernel.items():
        log(f"# [p16] {card}: {name} launches {sum(by_call.values())} on this path: "
            f"{json.dumps({l: n for l, n in by_call.items() if n})}")
    phase_s = time.perf_counter() - t_phase
    log(f"# [p16] {card}: " + json.dumps(dict(
        build_s=build_s, write_s=write_s, reference_bytes=sizes, migrate_s=migrate_s,
        cli_s=calls, codes={k: {n: v for n, v in c.items() if n != "launches"}
                            for k, c in codes.items()},
        eval_loss=dict(card=card_loss, cpu=cpu_loss, relative=loss_err),
        continued=dict(loss_train=row["loss/train"], loss_val=row["loss/val"],
                       tokens_per_s=row["tokens_per_sec/train"]),
        phase_s=phase_s)))
    return dict(launches={"p16_migrated_cli": cli_counts,
                          "p16_migrated_encode": encode_counts})


# ---- phase 17 --------------------------------------------------------------

# The (data, model) mesh (vqcpcb_tpu_torch/parallel/). (a) K7 on simulated
# shards on the card at the training shapes: each shard of each mesh runs
# its K7 wrapper (autograd over the kernels) on its (b_local, h_local)
# planes, held against the wrapper's plain version (phase 5's GRAD_FRAC rule
# and, for the relative-bias forward, phases 5-6's bf16 w_drop bit for
# bit), and at dropout 0 against the unsharded kernel: out, dq, dk and dv
# bit for bit (every plane is computed on its own); the tables' gradients,
# summed over the data shards in another order than the unsharded kernel's
# batch groups, within GRAD_FRAC. K1 on row shards (shard_batch, then K1's
# entry, as the trainers run it) against the unsharded kernel, bit for
# bit. (b) one NCCL rank through maybe_initialize
# (VQCPCB_DISTRIBUTED=1 and torchrun's variables): the decoder and prior
# CLIs -t over the mesh code; then one NCCL rank from VQCPCB_COORDINATOR
# (the coordinator path): the encoder CLI -t on
# configs/encoder_random_synthetic.py and on STUDENT_CONFIG; then -l of each
# on the one-GPU path from the slots they wrote. (c) four ranks on the one
# card over gloo (run_ranks, each started through maybe_initialize's
# coordinator path): gloo's
# collectives probed on CUDA tensors, then a (2, 2) flagship decoder and a
# (2, 2) absolute decoder at dropout 0.2 (the loss falls; gloo-on-one-card
# step times, not speeds of the mesh), and the flagship decoder (on the
# explicit-bias route, and on the in-kernel relative bias: K2's f32-dot
# instances at T = S = 384) and the
# prior at dropout 0 in f32 (VQCPCB_COMPUTE_DTYPE=float32 and
# VQCPCB_PALLAS_BF16_DOTS=0: a bf16 rounding would land in other places
# than one rank's) against one rank on the same global batches: the losses
# of MESH_STEPS steps within MESH_RTOL relative, and every one of the
# first step's gathered clipped gradients within MESH_GRAD_FRAC of its own
# max |value|, the mesh's ReLU masks pinned to one rank's on that step
# (torch_mesh_harness.ReluPins: f32 rounding differs between batch
# and column partitions, and a pre-activation within rounding of zero
# that takes the other sign moves its linear1 gradient by a token's whole
# share, up to 2.7e-3 of the max over 4 row blocks of one rank on an
# H100); beside it the card's own partition gaps, one rank over 4 row
# blocks, masks free and pinned, pinned held as the mesh is. The default
# route (K2's bf16 dots, layers in f32) on (2, 2) and on (4, 1), which
# runs no model-axis code, each against one rank, masks pinned: every
# gradient's relative L2 gap on (2, 2) within MESH_BF16_FACTOR of
# (4, 1)'s. The encoder side on (2, 2) and on (4, 1), each in f32 at
# dropout 0 against one rank (_encoder_mesh_jobs): the VQ-CPC of
# build_cpc_model with the BatchNorm and with the EMA quantizer, its
# transformer-downscaler twin and the student at full width, held as the
# decoder's (losses within MESH_RTOL, gradients within MESH_GRAD_FRAC of
# their own max, ReLU masks pinned), and besides: the codebooks after
# init_state bit for bit on every rank; the quantizer's buffers after the
# first step within ENC_BUFFER_RTOL; each rank's own K1 codes equal to the
# unsharded K1's rows on the data ranks' inputs, bit for bit; a row whose
# code differs from one rank's (an f32 BatchNorm statistic or latent summed
# in another order) pinned to one rank's on the first step only where one
# rank's best and second-best distances are a near tie, at most
# ENC_CODE_PINS_MAX such rows, any other differing row a failure; the
# student's masked event one rank's. The GRU VQ-CPC's own partition gaps
# (one rank over 2 and 4 row blocks, the whole batch's codes) beside its
# mesh's, and its (2, 2) job run twice. The student's default route (K7
# packed over K2 with bf16 dots at T = S = 384), layers in f32, on (2, 2)
# held against (4, 1) as the flagship's.
# (d) with two or more GPUs, the flagship at dropout 0.2 and the VQ-CPC
# over NCCL ranks, one per GPU, ms/step and tokens/s.
MESHES = ((2, 2), (1, 4), (4, 1))
MESH_STEPS = 3
MESH_DROPOUT_STEPS = 8
MESH_ABSOLUTE_STEPS = 4
MESH_RTOL = 1e-4
MESH_GRAD_FRAC = 1e-4
MESH_BF16_FACTOR = 4.0
MESH_CLI_BATCHES = 8
MESH_RANKS_TIMEOUT_S = 600
MESH_SEED = 17
# the encoder side of (c): steps of each job; the quantizer's buffers after
# the first step against one rank's, relative, element by element
ENC_MESH_STEPS = 2
ENC_BUFFER_RTOL = 1e-5
# the most first-step rows of a job, over its data ranks and its searches,
# whose codes may differ from one rank's at a near tie (torch_mesh_harness
# CODE_TIE_REL, f32 rounding; BF16_STEP, one bf16 step, on the bf16-dot
# route) and be pinned; a row that differs elsewhere fails the job
ENC_CODE_PINS_MAX = 8
# K1's mesh branch (pallas_vq.py:96-130) is no wrapper in the port: each
# rank's rows (parallel/mesh.shard_batch) go through K1's ordinary entry,
# held on row shards by (a) and counted under vq_nearest
K7_WRAPPERS = {
    "relbias_attention_packed_tp": "vqcpcb_tpu/ops/pallas_attention.py:1045",
    "relbias_attention_tp": "vqcpcb_tpu/ops/pallas_attention.py:1085",
    "fused_attention_train_tp": "vqcpcb_tpu/ops/pallas_attention.py:1122"}


def _shard_blocks(kind, mesh, b, h, tensors, tables):
    """One shard's blocks: rows of the batch and, packed, its heads'
    columns or, (B, H, L, d), its heads; the tables' heads."""
    lb, lh = b // mesh.n_data, h // mesh.n_model
    rows = slice(mesh.data_index * lb, (mesh.data_index + 1) * lb)
    heads = slice(mesh.model_index * lh, (mesh.model_index + 1) * lh)
    cols = slice(heads.start * HEAD_DIM, heads.stop * HEAD_DIM)
    if kind == "bhld":
        blocks = [x[rows, heads] for x in tensors]
    else:
        blocks = [x[rows, :, cols] for x in tensors]
    return (blocks, [None if x is None else x[heads] for x in tables], lh,
            (rows, heads, cols))


def _k7_run(kind, mesh, q, k, v, mask, e1, e2, g, lh, rate, seed):
    """One shard's K7 wrapper, forward and backward through autograd, in
    _hold's order: [out, dq, dk, dv, None (dmask), de1, de2] (relative
    bias) or [out, dq, dk, dv, None, None] (K6, no bias)."""
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    from vqcpcb_tpu_torch.ops import fused_attention_kernels as fk
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    tables = [] if kind == "fused" else [x.detach().requires_grad_(True)
                                          for x in (e1, e2)]
    if kind == "packed":
        out = ak.relbias_attention_packed_tp(mesh, *leaves, mask, *tables, lh,
                                             rate, seed)
    elif kind == "bhld":
        out = ak.relbias_attention_tp(mesh, *leaves, mask, *tables, rate, seed)
    else:
        out = fk.fused_attention_train_tp(mesh, *leaves, mask, None, lh, rate, seed)
    out.backward(g)
    grads = [x.grad for x in leaves + tables]
    # the kernels return the tables' gradient in q's dtype; autograd casts
    # it to the f32 tables' (exactly): back in q's dtype, _hold allows the
    # bf16 step of a bf16 result, as for phase 5's
    tables_grads = [x.to(q.dtype) for x in grads[3:]] or [None]
    return [out.detach(), *grads[:3], None, *tables_grads]


def _k7_plain(kind, mesh, q, k, v, mask, e1, e2, g, lh, rate, seed):
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    from vqcpcb_tpu_torch.ops import fused_attention_kernels as fk
    nh = None if kind == "bhld" else lh
    if kind == "fused":
        return fk.fused_attention_train_tp_plain(mesh, q, k, v, mask, None, g,
                                                 num_heads=nh, dropout=rate,
                                                 seed=seed)
    return ak.relbias_attention_tp_plain(mesh, q, k, v, mask, e1, e2, g,
                                         num_heads=nh, dropout=rate, seed=seed)


def _k7_case(label, kind, inputs, rate, worst, unsharded=None):
    """Every shard of every mesh: the wrapper against its plain version
    (and, relative bias packed with bf16 inputs, the forward's bf16 w_drop
    bit for bit on the first and last shard of each mesh); at
    dropout 0 against `unsharded` (the full kernel's [out, dq, dk, dv,
    dmask, de1, de2]): out, dq, dk, dv bit for bit, the summed tables'
    gradients within GRAD_FRAC. Returns the number of shards held."""
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    from vqcpcb_tpu_torch.parallel.mesh import simulated_mesh
    q, k, v, mask, e1, e2, g = inputs
    b = q.shape[0]
    held = 0
    for n_data, n_model in MESHES:
        tables_sum = None
        for rank in range(n_data * n_model):
            mesh = simulated_mesh(n_data, n_model, rank)
            (ql, kl, vl, gl), (e1l, e2l), lh, (rows, heads, cols) = _shard_blocks(
                kind, mesh, b, HEADS, (q, k, v, g), (e1, e2))
            what = f"K7 {label} mesh ({n_data}, {n_model}) rank {rank}"
            got = _k7_run(kind, mesh, ql, kl, vl, mask, e1l, e2l, gl, lh, rate, 99)
            want = _k7_plain(kind, mesh, ql, kl, vl, mask, e1l, e2l, gl, lh, rate, 99)
            names = FUSED_RESULTS if kind == "fused" else TRAIN_RESULTS
            _hold(what, got, want, None, worst, names=names)
            if (kind == "packed" and rate > 0 and q.dtype == torch.bfloat16
                    and rank in (0, n_data * n_model - 1)):
                seed_k = ak.shard_seed(99, mesh, ql.shape[0], lh)
                _hold_weights(
                    what,
                    lambda q_, k_, v_, m_, a_, b_, **kw: ak.relbias_attention_packed_tp(
                        mesh, q_, k_, v_, m_, a_, b_, lh, rate, 99),
                    lambda *x, **kw: ak.relbias_attention_bwd_weights_plain(
                        *x, num_heads=lh, dropout=rate, seed=seed_k),
                    (ql, kl, vl, mask, e1l, e2l, gl), dict(num_heads=lh))
            if unsharded is not None:
                pick = ((lambda x: x[rows, heads]) if kind == "bhld"
                        else (lambda x: x[rows, :, cols]))
                for res, a, w in zip(names[:4], got[:4], unsharded[:4]):
                    if not torch.equal(a, pick(w)):
                        raise AssertionError(f"{what}: {res} at dropout 0 is not "
                                             "the unsharded kernel's, bit for bit")
                if kind != "fused":
                    part = [x.float() for x in got[5:]]
                    if tables_sum is None:
                        tables_sum = [torch.zeros_like(x, dtype=torch.float32)
                                      for x in unsharded[5:]]
                    for total, x in zip(tables_sum, part):
                        total[heads] += x
            held += 1
        if unsharded is not None and kind != "fused":
            # each shard's table gradient is rounded to q's dtype before the
            # sum, the unsharded one once after it: half a step each
            frac = GRAD_FRAC + ((n_data + 1) * 2.0 ** -9
                                if q.dtype == torch.bfloat16 else 0.0)
            for res, total, w in zip(("de1", "de2"), tables_sum, unsharded[5:]):
                err = (total - w.float()).abs().max().item()
                scale = w.float().abs().max().item()
                worst["bwd"] = max(worst["bwd"], err)
                log(f"# K7 {label} mesh ({n_data}, {n_model}) dropout 0: {res} summed "
                    f"over the data shards vs unsharded {err:.3e} of {scale:.3g} "
                    f"(need <= {frac:.2e} of it; bit for bit: {bool(err == 0)})")
                if err > frac * max(scale, 1e-30):
                    raise AssertionError(f"K7 {label}: {res} summed over the shards "
                                         f"differs by {err}")
        torch.cuda.empty_cache()
    return held


def _k7_time(inputs):
    """The packed relative-bias K7 wrapper's forward and backward on one
    shard of (2, 2) at the flagship training shape: ms, the plain version's,
    the bound (fwd + bwd bytes and products of phase 5's rule at b_local,
    h_local) and SDPA's forward and backward with the mask and bias as an
    additive mask at the same shape."""
    import torch.nn.functional as F
    from vqcpcb_tpu_torch.ops.relative_attention import subsampled_relative_bias
    from vqcpcb_tpu_torch.parallel.mesh import simulated_mesh
    q, k, v, mask, e1, e2, g = inputs
    mesh = simulated_mesh(2, 2, 0)
    (ql, kl, vl, gl), (e1l, e2l), lh, _ = _shard_blocks(
        "packed", mesh, q.shape[0], HEADS, (q, k, v, g), (e1, e2))
    args = (ql, kl, vl, mask, e1l, e2l, gl, lh, TRAIN_DROPOUT, 99)
    ms = time_cuda(lambda: _k7_run("packed", mesh, *args), 10)
    plain_ms = time_cuda(lambda: _k7_plain("packed", mesh, *args), 3, warmup=1)
    lb, t = ql.shape[0], ql.shape[1]
    n = lb * lh
    act = 2 * lb * t * lh * HEAD_DIM
    side = 4 * t * t + 4 * lh * (2 * t - 1) * HEAD_DIM
    prod = 2 * t * t * HEAD_DIM * n
    bound_ms, bound_by = bound(11 * act + 3 * side, 11 * prod, BF16_FLOPS)
    q4, k4, v4, g4 = (x.unflatten(-1, (lh, HEAD_DIM)).transpose(1, 2).contiguous()
                      for x in (ql, kl, vl, gl))
    bias = (mask + subsampled_relative_bias(q4.float(), e1l, e2l)).to(torch.bfloat16)
    leaves = [x.detach().requires_grad_(True) for x in (q4, k4, v4, bias)]
    library_ms = time_cuda(lambda: F.scaled_dot_product_attention(
        *leaves[:3], attn_mask=leaves[3], dropout_p=TRAIN_DROPOUT,
        scale=1.0).backward(g4), 10)
    log(f"# K7 relbias_attention_packed_tp at (2, 2)'s shard (b {lb}, h {lh}, T=S={t}, "
        f"bf16, dropout {TRAIN_DROPOUT}), forward + backward: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa(mask+bias) fwd+bwd {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def _mesh_shards(gen) -> dict:
    """(a): K7 at the flagship's training shape (packed bf16, B=32, T=S=384,
    dropout 0.2 and 0), its (B, H, L, d) twin, K6's at the absolute
    decoder's self-attention and the prior's (B=64, T=S=24, f32 inputs,
    dropout 0.1 and 0), and K1 on row shards as the trainers run it
    (shard_batch, then K1's entry). Returns {"held" (shards held, by
    wrapper), "worst" (each wrapper's worst fwd and bwd error), "k1_held"
    (row shards), "timing"}."""
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    from vqcpcb_tpu_torch.ops import fused_attention_kernels as fk
    from vqcpcb_tpu_torch.ops import vq_kernels as vk
    from vqcpcb_tpu_torch.parallel.mesh import shard_batch, simulated_mesh
    worst = {name: {"fwd": 0.0, "bwd": 0.0} for name in K7_WRAPPERS}
    held = {}
    flagship = _train_inputs(gen, TRAIN_BATCH, 384, 384, "causal", True, torch.bfloat16)
    q, k, v, mask, e1, e2, g = flagship
    full = [ak.relbias_attention_fwd_cuda(q, k, v, mask, e1, e2, num_heads=HEADS),
            *ak.relbias_attention_bwd_cuda(q, k, v, mask, e1, e2, g, num_heads=HEADS,
                                           need_dmask=False)]
    held["relbias_attention_packed_tp"] = (
        _k7_case("flagship packed dropout 0.2", "packed", flagship, TRAIN_DROPOUT,
                 worst["relbias_attention_packed_tp"])
        + _k7_case("flagship packed dropout 0", "packed", flagship, 0.0,
                   worst["relbias_attention_packed_tp"], full))
    del full
    q4, k4, v4, g4 = (_split_heads(x).contiguous() for x in (q, k, v, g))
    bhld = (q4, k4, v4, mask, e1, e2, g4)
    full = [ak.relbias_attention_fwd_cuda(q4, k4, v4, mask, e1, e2),
            *ak.relbias_attention_bwd_cuda(q4, k4, v4, mask, e1, e2, g4,
                                           need_dmask=False)]
    held["relbias_attention_tp"] = (
        _k7_case("flagship (B, H, L, d) dropout 0.2", "bhld", bhld, TRAIN_DROPOUT,
                 worst["relbias_attention_tp"])
        + _k7_case("flagship (B, H, L, d) dropout 0", "bhld", bhld, 0.0,
                   worst["relbias_attention_tp"], full))
    del full, bhld, q4, k4, v4, g4
    timing = _k7_time(flagship)
    del flagship
    qa, ka, va = _projected(gen, TRAIN_BATCH, 384, 384, torch.bfloat16)
    ga = torch.randn(qa.shape, generator=gen, device="cuda").to(torch.bfloat16)
    causal = _fused_mask("causal", 384, 384)
    absolute = (qa, ka, va, causal, None, None, ga)
    full = [fk.fused_attention_train_fwd_cuda(qa, ka, va, causal, None, num_heads=HEADS),
            *fk.fused_attention_train_bwd_cuda(qa, ka, va, causal, None, ga,
                                               num_heads=HEADS, need_dmask=False)]
    held["fused_attention_train_tp"] = (
        _k7_case("absolute K6 dropout 0.2", "fused", absolute, TRAIN_DROPOUT,
                 worst["fused_attention_train_tp"])
        + _k7_case("absolute K6 dropout 0", "fused", absolute, 0.0,
                   worst["fused_attention_train_tp"], full))
    del full, absolute, qa, ka, va, ga
    prior = _train_inputs(gen, PRIOR_BATCH, PRIOR_CODES, PRIOR_CODES, "causal", True)
    q, k, v, mask, e1, e2, g = prior
    full = [ak.relbias_attention_fwd_cuda(q, k, v, mask, e1, e2, num_heads=HEADS),
            *ak.relbias_attention_bwd_cuda(q, k, v, mask, e1, e2, g, num_heads=HEADS,
                                           need_dmask=False)]
    held["relbias_attention_packed_tp"] += (
        _k7_case("prior packed f32 dropout 0.1", "packed", prior, 0.1,
                 worst["relbias_attention_packed_tp"])
        + _k7_case("prior packed f32 dropout 0", "packed", prior, 0.0,
                   worst["relbias_attention_packed_tp"], full))
    # K1: the decoder trainer's encode of 32 x 24 blocks, each rank's rows
    # (shard_batch) through K1's entry, as the trainers run it
    x = torch.randn((TRAIN_BATCH * NUM_CODES, 1, 3), generator=gen, device="cuda")
    codebooks = torch.randn((1, CODEBOOK_SIZE, 3), generator=gen, device="cuda")
    whole = vk.nearest_codebook_indices_cuda(x, codebooks)
    k1_held = 0
    for n_data in (2, 4, 8):
        got = torch.cat([vk.nearest_codebook_indices(
            shard_batch(x, simulated_mesh(n_data, 1, r)), codebooks)
            for r in range(n_data)])
        if not torch.equal(got, whole):
            raise AssertionError(f"K1 on {n_data} row shards differs from the "
                                 "unsharded kernel")
        k1_held += n_data
    odd = shard_batch(x[:TRAIN_BATCH * NUM_CODES - 3], simulated_mesh(4, 1, 1))
    if len(odd) != TRAIN_BATCH * NUM_CODES - 3 or not torch.equal(
            vk.nearest_codebook_indices(odd, codebooks), whole[:len(odd)]):
        raise AssertionError("K1 on replicated (non-dividing) rows differs")
    k1_held += 1
    errors = {k: {r: float(f"{e:.3e}") for r, e in w.items()} for k, w in worst.items()}
    log(f"# (a) K7 shards held: {json.dumps(held)}; worst error by wrapper "
        f"{json.dumps(errors)}; K1 on 2, 4 and 8 row shards (shard_batch, then "
        "K1's entry) and on replicated rows = the unsharded kernel, bit for bit")
    torch.cuda.empty_cache()
    return dict(held=held, worst=worst, k1_held=k1_held, timing=timing)


def _mesh_clis(encoder_config: str) -> tuple:
    """(b): the decoder and prior CLIs -t, then the decoder's -l -r and -l
    --num_examples 1 and the prior's -l -g, as one NCCL rank started by
    maybe_initialize from torchrun's variables (generation on every rank of
    the mesh, from the one-GPU slots); the encoder CLI -t on
    configs/encoder_random_synthetic.py and on STUDENT_CONFIG as one NCCL
    rank started from VQCPCB_COORDINATOR (the coordinator path); then -l of
    each on the one-GPU path. Returns (the launches of the calls, seconds by
    call, the encoder calls' launches, their epoch ms/step by kind)."""
    import glob
    import shutil
    import torch.distributed as dist
    from vqcpcb_tpu_torch import main_decoder, main_encoder, main_prior
    from vqcpcb_tpu_torch.parallel.launch import free_port
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "phase17")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "configs"))
    env = {"VQCPCB_DISTRIBUTED": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port()), "WORLD_SIZE": "1", "RANK": "0",
           "LOCAL_RANK": "0"}
    seconds = {}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        def run(label, cli, argv):
            code, sec = synced_seconds(lambda: cli.main(argv))
            seconds[label] = sec
            log(f"# [mesh] {label}: exit {code} in {sec:.2f} s")
            if code != 0:
                raise AssertionError(f"{label} returned {code}")

        reset_counts()
        os.environ.update(env)
        try:
            config = _decoder_config_copy(work, "decoder_mesh", encoder_config,
                                          "transformer_relative_diagonal")
            run("decoder -t (1 NCCL rank)", main_decoder,
                ["-t", "-c", config, "--num_epochs", "1", "--num_batches",
                 str(MESH_CLI_BATCHES)])
            if not (dist.is_initialized() and dist.get_backend() == "nccl"
                    and dist.get_world_size() == 1):
                raise AssertionError("maybe_initialize did not start one NCCL rank")
            (decoder_dir,) = glob.glob(os.path.join(work, "models", "decoder_mesh_*"))
            decoder_config = os.path.join(decoder_dir, "config.py")
            prior_cfg = _prior_config_copy(work, encoder_config, decoder_config)
            run("prior -t (1 NCCL rank)", main_prior, ["-t", "-c", prior_cfg])
            (prior_dir,) = glob.glob(os.path.join(work, "models", "prior_synthetic_*"))
            _check_model_dir(decoder_dir, 1)
            _check_model_dir(prior_dir, 1)
            # generation on every rank of the mesh (here the one NCCL rank),
            # from the one-GPU slots
            run("decoder -l -r (1 NCCL rank)", main_decoder, ["-l", "-r", "-c", decoder_config])
            run("decoder -l --num_examples 1 (1 NCCL rank)", main_decoder,
                ["-l", "--num_examples", "1", "-c", decoder_config])
            run("prior -l -g (1 NCCL rank)", main_prior,
                ["-l", "-g", "-c", os.path.join(prior_dir, "config.py")])
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            for name in env:
                os.environ.pop(name, None)
        written = {d: len(glob.glob(os.path.join(root_dir, d, "*.mid")))
                   for root_dir, d in ((decoder_dir, "reharmonisations"),
                                       (decoder_dir, "generations"),
                                       (prior_dir, "generations"))}
        if not all(written.values()):
            raise AssertionError(f"(b) the generation CLIs wrote {written} scores")

        # the encoder CLI through the coordinator variables
        before = counts()
        coordinator = {"VQCPCB_COORDINATOR": f"127.0.0.1:{free_port()}",
                       "VQCPCB_NUM_PROCESSES": "1", "VQCPCB_PROCESS_ID": "0"}
        os.environ.update(coordinator)
        encoder_dirs = {}
        try:
            for kind, config in (("encoder", "encoder_random_synthetic.py"),
                                 ("student", os.path.basename(STUDENT_CONFIG))):
                run(f"{kind} -t (1 NCCL rank, VQCPCB_COORDINATOR)", main_encoder,
                    ["-t", "-c", os.path.join(root, "configs", config), "--num_epochs",
                     "1", "--num_batches", str(MESH_CLI_BATCHES)])
                if not (dist.is_initialized() and dist.get_backend() == "nccl"
                        and dist.get_world_size() == 1):
                    raise AssertionError("maybe_initialize did not start one NCCL "
                                         "rank from VQCPCB_COORDINATOR")
                (encoder_dirs[kind],) = glob.glob(os.path.join(
                    work, "models", f"{os.path.splitext(config)[0]}_*"))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            for name in coordinator:
                os.environ.pop(name, None)
        epoch_ms = {}
        tokens_per_step = {"encoder": ENC_BATCH * (2 * ENC_BLOCKS * 16
                                                    + ENC_NEG * ENC_BLOCKS * 16),
                           "student": STUDENT_BATCH * NUM_EVENTS * 4}
        for kind, model_dir in encoder_dirs.items():
            (row,) = _check_model_dir(model_dir, 1, "loss_monitor" if kind == "student"
                                      else "loss")
            epoch_ms[kind] = tokens_per_step[kind] / row["tokens_per_sec/train"] * 1e3
            run(f"{kind} -l (one GPU)", main_encoder,
                ["-l", "-c", os.path.join(model_dir, "config.py")])
        encoder_launches = _delta(counts(), before)
        log(f"# (b) the encoder CLI's train epochs as one NCCL rank, ms/step from "
            f"metrics.jsonl's tokens/s ({MESH_CLI_BATCHES} steps, the first and the "
            f"data loading included): {json.dumps({k: round(v, 3) for k, v in epoch_ms.items()})}; "
            f"launches of the encoder calls {json.dumps(encoder_launches)}")
        launches = counts()
    finally:
        os.chdir(cwd)
    for kernel in ("vq_nearest", "relbias_attention_fwd", "relbias_attention_bwd"):
        if not launches[kernel]:
            raise AssertionError(f"(b) launched no {kernel}")
    if not encoder_launches["vq_nearest"]:
        raise AssertionError("(b) the encoder CLI launched no K1")
    return launches, seconds, encoder_launches, epoch_ms


def _mesh_job(job: dict) -> dict:
    """A payload of train_over_mesh (torch_mesh_harness.py) for one of
    (c)'s jobs, its models and batches built from MESH_SEED (the same in
    every process that builds them): the flagship or absolute decoder of
    build_models at full width on 4 random batches of TRAIN_BATCH, the
    prior of prior_parts, the VQ-CPC of build_cpc_model (the BatchNorm,
    EMA or transformer-downscaler quantizer) on 2 random batches of
    ENC_BATCH, its codebook init from the first, or the student of
    student_at_full_width on its first 2 batches (its codebook init from
    the first); the job's ReLU pins and code pins, where it has them."""
    from vqcpcb_tpu_torch.parallel.mesh import Mesh
    gen = torch.Generator(device="cuda").manual_seed(MESH_SEED)
    extra = {}
    if job["kind"] == "prior":
        encoder, model, codebook_size, batches, lr = prior_parts(gen)
    elif job["kind"] == "vqcpc":
        model = build_cpc_model(job["quantizer"] == "ema", job.get("transformer", False),
                                batch_norm=job["quantizer"] == "bn")
        batches = [{k: v.cpu().numpy() for k, v in random_cpc_batch(gen).items()}
                   for _ in range(2)]
        encoder = codebook_size = None
        lr = 1e-3
    elif job["kind"] == "student":
        trainer, student_batches = student_at_full_width(mesh=Mesh(1, 1))
        model = (trainer.encoder, trainer.teacher, trainer.auxiliary_decoder)
        batches = [x.cpu().numpy() for x in student_batches[:2]]
        encoder = codebook_size = None
        lr = trainer.optimizer_encdec.lr
        extra = dict(num_events_masked=trainer.num_events_masked,
                     quantization_weighting=trainer.quantization_weighting)
    else:
        vocab = synthetic_vocabulary()
        encoder, model = build_models(vocab, dropout=job["dropout"],
                                      kind=job["model"])
        batches = [random_templates(vocab, gen, TRAIN_BATCH, NUM_EVENTS)
                   for _ in range(4)]
        encoder.cuda()
        init_codebook(encoder, torch.cat(batches), gen)
        codebook_size, lr = CODEBOOK_SIZE, 1e-4
    for module in (model if isinstance(model, tuple) else (model,)):
        set_dropout(module, job["dropout"])
    steps = [batches[i % 2] for i in range(job["steps"])]
    if job["kind"] in ("decoder", "prior"):
        steps = [b.cpu().numpy() for b in steps]
    else:
        extra.update(record_codes=True, code_pins=job.get("code_pins"),
                     code_tie=job["code_tie"], initialize=job.get("initialize", True))
    return dict(kind=job["kind"], encoder=encoder, model=model, codebook_size=codebook_size,
                num_model=job["num_model"], batches=steps, lr=lr, device="cuda",
                env=job.get("env", {}), relu_pins=job.get("relu_pins"),
                relu_rel=job.get("relu_rel", 1e-4), **extra)


def mesh_ranks(rank: int, world_size: int, spec: dict) -> dict:
    """One rank of (c) or (d), started by launch.run_ranks: with one GPU per
    rank (spec["own_gpu"]) it takes cuda:rank. Probes the process group's
    collectives on CUDA tensors (the port's mesh uses all_reduce and
    all_gather_into_tensor), then runs spec["jobs"] with train_over_mesh.
    TF32 is off, as in this script's process (phase 1)."""
    import torch.distributed as dist
    from torch_mesh_harness import train_over_mesh
    # as phase 1 sets them in this script's process: f32 matmuls and GRUs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if spec.get("own_gpu"):
        torch.cuda.set_device(rank)
    x = torch.full((4,), float(rank + 1), device="cuda")
    probes = {"all_reduce": lambda: dist.all_reduce(x.clone()),
              "broadcast": lambda: dist.broadcast(x.clone(), 0),
              "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                  torch.empty(4 * world_size, device="cuda"), x),
              "all_gather": lambda: dist.all_gather(
                  [torch.empty(4, device="cuda") for _ in range(world_size)], x)}
    probe = {}
    for name, fn in probes.items():
        try:
            fn()
            torch.cuda.synchronize()
            probe[name] = "ok"
        except (RuntimeError, ValueError) as exc:
            probe[name] = f"refused: {str(exc).splitlines()[0][:200]}"
    if any(probe[k] != "ok" for k in ("all_reduce", "all_gather_into_tensor")):
        return {"probe": probe}
    return {"probe": probe,
            "jobs": [train_over_mesh(rank, world_size, _mesh_job(job))
                     for job in spec["jobs"]]}


def _mesh_reference(job: dict) -> dict:
    """One rank in this process on a job's models and batches
    (torch_mesh_harness.run_job over Mesh(1, 1)): its losses, the first
    step's clipped gradients, its ReLU pre-activations near zero (a
    ReluPins recording, "pins") and, on the encoder side, its codebooks
    after init_state, its quantizer buffers and the codes of its first
    step's searches."""
    from torch_mesh_harness import run_job, with_env
    from vqcpcb_tpu_torch.parallel.mesh import Mesh
    payload = _mesh_job(job)
    out = with_env(payload["env"], lambda: run_job(payload, Mesh(1, 1), record=True))
    del payload
    torch.cuda.empty_cache()
    return out


def _grad_gaps(got: dict, want: dict) -> tuple:
    """({parameter: largest gap / its max |value|}, {parameter: relative L2
    gap}) of two gradients."""
    own = {k: ((got[k].float() - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
           for k, w in want.items()}
    l2 = {k: ((got[k].float() - w).norm() / w.norm().clamp_min(1e-30)).item()
          for k, w in want.items()}
    return own, l2


def _worst(gaps: dict, n: int = 3) -> str:
    return json.dumps({k: float(f"{v:.3e}") for k, v in
                       sorted(gaps.items(), key=lambda kv: -kv[1])[:n]})


def _partition_gaps(job: dict, parts: int) -> dict:
    """The card's own gradient gaps between batch partitions, with no mesh
    code: one rank in this process, the job's first batch's gradient (the
    trainer's loss, no update) whole against the mean of `parts` row
    blocks' gradients, the blocks' ReLU masks free and then pinned to the
    whole batch's (torch_mesh_harness.ReluPins). A VQ-CPC's blocks take
    the whole batch's nearest-codebook codes in both (a block's own
    BatchNorm statistics would move them, where the mesh sums them over
    `data`). Returns {"free", "pinned": (own, l2) as _grad_gaps gives
    them, "flips" (pinned units by ReLU call, summed over the blocks),
    "pin_gap", "codes_moved" (the VQ-CPC's rows whose codes a block's own
    search moved, held to the whole batch's)}."""
    from torch_mesh_harness import ReluPins, build_trainer, with_env
    from vqcpcb_tpu_torch.parallel.mesh import Mesh
    payload = _mesh_job(job)

    def run():
        trainer, module = build_trainer(payload, Mesh(1, 1), torch.device("cuda"))
        module.train()
        state = dict(block=None, call=0, moved=0)
        if job["kind"] == "vqcpc":
            whole = trainer._batch(payload["batches"][0], train=True)
            blocks = [{k: v.chunk(parts)[i] for k, v in whole.items()}
                      for i in range(parts)]
            quantizer = module.encoder.quantizer
            search, codes = quantizer.search, []

            def held_search(x, codebooks):
                own = search(x, codebooks)
                if state["block"] is None:
                    codes.append(own)
                    return own
                n, i = len(own), state["block"]
                held = codes[state["call"]][i * n:(i + 1) * n]
                state["call"] += 1
                state["moved"] += int((held != own).any(-1).sum())
                return held
            quantizer.search = held_search

            def loss(inputs, block):
                state.update(block=block, call=0)
                return module(inputs, training=True, generator=trainer.generator)[0]
        else:
            whole = torch.as_tensor(payload["batches"][0], device="cuda")
            blocks = list(whole.chunk(parts))

            def loss(inputs, block):
                return trainer._loss(inputs)

        def grads(pinned):
            module.zero_grad(set_to_none=True)
            for i, rows in enumerate(blocks):
                if pinned is None:
                    (loss(rows, i) / parts).backward()
                else:
                    pins = ReluPins(pinned, (i, parts))
                    with pins:
                        (loss(rows, i) / parts).backward()
                    flips.append(pins.flips)
                    gaps.append(pins.gap)
            return {k: p.grad.float() for k, p in module.named_parameters()
                    if p.grad is not None}

        flips, gaps = [], []
        record = ReluPins()
        with record:
            module.zero_grad(set_to_none=True)
            loss(whole, None).backward()
        reference = {k: p.grad.float() for k, p in module.named_parameters()
                     if p.grad is not None}
        free = grads(None)
        moved = state["moved"]
        pinned = grads(record.pins)
        return reference, free, pinned, flips, gaps, moved

    whole, free, pinned, flips, gaps, moved = with_env(payload["env"], run)
    del payload
    torch.cuda.empty_cache()
    return dict(free=_grad_gaps(free, whole), pinned=_grad_gaps(pinned, whole),
                flips=[int(sum(f)) for f in zip(*flips)], pin_gap=max(gaps),
                codes_moved=moved)


def _log_partition(label: str, part: dict) -> None:
    log(f"# (c) the card's own partition gaps, {label} (one rank, no mesh code, "
        f"f32 as above): the gradient over row blocks against the whole batch's, "
        f"gap / each parameter's max |value|: ReLU masks free, largest "
        f"{_worst(part['free'][0])}, median {np.median(list(part['free'][0].values())):.3e}; "
        f"pinned to the whole batch's ({json.dumps(part['flips'])} units by call, "
        f"largest pre-activation gap {part['pin_gap']:.3e}), largest "
        f"{_worst(part['pinned'][0])}, median "
        f"{np.median(list(part['pinned'][0].values())):.3e}; rows whose codes a "
        f"block's own search moved, held to the whole batch's {part['codes_moved']}")


def _encoder_mesh_jobs(f32: dict, bf16_dots: dict, relbias: tuple,
                       explicit: tuple) -> list:
    """(c)'s encoder-side jobs, on (2, 2) and on (4, 1), each in f32 at
    dropout 0 against one rank: the VQ-CPC of build_cpc_model with the
    BatchNorm and with the EMA quantizer, its transformer-downscaler twin
    (K2 through K7 with f32 dots at T = S = 16 and 4), and the student at
    full width (the relative auxiliary decoder; K6 with the explicit
    relative bias through K7, the student's explicit-bias route held on the
    mesh, as the flagship's in-kernel f32 route is held by phase 17 (c)'s
    flagship job and phase 18); the BatchNorm VQ-CPC's (2, 2) job
    a second time; and the student on its default route (K7 packed over K2
    with bf16 dots), layers in f32, one step on (2, 2) and on (4, 1), held
    as the flagship's bf16-dot pair, from the model's own codebooks (no
    data init: under a model axis its bf16-dot eval forward rounds
    otherwise than one rank's, and the pair compares the training step). A code row is a near tie within f32
    rounding, or one bf16 step on the bf16-dot route."""
    from torch_mesh_harness import BF16_STEP, CODE_TIE_REL
    jobs = []
    for num_model, label in ((2, "(2, 2)"), (1, "(4, 1)")):
        common = dict(dropout=0.0, steps=ENC_MESH_STEPS, num_model=num_model,
                      compare="exact", encoder_side=True, code_tie=CODE_TIE_REL)
        jobs += [
            dict(name=f"vqcpc bn f32 {label}", kind="vqcpc", quantizer="bn",
                 need=(), env=f32, **common),
            dict(name=f"vqcpc ema f32 {label}", kind="vqcpc", quantizer="ema",
                 need=(), env=f32, **common),
            dict(name=f"transfo vqcpc f32 {label}", kind="vqcpc", quantizer="plain",
                 transformer=True, need=relbias, env=f32, **common),
            dict(name=f"student f32 {label}", kind="student", need=explicit,
                 env=dict(f32, VQCPCB_PALLAS_RELBIAS="0"), **common)]
    jobs.append(dict(jobs[0], name="vqcpc bn f32 (2, 2) again"))
    for num_model, label in ((2, "(2, 2)"), (1, "(4, 1)")):
        jobs.append(dict(name=f"student bf16 dots {label}", kind="student",
                         dropout=0.0, steps=1, num_model=num_model, need=relbias,
                         compare="bf16", encoder_side=True, env=bf16_dots,
                         code_tie=BF16_STEP, relu_rel=BF16_STEP, initialize=False))
    return jobs


def _reference_key(job: dict) -> str:
    """Jobs of one key train the same models on the same batches."""
    return json.dumps([job["kind"], job.get("model"), job.get("quantizer"),
                       job.get("transformer"), job["steps"], job.get("env", {}),
                       job.get("initialize", True), job.get("relu_rel")], sort_keys=True)


def _rel_gap(got, want) -> float:
    """The largest |got - want| / |want| over the elements."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()


def _encoder_side_checks(job: dict, results: list, n_model: int) -> dict:
    """The encoder-side holds of a job over the 4 ranks (rank r's data index
    r // n_model), against the one-rank reference: the codebooks after
    init_state equal bit for bit on every rank; the quantizer's buffers
    after the first step (BatchNorm running statistics; the EMA codebooks,
    cluster_size and ema_sums) within ENC_BUFFER_RTOL relative; each rank's
    own K1 codes of the first step equal the rows of K1 launched here,
    unsharded, on the data ranks' search inputs put together, bit for bit;
    no row's code differs from one rank's except at a near tie, and at most
    ENC_CODE_PINS_MAX such rows, pinned; the student's masked event the
    same on every rank and one rank's. Returns {"init_gap" (vs one rank's
    init, not held), "buffer_gap", "code_rows", "code_flips" (near-tie rows
    whose codes differed from one rank's and were pinned to them, by rank
    and search), "code_flip_margin" (the largest one-rank margin of such a
    row)}."""
    from vqcpcb_tpu_torch.ops import vq_kernels as vk
    ref = job["reference"]
    runs = [r["jobs"][job["index"]] for r in results]
    first = runs[0]["init_codebooks"]
    for r, run in enumerate(runs):
        for key, value in run["init_codebooks"].items():
            if not torch.equal(value, first[key]):
                raise AssertionError(f"(c) {job['name']}: rank {r}'s codebooks after "
                                     f"init_state differ from rank 0's ({key})")
    init_gap = max((first[k] - v).abs().max().item()
                   for k, v in ref["init_codebooks"].items())
    buffer_gap = max([_rel_gap(runs[0]["buffers"][0][k], v)
                      for k, v in ref["buffers"][0].items()] or [0.0])
    if buffer_gap > ENC_BUFFER_RTOL:
        raise AssertionError(f"(c) {job['name']}: quantizer buffers {buffer_gap:.3e} "
                             f"from one rank's (need <= {ENC_BUFFER_RTOL})")
    # each search of the first step: the data ranks' inputs (model index 0)
    # in data order, through K1 unsharded, against the ranks' own codes
    rows = 0
    data_ranks = [runs[r] for r in range(0, len(runs), n_model)]
    for call in range(len(ref["codes"])):
        x = torch.cat([run["codes"][call][0] for run in data_ranks]).cuda()
        codebooks = data_ranks[0]["codes"][call][1].cuda()
        own = torch.cat([run["codes"][call][2] for run in data_ranks]).cuda()
        if not torch.equal(vk.nearest_codebook_indices(x.contiguous(), codebooks), own):
            raise AssertionError(f"(c) {job['name']}: the ranks' K1 codes of search "
                                 f"{call} differ from the unsharded K1's rows")
        rows += len(own)
    faults = [run["code_faults"] for run in runs]
    margin = max(run["code_flip_margin"] for run in runs)
    if any(map(any, faults)):
        raise AssertionError(
            f"(c) {job['name']}: rows whose codes differ from one rank's away from a "
            f"near tie, by rank and search {faults} (largest one-rank margin "
            f"{margin:.3e}, a near tie is <= {job['code_tie']})")
    # the model ranks of a data index search the same rows: count them once
    pinned = sum(map(sum, (run["code_flips"] for run in data_ranks)))
    if pinned > ENC_CODE_PINS_MAX:
        raise AssertionError(f"(c) {job['name']}: {pinned} near-tie rows pinned to "
                             f"one rank's codes (need <= {ENC_CODE_PINS_MAX})")
    if job["kind"] == "student":
        masked = [run["masked"] for run in runs]
        if any(m != ref["masked"] for m in masked):
            raise AssertionError(f"(c) {job['name']}: masked events {masked}, one "
                                 f"rank's {ref['masked']}")
    return dict(init_gap=init_gap, buffer_gap=buffer_gap, code_rows=rows,
                code_flips=[run["code_flips"] for run in runs], code_flip_margin=margin)


def _mesh_ranks_on_one_card(jobs=None) -> dict:
    """(c): returns {"probe", "refused" (the collectives gloo refused on
    CUDA tensors), "launches" (summed over the ranks and the jobs, K1 also
    by kind), "encoder_launches" (those of the encoder-side jobs), "k7"
    (the K7 wrappers' launches), "step_ms", "gaps" (the comparisons'
    per-parameter gaps, by job), "losses", "encoder_side" (the holds of
    _encoder_side_checks, by job)}. The comparisons of losses and gradients
    are held by _hold_mesh_gaps."""
    from vqcpcb_tpu_torch.parallel.launch import run_ranks
    relbias = ("relbias_attention_packed_tp", "relbias_attention_fwd",
               "relbias_attention_bwd")
    nobias = ("fused_attention_train_tp", "fused_attention_train_fwd",
              "fused_attention_train_bwd_nobias")
    explicit = ("fused_attention_train_tp", "fused_attention_train_fwd",
                "fused_attention_train_bwd")
    # f32 end to end: the layers, and the kernels' f32-dot instances: the
    # flagship on the in-kernel relative bias (K2's f32 forward and streamed
    # backward at T=S=384) and on the explicit-bias route (K6 with f32 dots),
    # the prior's K2 at 24
    f32 = {"VQCPCB_COMPUTE_DTYPE": "float32", "VQCPCB_PALLAS_BF16_DOTS": "0"}
    relbias_f32 = relbias + ("relbias_attention_fwd_f32", "relbias_attention_bwd_f32")
    bf16_dots = {"VQCPCB_COMPUTE_DTYPE": "float32"}
    jobs = jobs or [
        dict(name="flagship dropout", kind="decoder", model="flagship",
             dropout=TRAIN_DROPOUT, steps=MESH_DROPOUT_STEPS, num_model=2,
             need=relbias),
        dict(name="absolute dropout", kind="decoder", model="absolute",
             dropout=TRAIN_DROPOUT, steps=MESH_ABSOLUTE_STEPS, num_model=2,
             need=nobias),
        dict(name="flagship f32", kind="decoder", model="flagship", dropout=0.0,
             steps=MESH_STEPS, num_model=2, need=explicit, compare="exact",
             env=dict(f32, VQCPCB_PALLAS_RELBIAS="0")),
        dict(name="flagship f32 in-kernel relbias", kind="decoder", model="flagship",
             dropout=0.0, steps=MESH_STEPS, num_model=2, need=relbias_f32,
             compare="exact", env=f32),
        dict(name="prior f32", kind="prior", dropout=0.0, steps=MESH_STEPS,
             num_model=2, need=relbias, compare="exact", env=f32),
        # the default route (K2 with bf16 dots), layers in f32: the (2, 2)
        # mesh held against (4, 1), which runs no model-axis code, each
        # against one rank on the same batch
        dict(name="flagship bf16 dots (2, 2)", kind="decoder", model="flagship",
             dropout=0.0, steps=1, num_model=2, need=relbias, compare="bf16",
             env=bf16_dots),
        dict(name="flagship bf16 dots (4, 1)", kind="decoder", model="flagship",
             dropout=0.0, steps=1, num_model=1, need=relbias, compare="bf16",
             env=bf16_dots)] + _encoder_mesh_jobs(f32, bf16_dots, relbias, explicit)
    # one rank first, on the compared jobs' batches: the reference losses and
    # gradients, the ReLU pre-activations near zero that pin the mesh's
    # first step (torch_mesh_harness.ReluPins), and on the encoder side the
    # first step's codes, which pin the mesh's where they differ
    references = {}
    for j, job in enumerate(jobs):
        job["index"] = j
        if "compare" in job:
            key = _reference_key(job)
            if key not in references:
                references[key] = _mesh_reference(job)
            job["reference"] = references[key]
            job["relu_pins"] = references[key]["pins"]
            if job.get("encoder_side"):
                job["code_pins"] = [(codes, margins) for _, _, codes, margins
                                    in references[key]["codes"]]
    t0 = time.perf_counter()
    results = run_ranks("chip_smoke:mesh_ranks", 4,
                        {"jobs": [{k: v for k, v in job.items() if k != "reference"}
                                  for job in jobs]},
                        timeout_s=MESH_RANKS_TIMEOUT_S, backend="gloo", threads=2)
    wall = time.perf_counter() - t0
    probe = results[0]["probe"]
    refused = {k: v for k, v in probe.items() if v != "ok"}
    log(f"# (c) gloo on CUDA tensors, 4 ranks on one card: {json.dumps(probe)} "
        f"(the mesh code uses all_reduce and all_gather_into_tensor); run_ranks "
        f"wall {wall:.1f} s")
    if "jobs" not in results[0]:
        log("# (c) gloo refused a collective of the mesh on CUDA tensors: the "
            "multi-rank proof on the card is (a) and (b)")
        return dict(probe=probe, refused=refused, launches={}, encoder_launches={},
                    k7=dict.fromkeys(K7_WRAPPERS, 0), step_ms={}, gaps={}, losses={},
                    encoder_side={})
    launches, encoder_launches, step_ms, gaps, losses_by_job = {}, {}, {}, {}, {}
    encoder_side = {}
    for j, job in enumerate(jobs):
        per_job = {}
        for r in results:
            for key, n in r["jobs"][j]["launches"].items():
                per_job[key] = per_job.get(key, 0) + n
        for key, n in per_job.items():
            launches[key] = launches.get(key, 0) + n
            if job.get("encoder_side"):
                encoder_launches[key] = encoder_launches.get(key, 0) + n
        res = results[0]["jobs"][j]
        losses = res["losses"]
        losses_by_job[job["name"]] = losses
        if not all(np.isfinite(losses)) or any(r["jobs"][j]["losses"] != losses
                                                for r in results):
            raise AssertionError(f"(c) {job['name']}: ranks' losses {losses}")
        step_ms[job["name"]] = res["seconds"] / len(losses) * 1e3
        log(f"# (c) {job['name']} over ({4 // job['num_model']}, {job['num_model']}): losses {[round(x, 5) for x in losses]}, "
            f"{step_ms[job['name']]:.1f} ms/step with 4 gloo ranks sharing one card "
            "(not a speed of the mesh); launches summed over the ranks "
            f"{json.dumps({k: v for k, v in per_job.items() if v})}")
        missing = [k for k in job["need"] + ("vq_nearest",) if not per_job.get(k)]
        if missing:
            raise AssertionError(f"(c) {job['name']}: no launch of {missing}")
        if "compare" not in job:
            first, last = np.mean(losses[:2]), np.mean(losses[-2:])
            if job["name"].startswith("flagship") and not last < first:
                raise AssertionError(f"(c) {job['name']}: the loss did not fall")
            continue
        ref = job["reference"]
        own, l2 = _grad_gaps(res["grads"], ref["grads"])
        gaps[job["name"]] = dict(
            compare=job["compare"], own=own, l2=l2,
            loss=max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])),
            flips=[r["jobs"][j].get("flips") for r in results],
            pin_gap=max(r["jobs"][j].get("pin_gap", 0.0) for r in results))
        log(f"# (c) {job['name']}: the mesh vs one rank, losses {ref['losses']} "
            f"(largest relative gap {gaps[job['name']]['loss']:.3e}); ReLU units "
            f"pinned on the first step by rank and call "
            f"{json.dumps(gaps[job['name']]['flips'])} (their largest pre-activation "
            f"gap {gaps[job['name']]['pin_gap']:.3e}); first step's clipped "
            f"gradients, gap / each parameter's max |value|: largest {_worst(own)}, "
            f"median {np.median(list(own.values())):.3e}; relative L2 largest "
            f"{_worst(l2)}")
        if job.get("encoder_side"):
            held = _encoder_side_checks(job, results, job["num_model"])
            encoder_side[job["name"]] = held
            log(f"# (c) {job['name']}: codebooks after init_state equal on the 4 "
                f"ranks (largest gap to one rank's init {held['init_gap']:.3e}); "
                f"quantizer buffers after the first step within "
                f"{held['buffer_gap']:.3e} relative of one rank's; the ranks' own "
                f"K1 codes = the unsharded K1's rows on their inputs ({held['code_rows']} "
                f"rows); near-tie rows whose codes differed from one rank's, pinned, "
                f"by rank and search {json.dumps(held['code_flips'])} (largest "
                f"one-rank margin {held['code_flip_margin']:.3e}; none elsewhere)")
        partitions = {"flagship f32": (4,), "vqcpc bn f32 (2, 2)": (2, 4)}
        for parts in partitions.get(job["name"], ()):
            label = (f"{parts} row blocks" if job["kind"] == "decoder"
                     else f"the GRU VQ-CPC (BatchNorm) over {parts} row blocks")
            part = _partition_gaps(job, parts)
            gaps[f"one rank, {label}"] = dict(compare="partition", **part)
            _log_partition(f"{label}, beside its mesh's largest {_worst(own, 1)}", part)
        again = job["name"].replace(" again", "")
        if again != job["name"] and again in gaps:
            first = results[0]["jobs"][[o["name"] for o in jobs].index(again)]["grads"]
            run_gap = _grad_gaps(res["grads"], first)[0]
            log(f"# (c) {again}, run twice: the largest gap to one rank's "
                f"{_worst(gaps[again]['own'], 1)} then {_worst(own, 1)}; between the "
                f"two mesh runs, gap / each parameter's max |value| largest "
                f"{_worst(run_gap, 1)}")
    del references
    for job in jobs:
        for key in ("reference", "relu_pins", "code_pins"):
            job.pop(key, None)
    k7 = {k: launches.get(k, 0) for k in K7_WRAPPERS}
    return dict(probe=probe, refused=refused, launches=launches,
                encoder_launches=encoder_launches, k7=k7, step_ms=step_ms, gaps=gaps,
                losses=losses_by_job, encoder_side=encoder_side)


def _hold_mesh_gaps(gaps: dict) -> None:
    """(c)'s holds: every compared job's losses within MESH_RTOL of one
    rank's; f32 ("exact", and the one-rank partition with its ReLU masks
    pinned), every gradient within MESH_GRAD_FRAC of its own max |value|;
    each bf16-dot (2, 2) mesh, every gradient's relative L2 gap within
    MESH_BF16_FACTOR of the (4, 1) control's (its own, or the control's
    median where that is larger). The student's relative-bias tables may
    instead stand within MESH_BF16_FACTOR of the flagship control's
    largest table gap: its (4, 1) control runs its teacher's tables' backward
    almost exactly (2 rows a rank), where the flagship's shows the tables'
    bf16 rounding at the same T = S = 384."""
    for name, g in gaps.items():
        if g["compare"] == "partition":
            own = g["pinned"][0]
        else:
            if g["loss"] > MESH_RTOL:
                raise AssertionError(f"(c) {name}: losses {g['loss']:.3e} apart "
                                     f"(need <= {MESH_RTOL})")
            own = g["own"]
        if g["compare"] in ("exact", "partition"):
            bad = {k: v for k, v in own.items() if v > MESH_GRAD_FRAC}
            if bad:
                raise AssertionError(f"(c) {name}: gradients beyond "
                                     f"{MESH_GRAD_FRAC} of their max: {_worst(bad, 8)}")
    flagship = gaps.get("flagship bf16 dots (4, 1)")
    table_floor = max((v for k, v in flagship["l2"].items() if ".attn_bias.e" in k),
                      default=0.0) if flagship else 0.0
    for name in [n for n, g in gaps.items()
                 if g["compare"] == "bf16" and n.endswith("(2, 2)")]:
        mesh, control = gaps[name], gaps[name.replace("(2, 2)", "(4, 1)")]
        floor = float(np.median(list(control["l2"].values())))

        def base(k):
            tables = ".attn_bias.e" in k and not name.startswith("flagship")
            return max(control["l2"][k], floor, table_floor if tables else 0.0)
        bad = {k: v for k, v in mesh["l2"].items() if v > MESH_BF16_FACTOR * base(k)}
        extra = ("" if name.startswith("flagship") else
                 f"; a relative-bias table's, or the flagship control's largest "
                 f"table gap {table_floor:.3e}")
        log(f"# (c) {name}: the mesh's relative L2 gaps vs the (4, 1) "
            f"control's (need each <= {MESH_BF16_FACTOR} x max(the control's, its "
            f"median {floor:.3e}{extra})): largest ratio "
            f"{max(v / base(k) for k, v in mesh['l2'].items()):.3f}, to the "
            f"control's alone {max(v / max(control['l2'][k], floor) for k, v in mesh['l2'].items()):.3f}")
        if bad:
            raise AssertionError(f"(c) {name}: gradients beyond the "
                                 f"control: {_worst(bad, 8)}")


def _mesh_nccl_gpus() -> dict:
    """(d): with two or more GPUs, the flagship at dropout 0.2 and the VQ-CPC
    of build_cpc_model at its dropout 0.1 over NCCL ranks, one per GPU (2,
    then 4 where there are 4): ms/step and tokens/s."""
    from vqcpcb_tpu_torch.parallel.launch import run_ranks
    n_gpus = torch.cuda.device_count()
    if n_gpus < 2:
        log(f"# (d) not run: this machine shows {n_gpus} GPU, and NCCL takes one "
            "rank per GPU")
        return {}
    out = {}
    tokens = {"flagship": TRAIN_BATCH * NUM_EVENTS * 4,
              "vqcpc": ENC_BATCH * (2 * ENC_BLOCKS * 16 + ENC_NEG * ENC_BLOCKS * 16)}
    for world in (2, 4):
        if world > n_gpus:
            break
        jobs = [dict(name="flagship dropout", kind="decoder", model="flagship",
                     dropout=TRAIN_DROPOUT, steps=MESH_DROPOUT_STEPS, num_model=1),
                dict(name="vqcpc", kind="vqcpc", quantizer="plain", dropout=0.1,
                     steps=MESH_DROPOUT_STEPS, num_model=1)]
        res = run_ranks("chip_smoke:mesh_ranks", world, {"jobs": jobs, "own_gpu": True},
                        timeout_s=MESH_RANKS_TIMEOUT_S, backend="nccl", threads=2)
        for job, r in zip(jobs, res[0]["jobs"]):
            name = job["name"].split()[0]
            ms = r["seconds"] / len(r["losses"]) * 1e3
            out[f"{name} {world}"] = dict(step_ms=ms, tokens_per_s=tokens[name] / ms * 1e3)
            log(f"# (d) {name}, {world} NCCL ranks, data-parallel: {ms:.2f} ms/step, "
                f"{out[f'{name} {world}']['tokens_per_s']:.1f} tokens/s")
    return out


# (e) the KV-cached samplers over the mesh: four gloo ranks sharing the card
# on (2, 2) and (4, 1) (torch_mesh_harness.sample_job, each rank its rows of
# the batch, parallel/mesh.generation_rows, and under (2, 2) its heads,
# blocks and vocabulary rows): the flagship's encode (K1 on each rank's
# rows) and sample_range at BATCH x 384 positions with int8 caches, the
# prior's generate_codes at PRIOR_SAMPLE_BATCH x PRIOR_SAMPLE_CODES, the
# absolute decoder's prefill (K4) and SAMPLE_ABSOLUTE_STEPS positions with
# f32 caches (VQCPCB_KV_DTYPE=float32: its route is f32 end to end);
# greedy (top_k 1), and the flagship at T 0.95 and top-p 0.8; on (4, 1)
# the flagship greedy with f32 caches too. Each against one rank's run of
# the same job on the card in this process: greedy tokens equal but for
# rows whose first differing position is a near tie on one rank (top-two
# logit margin within CODE_TIE_REL of the logits' largest |value|, within
# BF16_STEP where the prefill's K3 takes bf16 dots; an int8 cache row moves
# by a whole quantization step where the f32 sums that fill it round
# differently, which the int8 jobs' ties stay within), those rows counted;
# the flagship's codes
# equal one rank's but for rows at a nearest-codebook near tie (left out
# of the token comparison, counted); every rank the same tokens, the model
# ranks of a data index the same rows; the stochastic runs' share of equal
# tokens reported; no K7 launch (sampling has no training kernels).
SAMPLE_ABSOLUTE_STEPS = 32
F32_CACHES = {"VQCPCB_KV_DTYPE": "float32"}
SAMPLE_JOBS = (
    dict(name="flagship greedy", model="flagship", top_k=1),
    dict(name="flagship T 0.95 top-p 0.8", model="flagship", temperature=0.95,
         top_p=0.8),
    dict(name="flagship greedy, f32 caches", model="flagship", top_k=1,
         env=F32_CACHES, models=(1,)),
    dict(name="prior greedy", model="prior", top_k=1),
    dict(name="absolute greedy, f32 caches", model="absolute", top_k=1,
         env=F32_CACHES))


def _sampler_payload(job: dict) -> dict:
    """A torch_mesh_harness.sample_job payload of one of (e)'s jobs, its
    models, templates and codebooks built from MESH_SEED (the same in every
    process that builds them)."""
    gen = torch.Generator(device="cuda").manual_seed(MESH_SEED)
    common = dict(device="cuda", num_model=job.get("num_model", 1), seed=MESH_SEED,
                  temperature=job.get("temperature", 1.0), top_k=job.get("top_k", 0),
                  top_p=job.get("top_p", 0.0), env=job.get("env", {}))
    if job["model"] == "prior":
        encoder, prior, codebook_size, _, _ = prior_parts(gen)
        return dict(common, kind="sample_prior", model=prior, encoder=encoder,
                    codebook_size=codebook_size, num_codes=PRIOR_SAMPLE_CODES,
                    x_init=np.zeros((PRIOR_SAMPLE_BATCH, PRIOR_CODES), np.int64),
                    start=0, num_steps=PRIOR_SAMPLE_CODES)
    vocab = synthetic_vocabulary()
    encoder, decoder = build_models(vocab, kind=job["model"])
    encoder.cuda()
    templates = random_templates(vocab, gen, BATCH, NUM_EVENTS)
    init_codebook(encoder, templates, gen)
    steps = NUM_EVENTS * 4 if job["model"] == "flagship" else SAMPLE_ABSOLUTE_STEPS
    return dict(common, kind="sample_decoder", model=decoder, encoder=encoder,
                templates=templates.cpu().numpy(), codebook_size=CODEBOOK_SIZE,
                tokens_init=np.zeros((BATCH, NUM_EVENTS, 4), np.int64), start=0,
                num_steps=steps)


def mesh_samplers(rank: int, world_size: int, spec: dict) -> list:
    """One rank of (e), started by launch.run_ranks: spec["jobs"] through
    torch_mesh_harness.train_over_mesh (sample_job over make_mesh), TF32
    off as in this script's process."""
    from torch_mesh_harness import train_over_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for job in spec["jobs"]:
        payload = _sampler_payload(job)
        result = train_over_mesh(rank, world_size, payload)
        result["local"] = result["local"].astype(np.int32)
        result["tokens"] = result["tokens"].astype(np.int32)
        out.append(result)
        del payload
        torch.cuda.empty_cache()
    return out


def _mesh_samplers() -> dict:
    """(e); returns {"launches" (summed over the ranks and the jobs),
    "jobs" (by name and mesh: tied rows, code-tied rows, equal share,
    gloo-on-one-card and one-rank tokens/s)}."""
    from torch_mesh_harness import (BF16_STEP, CODE_TIE_REL, sample_job, token_ties,
                                    with_env)
    from vqcpcb_tpu_torch.parallel.launch import run_ranks
    from vqcpcb_tpu_torch.parallel.mesh import Mesh
    jobs = [dict(job, num_model=m, mesh=f"({4 // m}, {m})")
            for job in SAMPLE_JOBS for m in job.get("models", (2, 1))]
    t0 = time.perf_counter()
    results = run_ranks("chip_smoke:mesh_samplers", 4, {"jobs": jobs},
                        timeout_s=MESH_RANKS_TIMEOUT_S, backend="gloo", threads=2)
    log(f"# (e) samplers over 4 gloo ranks sharing the card: run_ranks wall "
        f"{time.perf_counter() - t0:.1f} s")
    references, launches, out = {}, {}, {}
    for j, job in enumerate(jobs):
        if job["name"] not in references:
            payload = _sampler_payload(job)
            references[job["name"]] = with_env(
                payload["env"], lambda: sample_job(payload, Mesh(1, 1), record=True))
            references[job["name"]]["tokens_per_s"] = (
                len(payload["x_init" if job["model"] == "prior" else "tokens_init"])
                * payload["num_steps"] / references[job["name"]]["seconds"])
            del payload
            torch.cuda.empty_cache()
        ref = references[job["name"]]
        ranks = [r[j] for r in results]
        label = f"{job['name']} over {job['mesh']}"
        per_job = {}
        for r in ranks:
            for key, n in r["launches"].items():
                per_job[key] = per_job.get(key, 0) + n
        for key, n in per_job.items():
            launches[key] = launches.get(key, 0) + n
        need = {"flagship": ("relbias_attention_fwd", "vq_nearest"),
                "prior": ("relbias_attention_fwd",),
                "absolute": ("fused_attention", "vq_nearest")}[job["model"]]
        missing = [k for k in need if not per_job.get(k)]
        k7 = {k: per_job.get(k, 0) for k in K7_WRAPPERS if per_job.get(k, 0)}
        if missing or k7:
            raise AssertionError(f"(e) {label}: no launch of {missing}, or K7 "
                                 f"launches {k7}")
        tokens = ranks[0]["tokens"]
        if any(not np.array_equal(r["tokens"], tokens) for r in ranks):
            raise AssertionError(f"(e) {label}: the ranks hold different tokens")
        by_rows = {}
        for r in ranks:
            by_rows.setdefault(r["rows"], []).append(r["local"])
        if any(not np.array_equal(x, local[0]) for local in by_rows.values()
               for x in local):
            raise AssertionError(f"(e) {label}: model ranks of one data index "
                                 "sampled different rows")
        code_tied = []
        if ranks[0]["codes"] is not None:
            differ = np.nonzero((ranks[0]["codes"] != ref["codes"]).reshape(
                len(tokens), -1).any(-1))[0]
            far = [int(row) for row in differ if ref["code_margins"][row] > CODE_TIE_REL]
            if far:
                raise AssertionError(f"(e) {label}: codes differ from one rank's "
                                     f"away from a near tie in rows {far[:8]}")
            code_tied = [int(row) for row in differ]
        tie_rel = CODE_TIE_REL if job["model"] == "absolute" else BF16_STEP
        ties = token_ties(tokens, ref["tokens"].astype(np.int32), ref["margins"], 0,
                          tie_rel, skip_rows=set(code_tied))
        greedy = job.get("top_k") == 1
        steps = ref["margins"].shape[1]
        tokens_per_s = len(tokens) * steps / ranks[0]["seconds"]
        out[label] = dict(tied_rows=len(ties["tied"]), faults=len(ties["faults"]),
                          code_tied_rows=len(code_tied), rows=ties["rows"],
                          equal_share=ties["equal_share"], tie_margin=ties["tie_margin"],
                          gloo_one_card_tokens_per_s=tokens_per_s,
                          one_rank_tokens_per_s=ref["tokens_per_s"],
                          launches={k: v for k, v in per_job.items() if v})
        log(f"# (e) {label}: {'greedy' if greedy else 'stochastic'}, {ties['rows']} rows x "
            f"{steps} draws; vs one rank on the card: equal share "
            f"{ties['equal_share']:.6f}, rows differing at a near tie (<= {tie_rel:.3e}) "
            f"{len(ties['tied'])} (largest margin {ties['tie_margin']:.3e}), elsewhere "
            f"{len(ties['faults'])}, rows left out at a code near tie {len(code_tied)}; "
            f"{tokens_per_s:.1f} tokens/s with 4 gloo ranks sharing one card (not a "
            f"speed of the mesh), one rank {ref['tokens_per_s']:.1f}; launches summed "
            f"over the ranks {json.dumps(out[label]['launches'])}")
        if greedy and ties["faults"]:
            raise AssertionError(f"(e) {label}: greedy rows {ties['faults'][:8]} differ "
                                 "from one rank's away from a near tie")
    return dict(launches=launches, jobs=out)


def phase_mesh(gen: torch.Generator, encoder_config: str) -> dict:
    """Phase 17; see the comment above MESHES. Returns {"shards" ((a)),
    "launches" (the main path's: (b) in this process and (c)'s ranks, as a
    Launches), "k7" (the K7 wrappers' main-path launches), "gloo", "nccl"}."""
    shards = _mesh_shards(gen)
    cli_launches, cli_seconds, encoder_cli_launches, epoch_ms = _mesh_clis(encoder_config)
    gloo = _mesh_ranks_on_one_card()
    _hold_mesh_gaps(gloo["gaps"])
    nccl = _mesh_nccl_gpus()
    samplers = _mesh_samplers()
    ranks = {k: gloo["launches"].get(k, 0) + samplers["launches"].get(k, 0)
             for k in set(gloo["launches"]) | set(samplers["launches"])}
    launches = Launches({k: cli_launches[k] + ranks.get(k, 0) for k in cli_launches})
    launches.by_kind = {kind: cli_launches.by_kind[kind]
                        + ranks.get(f"vq_nearest/{kind}", 0)
                        for kind in cli_launches.by_kind}
    encoder_side = {k: encoder_cli_launches.get(k, 0) + gloo["encoder_launches"].get(k, 0)
                    for k in ("vq_nearest",) + tuple(K7_WRAPPERS)}
    log(f"# [mesh] main-path launches: (b) {json.dumps(dict(cli_launches))}, "
        f"(c) {json.dumps({k: v for k, v in gloo['launches'].items() if v})}, "
        f"(e) {json.dumps({k: v for k, v in samplers['launches'].items() if v})}; of them the "
        f"encoder side's (the encoder CLI calls and (c)'s encoder jobs): K1 and K7 "
        f"{json.dumps(encoder_side)}; CLI seconds "
        f"{json.dumps({k: round(v, 2) for k, v in cli_seconds.items()})}")
    return dict(shards=shards, launches=launches, k7=gloo["k7"], gloo=gloo,
                nccl=nccl, encoder_side=encoder_side, encoder_cli_epoch_ms=epoch_ms,
                cli_seconds=cli_seconds, samplers=samplers["jobs"],
                sampler_launches=samplers["launches"])


# ---- phase 18 --------------------------------------------------------------

# The f32 route: VQCPCB_PALLAS_BF16_DOTS=0 (the attention kernels' f32-dot
# instances) with VQCPCB_COMPUTE_DTYPE=float32 (the layers in f32), on the
# in-kernel relative bias. (a) The f32-dot kernels at the flagship's shapes,
# each against its plain version with f32 dots within F32_FRAC of
# max(1, max |value|): K2-fwd and K2-bwd (csrc/attention_fwd_f32.cuh with
# the bias window; csrc/attention_bwd_f32.cuh's streamed rows kernel, then
# the cols and table kernels) at the training batch, T = S = 384 causal,
# packed, dropout 0.2, their dropout masks bit for bit (the forward's
# dropped weights read through one-hot v, the backward's w_drop scratch);
# K3-fwd at the serving batch 512, causal 384 x 384 and 384 x 24 (ratio 16);
# K6-bwd f32 (the same rows kernel with an explicit bias) at the training
# batch with a real bias, its mask bit for bit. Each timed beside its plain
# version, its bound (K4's yardstick: f32 bytes at 3.35 TB/s, the live
# entries' products at the 3xTF32 rate) and one SDPA call on f32 inputs with
# the mask and the bias as one float mask (its backward by device time).
# (b) The flagship at full width on that route: encode and sample_range at
# 512 x 384 (tokens/s, the prefill's ms, its launches), teacher-forced
# logits at batch 8 against the CPU plain route within F32_LOGITS_RTOL of
# the max |logit|; (c) 30 train steps at batch 32, dropout 0.2 (ms/step,
# tokens/s, a falling loss), then the kernel route against the CPU f32
# plain route at batch 2, dropout 0: the loss within F32_LOSS_RTOL
# relative, every gradient's relative L2 gap within F32_GRAD_L2.
F32_ENV = {"VQCPCB_COMPUTE_DTYPE": "float32", "VQCPCB_PALLAS_BF16_DOTS": "0"}
F32_FRAC = 1e-5
F32_LOGITS_RTOL = 1e-4
F32_LOSS_RTOL = 1e-5
F32_GRAD_L2 = 1e-4


def _f32_hold(what, names, got, want, worst, key) -> str:
    """Each result within F32_FRAC of max(1, its plain max |value|); keeps
    the largest absolute error in worst[key]; returns the log's numbers."""
    line = []
    for name, a, w in zip(names, got, want):
        if (a is None) != (w is None):
            raise AssertionError(f"{what}: {name} returned on one side only")
        if a is None:
            continue
        err = (a.float() - w.float()).abs().max().item()
        scale = max(1.0, w.float().abs().max().item())
        worst[key] = max(worst[key], err)
        line.append(f"{name} {err:.2e}/{scale:.3g}")
        if not err <= F32_FRAC * scale:
            raise AssertionError(f"{what}: {name} err {err} (limit {F32_FRAC * scale})")
    return ", ".join(line)


def _f32_bounds(b, t, s, mask, bias_bytes=0):
    """(forward, relative-bias backward, K6 backward) bounds at one shape:
    f32 q-side (T) and k-side (S) tensors once each, the mask and the
    table (read, and the table's gradient written), K6's bias and dbias
    (bias_bytes each); 3, 8 and 5 products of 2 d flops for each live mask
    entry of each plane at the 3xTF32 rate."""
    n = b * HEADS
    live = t * s if mask is None else int((mask > -1e29).sum().item())
    act, kv = 4 * n * t * HEAD_DIM, 4 * n * s * HEAD_DIM
    side = (0 if mask is None else 4 * t * s)
    table = 4 * HEADS * (2 * s - 1) * HEAD_DIM
    flops = 2 * HEAD_DIM * n * live
    return (bound(2 * act + 2 * kv + side + table, 3 * flops, F32_ACCURATE_FLOPS),
            bound(3 * act + 4 * kv + side + 2 * table, 8 * flops, F32_ACCURATE_FLOPS),
            bound(3 * act + 4 * kv + side + 2 * bias_bytes, 5 * flops,
                  F32_ACCURATE_FLOPS))


def _f32_planes(x, b, t, s):
    """The (B, H, T, S) values of an f32-dot backward's scratch (row stride S)."""
    return x[:b * HEADS * t * s].view(b, HEADS, t, s)


def _f32_masks(what, live, keep, fwd_rows, wd_scratch) -> None:
    """The forward's dropped weights and the backward's w_drop scratch are
    not 0 exactly where the hash keeps a live weight."""
    want = keep & live
    differ = [((x != 0) & live != want).sum().item() for x in (fwd_rows, wd_scratch)]
    log(f"# [f32] {what}: dropout mask vs the hash, forward {differ[0]} and "
        f"backward scratch {differ[1]} of {want.numel()} entries differ (need 0)")
    if any(differ):
        raise AssertionError(f"{what}: dropout masks differ at {differ} entries")


def _f32_profile(fn, label: str) -> None:
    """Device time by kernel of three calls of fn (where a backward's time
    goes)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall_s = synced_seconds(lambda: [fn() for _ in range(3)])
    _log_profile(prof, wall_s, f"[f32] 3 calls of {label}", 6)


def _f32_kernels(gen) -> dict:
    """(a); returns the numbers of the kernels line by kernel."""
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    from vqcpcb_tpu_torch.ops import fused_attention_kernels as fk
    from vqcpcb_tpu_torch.ops._kernel_io import bwd_scratch
    from vqcpcb_tpu_torch.ops.relative_attention import subsampled_relative_bias
    import torch.nn.functional as F
    f32 = torch.float32
    worst = {"fwd": 0.0, "bwd": 0.0, "k6": 0.0}
    cuda = (ak.relbias_attention_fwd_cuda, ak.relbias_attention_bwd_cuda)
    plain = (ak.relbias_attention_fwd_plain, ak.relbias_attention_bwd_plain)

    # K2 at the training batch, packed f32, dropout 0.2
    b, t = TRAIN_BATCH, 384
    q, k, v, mask, e1, e2, g = _train_inputs(gen, b, t, t, "causal", True)
    kw = dict(num_heads=HEADS, dropout=TRAIN_DROPOUT, seed=7)
    scratch = bwd_scratch(b, HEADS, t, t, f32, "cuda")
    got = [cuda[0](q, k, v, mask, e1, e2, f32, **kw),
           *cuda[1](q, k, v, mask, e1, e2, g, f32, need_dmask=True,
                    scratch=scratch, **kw)]
    want = _fwd_bwd(*plain, q, k, v, mask, e1, e2, g, f32, need_dmask=True, **kw)
    torch.cuda.synchronize()
    line = ", ".join((_f32_hold("K2-fwd f32", ("out",), got[:1], want[:1], worst, "fwd"),
                      _f32_hold("K2-bwd f32", TRAIN_RESULTS[1:], got[1:], want[1:],
                                worst, "bwd")))
    if got[-1].any():
        raise AssertionError("K2 f32: e2's gradient under the causal mask is not 0")
    again = cuda[1](q, k, v, mask, e1, e2, g, f32, need_dmask=False, **kw)
    for name, a, a2 in zip(TRAIN_RESULTS[1:], got[1:], again):
        if name != "dmask" and not torch.equal(a, a2):
            raise AssertionError(f"K2-bwd f32: a second backward's {name} differs")
    del got, want, again
    live = ak.relbias_attention_bwd_weights_plain(
        q, k, v, mask, e1, e2, g, f32, **dict(kw, dropout=0.0))[0] > 0
    keep = ak.dropout_keep_plain((t, t), TRAIN_DROPOUT,
                                 ak._stream_seeds(kw["seed"], b, HEADS, "cuda"))
    rows = _dropped_rows(cuda[0], q, k, v, mask, (e1, e2),
                             dict(kw, dot_dtype=f32), t)
    _f32_masks(f"K2 (B={b}, T=S={t})", live, keep, rows,
               _f32_planes(scratch[1], b, t, t))
    del rows, live, keep, scratch
    torch.cuda.empty_cache()
    fwd = lambda: cuda[0](q, k, v, mask, e1, e2, f32, **kw)            # noqa: E731
    bwd = lambda: cuda[1](q, k, v, mask, e1, e2, g, f32,               # noqa: E731
                          need_dmask=False, **kw)
    fwd_ms, fwd_dev = time_cuda(fwd, 20), device_ms(fwd, 20)
    bwd_ms, bwd_dev = time_cuda(bwd, 5), device_ms(bwd, 5)
    _f32_profile(bwd, f"K2-bwd f32 (B={b}, T=S={t})")
    fwd_plain = time_cuda(lambda: plain[0](q, k, v, mask, e1, e2, f32, **kw), 3,
                          warmup=1)
    bwd_plain = time_cuda(lambda: plain[1](q, k, v, mask, e1, e2, g, f32,
                                           need_dmask=False, **kw), 3, warmup=1)
    q4, k4, v4, g4 = (_split_heads(x).contiguous() for x in (q, k, v, g))
    attn = (mask + subsampled_relative_bias(q4, e1, e2)).contiguous()
    leaves = [x.detach().requires_grad_(True) for x in (q4, k4, v4, attn)]
    sdpa = lambda: F.scaled_dot_product_attention(                     # noqa: E731
        *leaves[:3], attn_mask=leaves[3], dropout_p=TRAIN_DROPOUT, scale=1.0)
    lib_fwd = time_cuda(sdpa, 10, warmup=2)
    out = sdpa()
    sdpa_bwd = lambda: torch.autograd.grad(out, leaves, g4,            # noqa: E731
                                           retain_graph=True)
    lib_bwd = device_ms(sdpa_bwd, 10)
    del out, leaves, attn, q4, k4, v4, g4
    fwd_b, bwd_b, _ = _f32_bounds(b, t, t, mask)
    k2_fwd = dict(ms=fwd_ms, device_ms=fwd_dev, plain_ms=fwd_plain, library_ms=lib_fwd,
                  bound_ms=fwd_b[0], bound_by=fwd_b[1])
    k2_bwd = dict(ms=bwd_ms, device_ms=bwd_dev, plain_ms=bwd_plain, library_ms=lib_bwd,
                  bound_ms=bwd_b[0], bound_by=bwd_b[1])
    log(f"# [f32] K2 (B={b}, H={HEADS}, T=S={t} causal, packed f32, f32 dots, "
        f"dropout {TRAIN_DROPOUT}): err/max(1, max|value|) {line}; e2's gradient 0; "
        f"a second backward bit for bit; fwd {fwd_ms:.4f} ms (device {fwd_dev:.4f}; "
        f"plain {fwd_plain:.4f}, sdpa f32 {lib_fwd:.4f}, bound {fwd_b[0]:.5f} "
        f"{fwd_b[1]}); bwd {bwd_ms:.4f} ms (device {bwd_dev:.4f}; plain "
        f"{bwd_plain:.4f}, sdpa bwd {lib_bwd:.4f} device time, bound "
        f"{bwd_b[0]:.5f} {bwd_b[1]})")
    del q, k, v, g, e1, e2
    torch.cuda.empty_cache()

    # K3-fwd at the serving batch, (B, H, L, d) f32, no dropout
    inference = {}
    for label, s, kind in (("decoder self-attention", 384, "causal"),
                           ("ratio 16", 24, "anticausal_rect")):
        q, k, v, mask, e1, e2 = _relbias_inputs(gen, BATCH, 384, s, kind)
        got = cuda[0](q, k, v, mask, e1, e2, f32)
        want = plain[0](q, k, v, mask, e1, e2, f32)
        torch.cuda.synchronize()
        line = _f32_hold(f"K3-fwd f32 {label}", ("out",), [got], [want], worst, "fwd")
        del got, want
        torch.cuda.empty_cache()
        inf = lambda: cuda[0](q, k, v, mask, e1, e2, f32)              # noqa: E731
        ms, dev = time_cuda(inf, 5), device_ms(inf, 5)
        plain_ms = time_cuda(lambda: plain[0](q, k, v, mask, e1, e2, f32), 2, warmup=1)
        attn = (mask + subsampled_relative_bias(q, e1, e2)).contiguous()
        lib = time_cuda(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn, scale=1.0), 5, warmup=1)
        fb = _f32_bounds(BATCH, 384, s, mask)[0]
        inference[label] = dict(ms=ms, device_ms=dev, plain_ms=plain_ms,
                                library_ms=lib, bound_ms=fb[0], bound_by=fb[1], t=384,
                                s=s, batch=BATCH)
        log(f"# [f32] K3-fwd {label} (B={BATCH}, H={HEADS}, T=384, S={s}, f32, f32 "
            f"dots): err/max(1, max|value|) {line}; {ms:.4f} ms (device {dev:.4f}; "
            f"plain {plain_ms:.4f}, sdpa f32 {lib:.4f}, bound {fb[0]:.5f} {fb[1]})")
        del q, k, v, e1, e2, attn
        torch.cuda.empty_cache()

    # K6 with f32 dots and a real bias at the training batch, packed
    t = 384
    q, k, v = _projected(gen, b, t, t, f32)
    g = torch.randn(q.shape, generator=gen, device="cuda")
    mask = _fused_mask("causal", t, t)
    bias = torch.randn((b * HEADS, t, t), generator=gen, device="cuda")
    kw = dict(num_heads=HEADS, dropout=TRAIN_DROPOUT, seed=9)
    fcuda = (fk.fused_attention_train_fwd_cuda, fk.fused_attention_train_bwd_cuda)
    fplain = (fk.fused_attention_train_fwd_plain, fk.fused_attention_train_bwd_plain)
    scratch = bwd_scratch(b, HEADS, t, t, f32, "cuda")
    got = [fcuda[0](q, k, v, mask, bias, f32, **kw),
           *fcuda[1](q, k, v, mask, bias, g, f32, need_dmask=True, scratch=scratch,
                     **kw)]
    want = _fused_fwd_bwd(*fplain, q, k, v, mask, bias, g, f32, need_dmask=True, **kw)
    torch.cuda.synchronize()
    line = _f32_hold("K6 f32", FUSED_RESULTS, got, want, worst, "k6")
    again = fcuda[1](q, k, v, mask, bias, g, f32, need_dmask=False, **kw)
    for name, a, a2 in zip(FUSED_RESULTS[1:], got[1:], again):
        if a2 is not None and not torch.equal(a, a2):
            raise AssertionError(f"K6-bwd f32: a second backward's {name} differs")
    del got, want, again
    w = fk.fused_attention_train_bwd_weights_plain(q, k, v, mask, bias, g, f32,
                                                   **dict(kw, dropout=0.0))[0]
    keep = ak.dropout_keep_plain((t, t), TRAIN_DROPOUT,
                                 fk.flat_stream_seeds(kw["seed"], b, HEADS, "cuda"))
    rows = _dropped_rows(fcuda[0], q, k, v, mask, (bias,), dict(kw, dot_dtype=f32), t)
    _f32_masks(f"K6 (B={b}, T=S={t}, real bias)", w > 0, keep, rows,
               _f32_planes(scratch[1], b, t, t))
    del w, keep, rows, scratch
    torch.cuda.empty_cache()
    bwd = lambda: fcuda[1](q, k, v, mask, bias, g, f32,                # noqa: E731
                           need_dmask=False, **kw)
    bwd_ms, bwd_dev = time_cuda(bwd, 5), device_ms(bwd, 5)
    _f32_profile(bwd, f"K6-bwd f32 (B={b}, T=S={t}, real bias)")
    bwd_plain = time_cuda(lambda: fplain[1](q, k, v, mask, bias, g, f32,
                                            need_dmask=False, **kw), 3, warmup=1)
    q4, k4, v4, g4 = (_split_heads(x).contiguous() for x in (q, k, v, g))
    attn = (mask + bias.view(b, HEADS, t, t)).contiguous()
    leaves = [x.detach().requires_grad_(True) for x in (q4, k4, v4, attn)]
    out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3],
                                         dropout_p=TRAIN_DROPOUT, scale=1.0)
    lib_bwd = device_ms(lambda: torch.autograd.grad(out, leaves, g4, retain_graph=True), 10)
    del out, leaves, attn, q4, k4, v4, g4
    kb = _f32_bounds(b, t, t, mask, bias_bytes=4 * b * HEADS * t * t)[2]
    k6_bwd = dict(ms=bwd_ms, device_ms=bwd_dev, plain_ms=bwd_plain, library_ms=lib_bwd,
                  bound_ms=kb[0], bound_by=kb[1], max_abs_err=worst["k6"])
    log(f"# [f32] K6 (B={b}, H={HEADS}, T=S={t} causal, packed f32, real bias, f32 "
        f"dots, dropout {TRAIN_DROPOUT}): err/max(1, max|value|) {line}; a second "
        f"backward bit for bit; bwd {bwd_ms:.4f} ms (device {bwd_dev:.4f}; plain "
        f"{bwd_plain:.4f}, sdpa bwd {lib_bwd:.4f} device time, bound {kb[0]:.5f} "
        f"{kb[1]})")
    del q, k, v, g, bias
    torch.cuda.empty_cache()
    return dict(fwd=dict(k2_fwd, max_abs_err=worst["fwd"], inference=inference),
                bwd=dict(k2_bwd, max_abs_err=worst["bwd"]), k6_bwd=k6_bwd)


def _f32_serving(gen) -> dict:
    """(b): the flagship's serving path on the f32 route."""
    from vqcpcb_tpu_torch.training.decoder_trainer import DecoderGenerator
    vocab = synthetic_vocabulary()
    encoder, decoder = build_models(vocab, kind="flagship")
    generator = DecoderGenerator(encoder, decoder, vocab, CODEBOOK_SIZE, seed=0)
    templates = random_templates(vocab, gen, BATCH, NUM_EVENTS)
    init_codebook(encoder, templates, gen)
    warm_codes = generator.encode_codes(templates[:8])
    decoder.sample_range(warm_codes, templates[:8], 0, 8, generator.generator,
                         temperature=0.95, top_p=0.8)
    torch.cuda.synchronize()
    reset_counts()
    codes, encode_s = synced_seconds(lambda: generator.encode_codes(templates))
    after_encode = counts()
    tokens0 = torch.zeros((BATCH, NUM_EVENTS, 4), dtype=torch.int32, device="cuda")
    n_tok = NUM_EVENTS * 4
    sampled, sample_s = synced_seconds(lambda: decoder.sample_range(
        codes, tokens0, 0, n_tok, generator.generator, temperature=0.95, top_p=0.8))
    main_counts = counts()
    prefill = _delta(main_counts, after_encode)
    want = {k: 6 if k in ("relbias_attention_fwd", "relbias_attention_fwd_f32") else 0
            for k in prefill}
    if after_encode["vq_nearest"] < 1 or prefill != want:
        raise AssertionError(f"[f32] encode launched {dict(after_encode)}, one prefill "
                             f"{prefill}, not {want}")
    sizes = torch.tensor(vocab.num_tokens_per_channel, device="cuda")
    if codes.min() < 0 or codes.max() >= CODEBOOK_SIZE or not (
            (sampled >= 0) & (sampled < sizes)).all():
        raise AssertionError("[f32] codes or sampled tokens outside their range")
    tokens_per_s = BATCH * n_tok / sample_s
    with torch.no_grad():
        _, prefill_s = synced_seconds(lambda: decoder.prefill(codes, tokens0, torch.int8))
        small_codes, small = codes[:8], sampled[:8]
        kernel_logits = decoder(small_codes, small)["weights_per_category"]
        plain = copy.deepcopy(decoder).cpu()
        plain_logits = plain(small_codes.cpu(), small.cpu())["weights_per_category"]
    scale = max(lg.abs().max().item() for lg in plain_logits)
    err = max((k.cpu() - p).abs().max().item()
              for k, p in zip(kernel_logits, plain_logits))
    log(f"# [f32] (b) flagship serving, f32 route: encode_codes {BATCH} templates "
        f"{encode_s * 1e3:.3f} ms; sample_range batch {BATCH} x {n_tok} positions (T "
        f"0.95, top_p 0.8, int8 caches) {sample_s:.4f} s, {tokens_per_s:.1f} tokens/s; "
        f"one prefill launched K3-fwd's f32-dot instance 6 times and no other attention "
        f"kernel; prefill alone {prefill_s * 1e3:.3f} ms; logits at batch 8 vs the CPU "
        f"plain route: max abs err {err:.3e}, max |logit| {scale:.3f} (need <= "
        f"{F32_LOGITS_RTOL} x max |logit|)")
    if not err <= F32_LOGITS_RTOL * scale:
        raise AssertionError(f"[f32] kernel-route logits differ by {err}")
    return dict(launches=main_counts, encode_ms=encode_s * 1e3, tokens_per_s=tokens_per_s,
                prefill_ms=prefill_s * 1e3, logits_err=err)


def _f32_training(gen) -> dict:
    """(c): 30 flagship train steps on the f32 route, then the kernel route
    against the CPU f32 plain route at batch 2."""
    trainer, batches = _trainer(gen, "flagship")
    result = train_steps(trainer, batches, TRAIN_STEPS, "flagship_f32", must_fall=True)
    from torch_mesh_harness import ReluPins
    dec = trainer.decoder
    set_dropout(dec, 0.0)
    small = batches[0][:2]
    codes = trainer.encode_codes(small)
    with ReluPins() as record:
        loss_p, grads_p = loss_and_grads(copy.deepcopy(dec).cpu(), codes.cpu(),
                                         small.cpu(), bf16=False)

    def gaps(grads_k):
        l2 = {}
        for name, gp in grads_p.items():
            norm = gp.norm().item()
            gap = (grads_k[name] - gp).norm().item()
            l2[name] = gap / norm if norm else (0.0 if gap == 0 else float("inf"))
        return sorted(l2.items(), key=lambda kv: -kv[1]), np.median(list(l2.values()))

    # free, then with the feed-forward ReLU units whose pre-activation lies
    # within rounding of 0 pinned to the CPU route's sign (phase 17's
    # ReluPins): such a unit that flips moves its layer's gradients by a
    # token's whole term, which no kernel's rounding explains
    free, free_median = gaps(loss_and_grads(dec, codes, small, bf16=False)[1])
    with ReluPins(record.pins) as pinned:
        loss_k, grads_k = loss_and_grads(dec, codes, small, bf16=False)
    worst, median = gaps(grads_k)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    line = lambda w: ", ".join(f"{n} {v:.3e}" for n, v in w[:3])   # noqa: E731
    log(f"# [f32] (c) batch 2, dropout 0, kernel route vs CPU f32 plain route: loss "
        f"{loss_k:.7f} vs {loss_p:.7f} (relative {loss_err:.3e}, need <= "
        f"{F32_LOSS_RTOL}); gradients' relative L2 gaps over {len(worst)} parameters, "
        f"ReLU units free: largest {line(free)}, median {free_median:.3e}; pinned "
        f"({json.dumps(pinned.flips)} units by call, largest pre-activation gap "
        f"{pinned.gap:.3e}): largest {line(worst)}, median {median:.3e} (need each "
        f"<= {F32_GRAD_L2})")
    if not loss_err <= F32_LOSS_RTOL or worst[0][1] > F32_GRAD_L2:
        raise AssertionError("[f32] the kernel route and the CPU f32 route disagree")
    return dict(result, loss_err=loss_err, grad_l2=worst[0][1], grad_l2_free=free[0][1],
                relu_flips=sum(pinned.flips))


def f32_route(out_path: str) -> None:
    """Phase 18's work, in a process of its own (phase_f32_route): the
    kernels' numbers and serving's and training's results, their main-path
    launches with K1's by kind, as JSON in out_path."""
    from torch_mesh_harness import with_env
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = with_env(F32_ENV, lambda: dict(kernels=_f32_kernels(gen),
                                         serving=_f32_serving(gen),
                                         training=_f32_training(gen)))
    for part in ("serving", "training"):
        launches = out[part]["launches"]
        out[part]["launches"] = dict(launches, by_kind=launches.by_kind)
    with open(out_path, "w") as f:
        json.dump(out, f)


def phase_f32_route() -> dict:
    """Phase 18; see the comment above F32_ENV. Runs in a process of its
    own: after phase 17's ranks torch.profiler records no (or partial)
    device time in this one, and phase 18 times by device time. Returns
    the kernels' numbers, and serving's and training's results with their
    main-path launches (Launches)."""
    root = os.path.dirname(os.path.abspath(__file__))
    out_path = os.path.join(root, "build", "phase18.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    torch.cuda.empty_cache()
    subprocess.run([sys.executable, "-c",
                    "import sys, chip_smoke; chip_smoke.f32_route(sys.argv[1])",
                    out_path], cwd=root, check=True, timeout=600)
    with open(out_path) as f:
        out = json.load(f)
    for part in ("serving", "training"):
        raw = out[part]["launches"]
        launches = Launches({k: v for k, v in raw.items() if k != "by_kind"})
        launches.by_kind = raw["by_kind"]
        out[part]["launches"] = launches
    return out


# ---- phase 19 ----------------------------------------------------------------

# The three decoders at full width, batch 8: the kernel counter of their
# inference attentions, its launches in the forward that collects the maps
# (the memory encoder's 3 self-attentions; the decoder stack, which gives
# the maps, takes the plain route) and in one eval forward without
# collection (3 encoder + 3 decoder self-attentions, plus 3
# cross-attentions for an attention cross branch).
MAP_DECODERS = (("flagship", "relbias_attention_fwd", 3, 6),
                ("relative_acac", "relbias_attention_fwd", 3, 9),
                ("absolute", "fused_attention", 3, 9))
MAP_BATCH = 8
MAP_ATOL = 1e-5         # the card's plain route against the CPU's, f32, TF32 off
MAP_ROW_ATOL = 1e-5     # each weights row sums to 1
MAP_LOSS_RTOL = 1e-4    # the collected forward's loss against the kernels'
PLOT_PACKAGES = ("matplotlib", "seaborn")


def _map_names(attentions) -> list:
    """layer{i}_{name}.pdf of every map that is not None, in the dump's order."""
    return [f"layer{i}_{name}.pdf" for i, att in enumerate(attentions)
            for name in ("a_self_decoder", "a_cross") if att[name] is not None]


def _stack_maps_on_cpu(dec, codes, x) -> list:
    """The decoder stack's maps from the CPU plain route, fed the memory
    the card's forward attends to (the memory encoder runs the kernels
    there, K3-fwd with bf16 dots), so only the stack's plain route on the
    card is held against the CPU's."""
    from vqcpcb_tpu_torch.ops.masks import causal_mask
    with torch.no_grad():
        memory = dec.encode_memory(codes).cpu()
        cpu = copy.deepcopy(dec).cpu()
        tgt = cpu.shift_with_sos(cpu.embed_target(x.cpu()))
        t_len = tgt.shape[1]
        _, maps = cpu.transformer["decoder"](
            tgt, memory, causal_mask(t_len), cpu.cross_mask(memory.shape[1], t_len),
            collect_attentions=True)
    return maps


def _attention_maps_of(kind: str, kernel: str, memory_layers: int, layers: int,
                       gen, plots: bool, work: str) -> dict:
    """Phase 19 for one decoder of MAP_DECODERS; see phase_attention_maps."""
    from vqcpcb_tpu_torch.training.decoder_trainer import DecoderTrainer
    vocab = synthetic_vocabulary()
    encoder, decoder = build_models(vocab, kind=kind)
    trainer = DecoderTrainer(encoder, decoder, CODEBOOK_SIZE, seed=0,
                             model_dir=os.path.join(work, kind))
    x = random_templates(vocab, gen, MAP_BATCH, NUM_EVENTS)
    init_codebook(trainer.encoder, x, gen)
    dec = trainer.decoder.eval()

    # (a) the dump's path: encode, then the forward that collects the maps
    def collected():
        codes = trainer.encode_codes(x)
        return codes, dec(codes, x, collect_attentions=True)

    reset_counts()
    with torch.no_grad():
        (codes, out_a), seconds_a = synced_seconds(collected)
    main_counts = counts()
    want = {k: 0 for k in main_counts}
    want.update({"vq_nearest": 1, kernel: memory_layers})
    log(f"# [{kind}] (a) encode + collected forward at batch {MAP_BATCH}, "
        f"{seconds_a:.3f} s, launches {json.dumps(main_counts)} "
        f"(need {json.dumps(want)})")
    if main_counts != want:
        raise AssertionError(f"[{kind}] (a) launched {main_counts}, not {want}")
    maps_cpu = _stack_maps_on_cpu(dec, codes, x)
    names = _map_names(out_a["attentions_decoder"])
    if names != _map_names(maps_cpu) or \
            len(names) != (3 if kind == "flagship" else 6):
        raise AssertionError(f"[{kind}] (a) maps {names}")
    map_err = row_err = 0.0
    for got, want_cpu in zip(out_a["attentions_decoder"], maps_cpu):
        for name, w in got.items():
            if w is None:
                continue
            map_err = max(map_err, float((w.cpu() - want_cpu[name]).abs().max()))
            row_err = max(row_err, float((w.sum(-1) - 1).abs().max()))
    log(f"# [{kind}] (a) {len(names)} maps of "
        f"{tuple(out_a['attentions_decoder'][0]['a_self_decoder'].shape)}: "
        f"max |card - CPU| {map_err:.3e} (need <= {MAP_ATOL}), max |row sum "
        f"- 1| {row_err:.3e} (need <= {MAP_ROW_ATOL})")
    if not (map_err <= MAP_ATOL and row_err <= MAP_ROW_ATOL):
        raise AssertionError(f"[{kind}] (a) the card's maps disagree")

    # (b) the same forward without collection: the kernels in every layer
    reset_counts()
    with torch.no_grad():
        out_b, seconds_b = synced_seconds(lambda: dec(codes, x))
    b_counts = counts()
    want_b = {k: 0 for k in b_counts}
    want_b[kernel] = layers
    loss_err = abs(out_a["loss"].item() - out_b["loss"].item()) / abs(
        out_b["loss"].item())
    log(f"# [{kind}] (b) forward without collection {seconds_b:.3f} s, "
        f"launches {json.dumps(b_counts)} (need {json.dumps(want_b)}); loss "
        f"{out_b['loss'].item():.6f} vs (a)'s {out_a['loss'].item():.6f}, "
        f"relative {loss_err:.3e} (need <= {MAP_LOSS_RTOL})")
    if b_counts != want_b or out_b["attentions_decoder"] != []:
        raise AssertionError(f"[{kind}] (b) launched {b_counts}, maps "
                             f"{len(out_b['attentions_decoder'])}")
    if not loss_err <= MAP_LOSS_RTOL:
        raise AssertionError(f"[{kind}] (b) the losses disagree")

    # (c) the dump, where the plotting packages are installed
    written, seconds_c = [], None
    if plots:
        written, seconds_c = synced_seconds(lambda: trainer.dump_attention_maps(x))
        got_names = [os.path.basename(p) for p in written]
        log(f"# [{kind}] (c) dump_attention_maps: {len(written)} PDFs in "
            f"{seconds_c:.3f} s under {os.path.dirname(written[0])}")
        if got_names != names or not all(os.path.getsize(p) for p in written):
            raise AssertionError(f"[{kind}] (c) wrote {got_names}, not {names}")
    return dict(launches=main_counts, map_err=map_err, row_err=row_err,
                loss_err=loss_err, seconds=dict(a=seconds_a, b=seconds_b,
                                                c=seconds_c),
                written=len(written))


def phase_attention_maps(gen: torch.Generator, card: str) -> dict:
    """Phase 19: attention maps of the three decoders of MAP_DECODERS at full
    width, batch 8, random weights from a seed. (a) The dump's path (the
    main path): encode_codes and Decoder.forward(collect_attentions=True)
    launch K1 once and the inference attention kernel once a memory-encoder
    layer; the decoder stack takes the plain route and returns every map,
    held against the CPU plain route's on the same memory within MAP_ATOL,
    each row summing to 1. (b) The same forward without collection launches the kernel once a
    layer and returns no maps; the loss of (a) within MAP_LOSS_RTOL of its.
    (c) DecoderTrainer.dump_attention_maps writes one PDF a map, under the
    expected names, in build/phase19, where matplotlib and seaborn are
    installed; a line says which case held. Returns the main path's
    launches (Launches) and each decoder's results."""
    import importlib.util
    missing = [p for p in PLOT_PACKAGES if importlib.util.find_spec(p) is None]
    plots = not missing
    log("# [phase 19] plotting packages: " + (
        "matplotlib and seaborn found, (c) runs" if plots else
        f"{' and '.join(missing)} not installed, (c) skipped"))
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "phase19")
    launches = None
    results = {}
    for kind, kernel, memory_layers, layers in MAP_DECODERS:
        out, seconds = synced_seconds(lambda: _attention_maps_of(
            kind, kernel, memory_layers, layers, gen, plots, work))
        results[kind] = dict(out, phase_seconds=seconds)
        log(f"# [{kind}] phase 19: {seconds:.3f} s ({card})")
        if launches is None:
            launches = out["launches"]
        else:
            by_kind = {k: launches.by_kind[k] + out["launches"].by_kind[k]
                       for k in launches.by_kind}
            launches = Launches({k: launches[k] + out["launches"][k]
                                 for k in launches})
            launches.by_kind = by_kind
    return dict(launches=launches, decoders=results, plots=plots)


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
    t_start = time.perf_counter()

    def mark(label):   # where the smoke's time goes, phase by phase
        log(f"# [time] {label} done at {time.perf_counter() - t_start:.1f} s")

    card = phase_environment()
    phase_build()
    mark("build")
    gen = torch.Generator(device="cuda").manual_seed(0)
    vq = phase_vq(gen)
    mark("phase 3")
    rb = phase_relbias(gen)
    rb_train = phase_relbias_train(gen)
    rb_unmasked = phase_relbias_unmasked(gen)
    rb_prior = phase_relbias_prior(gen)
    fused = phase_fused(gen)
    mark("phases 4-6")
    profile = "--profile" in sys.argv[1:]
    by_path = {}
    serving = phase_serving(gen, profile, "flagship")
    by_path["serving"] = serving["launches"]
    training = phase_decoder_training(gen, profile, "flagship")
    by_path["decoder_training"] = training["launches"]
    by_path["absolute_serving"] = phase_serving(gen, profile, "absolute")["launches"]
    by_path["absolute_training"] = phase_decoder_training(gen, profile, "absolute")["launches"]
    by_path["explicit_bias"] = phase_explicit_bias(gen)["launches"]
    mark("phases 7-8")
    by_path["encoder_training"] = phase_encoder_training(gen, profile)["launches"]
    mark("phase 9")
    student = phase_student(gen, profile, card)
    by_path["student_training"] = student["launches"]
    by_path["student_absolute_training"] = student["absolute_launches"]
    by_path["transfo_encoder_training"] = student["transfo_launches"]
    mark("phase 10")
    entry_points = phase_entry_points(card)
    by_path["entry_points"] = entry_points["launches"]
    mark("phase 11")
    prior = phase_prior(gen, profile, card)
    by_path["prior_training"] = prior["launches"]
    by_path["prior_sampling"] = prior["sampling_launches"]
    mark("phase 12")
    by_path["scaleup_midi"] = phase_scaleup_midi(card)["launches"]
    mark("phase 14")
    by_path.update(phase_unquantized_and_grouped(
        gen, card, entry_points["encoder_config"],
        dict(serving_tokens_per_s=serving["tokens_per_s"],
             serving_prefill_ms=serving["prefill_ms"],
             train_ms=training["step_ms"], prior_train_ms=prior["step_ms"],
             prior_codes_per_s=prior["sample_codes_per_s"]))["launches"])
    mark("phase 15")
    by_path.update(phase_migrated(card)["launches"])
    mark("phase 16")
    mesh = phase_mesh(gen, entry_points["encoder_config"])
    by_path["mesh"] = mesh["launches"]
    mark("phase 17")
    f32_route = phase_f32_route()
    by_path["f32_serving"] = f32_route["serving"]["launches"]
    by_path["f32_training"] = f32_route["training"]["launches"]
    mark("phase 18")
    by_path["attention_maps"] = phase_attention_maps(gen, card)["launches"]
    mark("phase 19")
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
              launches_by_kind=k1_kinds, redesigned=True,
              mesh_row_shards_held=mesh["shards"]["k1_held"],
              encoder_mesh_launches=mesh["encoder_side"]["vq_nearest"]),
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
        # the f32-dot instances (VQCPCB_PALLAS_BF16_DOTS=0; phase 18): times
        # at the flagship training shape (B=32, T=S=384 causal, packed f32,
        # dropout 0.2), K3-fwd's at the serving batch under "inference";
        # their launches are counted within the entries above too
        entry("relbias_attention_fwd_f32", "vqcpcb_tpu_torch/csrc/attention_fwd_f32.cuh",
              f"{pa}:875", f"{pa}:_relbias_fwd_kernel_packed", [f"{pa}:571"],
              f32_route["kernels"]["fwd"], dots="f32",
              inference=f32_route["kernels"]["fwd"]["inference"],
              via="vqcpcb_tpu_torch/csrc/relbias_attention.cu"),
        entry("relbias_attention_bwd_f32", "vqcpcb_tpu_torch/csrc/attention_bwd_f32.cuh",
              f"{pa}:895", f"{pa}:_relbias_bwd_kernel_packed", [f"{pa}:582"],
              f32_route["kernels"]["bwd"], dots="f32",
              via="vqcpcb_tpu_torch/csrc/relbias_attention_bwd.cu"),
        # K6-bwd and K6-bwd-nobias with f32 dots (a real bias timed), and
        # K6-fwd's f32-dot launches (K4's kernel) beside them
        entry("fused_attention_train_bwd_f32", "vqcpcb_tpu_torch/csrc/attention_bwd_f32.cuh",
              f"{pa}:211", f"{pa}:_train_bwd_kernel", [f"{pa}:244"],
              f32_route["kernels"]["k6_bwd"], dots="f32",
              fwd_f32_launches=launches["fused_attention_train_fwd_f32"],
              via="vqcpcb_tpu_torch/csrc/fused_attention_bwd.cu"),
    ]
    # K7: the shard wrappers, the kernels above on each rank's (b_local,
    # h_local) planes; launches on the mesh path ((c)'s ranks), the shard
    # checks of (a), times of the packed wrapper's forward and backward on
    # (2, 2)'s shard at the flagship training shape
    shards = mesh["shards"]
    k7_errors = {name: max(w.values()) for name, w in shards["worst"].items()}
    kernels.append(dict(
        name="k7", route="cuda", source="vqcpcb_tpu_torch/ops/attention_kernels.py",
        replaces=f"{pa}:1045", pallas_counterpart=f"{pa}:fused_attention_train_relbias_packed_tp",
        also_replaces=list(K7_WRAPPERS.values())[1:],
        launches=sum(mesh["k7"].values()),
        launches_by_path={"mesh": sum(mesh["k7"].values())},
        max_abs_err=max(k7_errors.values()),
        **shards["timing"],
        wrappers=[dict(name=name, pallas_counterpart=site,
                       launches=mesh["k7"][name], shards_held=shards["held"][name],
                       max_abs_err=k7_errors[name])
                  for name, site in K7_WRAPPERS.items()],
        gloo_on_cuda=mesh["gloo"]["probe"],
        gloo_one_card_step_ms=mesh["gloo"]["step_ms"],
        encoder_mesh_launches={k: mesh["encoder_side"][k] for k in K7_WRAPPERS},
        encoder_cli_epoch_ms=mesh["encoder_cli_epoch_ms"],
        mesh_cli_seconds=mesh["cli_seconds"],
        mesh_samplers=mesh["samplers"],
        nccl_gpus=mesh["nccl"]))
    # the error is read under two names by readers of this line; one number
    for k in kernels:
        k["max_err"] = k["max_abs_err"]
    log(f"# device_ms: {len(DEVICE_TIME_FALLBACKS)} of its measurements timed "
        "with CUDA events after empty profiler sessions")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
