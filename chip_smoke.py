"""Smoke run of the PyTorch + CUDA port (vqcpcb_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py             # the smoke run
    python3 chip_smoke.py --profile   # plus profiler breakdowns of sampling,
                                      # of 3 decoder train steps and of 3
                                      # encoder train steps

Phases, in order; any failure raises and the run exits non-zero:
  1. environment: the card's name and power limit, torch / CUDA versions,
     TF32 off for matmuls and cuDNN (the comparisons below are in f32);
  2. build every CUDA kernel of the port from csrc/ with nvcc (sm_90a), one
     nvcc per source, all started together;
  3. nearest-codebook kernel vs its plain PyTorch version, timed by events
     and by device time at the serving shape and at the encoder-training
     shapes;
  4. relative-bias attention forward kernel (inference) vs its plain
     version and, at its three batch-8 shapes, the forward's bf16 weights
     bit for bit, timed beside its bound and beside
     scaled_dot_product_attention as a yardstick;
  5. relative-bias attention training kernels (forward and backward, with
     dropout, packed and (B, H, L, d) layouts, T/S = 1, 4 and 16) vs their
     plain versions, the dropout mask and, at batch 32, the forward's bf16
     w_drop and the backward's bf16 w_drop and ds scratch bit for bit, timed
     at the flagship training shape beside SDPA's autograd backward by its
     device time;
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
     steps at batch 32 with bf16 autocast and dropout 0.2 (falling loss,
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
 10. the entry points, the CLIs as a user calls them, in process in
     build/entry_points: the encoder CLI -t on
     configs/encoder_random_synthetic.py (60 batches, then the cluster
     dumps), the decoder CLI -t on configs/decoder_synthetic.py (the
     flagship, 40 batches at 64) over that encoder, -l -r and -l
     --num_examples 1, and the AC/AC/C decoder (decoder_type
     'transformer_relative') -t (10 batches) and -l -r; then the checks:
     exit codes, model directories and metrics rows, written tokens inside
     the vocabulary, the reloaded decoder's eval loss equal to the trained
     one's, one AC/AC/C step on the kernel route vs the f32 plain route;
 11. one JSON line of per-kernel numbers, then the result line.
The five runs of phases 7 and 8, the run of phase 9 (a) and the CLI calls of
phase 10 are the main paths: each is driven with the launch counts set to 0
just before it and read just after.

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
    """K1 against its plain version at the slices' shapes and at odd ones;
    timed by events and by device time at the serving shape (512 x 24 codes)
    and at the encoder-training shapes (the negatives' 16 x 15 x 6 windows,
    the 16 x 6 left or right blocks). The top-level numbers are the serving
    shape's, as since the kernel was first ported."""
    from vqcpcb_tpu_torch.ops import vq_kernels as vk
    dev = torch.device("cuda")
    timed = {}
    for n, k, d, s in [(BATCH * NUM_CODES, 1, 3, CODEBOOK_SIZE),
                       (ENC_NEG_ROWS, 1, 3, CODEBOOK_SIZE),
                       (ENC_BATCH * ENC_BLOCKS, 1, 3, CODEBOOK_SIZE),
                       (300, 2, 8, 16), (7, 1, 130, 200),
                       (1048576, 1, 3, CODEBOOK_SIZE)]:
        x = torch.randn((n, k, d), generator=gen, device=dev)
        e = torch.randn((k, s, d), generator=gen, device=dev)
        got = vk.nearest_codebook_indices_cuda(x, e)
        want = vk.nearest_codebook_indices_plain(x, e)
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
        log(f"# vq_nearest ({n},{k},{d},{s}): mismatches outside the margin "
            f"{bad}, rows inside the 1e-6 margin {near}, differing there "
            f"{((got != want) & ~margin).sum().item()}")
        if bad:
            raise AssertionError(f"vq_nearest disagrees with its plain version "
                                 f"on {bad} rows at ({n},{k},{d},{s})")
        if n in (BATCH * NUM_CODES, ENC_NEG_ROWS, ENC_BATCH * ENC_BLOCKS):
            ms = time_cuda(lambda: vk.nearest_codebook_indices_cuda(x, e), 200)
            dev_ms = device_ms(lambda: vk.nearest_codebook_indices_cuda(x, e), 200)
            plain_ms = time_cuda(lambda: vk.nearest_codebook_indices_plain(x, e), 50)
            bytes_moved = 4 * (x.numel() + e.numel() + n * k)
            flops = n * k * s * (2 * d + 3) + n * k * 2 * d
            bound_ms, bound_by = bound(bytes_moved, flops, F32_FLOPS)
            # error as distance: how much farther the kernel's code lies
            # than the plain version's (0 when every index agrees)
            err = (dist.gather(-1, got.long()[..., None])
                   - dist.gather(-1, want.long()[..., None])).abs().max().item()
            timed[f"({n},{k},{d},{s})"] = dict(
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
            log(f"# vq_nearest at ({n},{k},{d},{s}): kernel {ms:.5f} ms "
                f"(device {dev_ms:.5f} ms), plain {plain_ms:.5f} ms, bound "
                f"{bound_ms:.7f} ms ({bound_by})")
        elif n == 1048576:
            ms = time_cuda(lambda: vk.nearest_codebook_indices_cuda(x, e), 50)
            plain_ms = time_cuda(lambda: vk.nearest_codebook_indices_plain(x, e), 10)
            log(f"# vq_nearest at ({n},{k},{d},{s}): kernel {ms:.5f} ms, "
                f"plain {plain_ms:.5f} ms")
    serving = timed[f"({BATCH * NUM_CODES},1,3,{CODEBOOK_SIZE})"]
    return dict(serving, max_abs_err=max(t["max_abs_err"] for t in timed.values()),
                shapes=timed)


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
    mask = (causal_mask(t, device=dev) if mask_kind == "causal"
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
        # the dropout mask, bit for bit: with v the one-hot columns of a block
        # of 64 keys, the kernel's output is its dropped weight row there
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
    ak.launches = ak.bwd_launches = 0
    fk.launches = fk.train_fwd_launches = 0
    fk.train_bwd_launches = fk.train_bwd_nobias_launches = 0


def counts():
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    from vqcpcb_tpu_torch.ops import fused_attention_kernels as fk
    from vqcpcb_tpu_torch.ops import vq_kernels as vk
    return {"vq_nearest": vk.launches, "relbias_attention_fwd": ak.launches,
            "relbias_attention_bwd": ak.bwd_launches,
            "fused_attention": fk.launches,
            "fused_attention_train_fwd": fk.train_fwd_launches,
            "fused_attention_train_bwd": fk.train_bwd_launches,
            "fused_attention_train_bwd_nobias": fk.train_bwd_nobias_launches}


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

# Decoder loss and gradients, kernel route (bf16 autocast, bf16 dots in the
# attention kernels) against the CPU f32 plain route at dropout 0: every
# product of the layers rounds its inputs to bf16 (2**-9 relative), which
# moves the loss by well under 2% and leaves each gradient's direction within
# cosine 0.99 of the f32 one.
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


def loss_and_grads(decoder, codes, x, autocast: bool):
    decoder.train()
    decoder.zero_grad(set_to_none=True)
    with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
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
        f"tokens, bf16 autocast, dropout {TRAIN_DROPOUT}, Adam lr 1e-4 clip 5: "
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
    kernel = loss_and_grads(dec, codes, small, autocast=True)
    plain = loss_and_grads(copy.deepcopy(dec).cpu(), codes.cpu(), small.cpu(),
                           autocast=False)
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
        explicit = loss_and_grads(dec, small_codes, small, autocast=True)
    finally:
        del os.environ["VQCPCB_PALLAS_RELBIAS"]
    in_kernel = loss_and_grads(dec, small_codes, small, autocast=True)
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


def build_cpc_model(ema: bool):
    """The VQ-CPC model of bench.py:52-88 at full width, random weights from
    torch's init under a fixed seed: embedding 32, two independent 2-layer
    GRUs of 512 over blocks of 16 tokens, codebook 32 x 3 (one codebook,
    commitment 0.25), MLP upscaler 512 -> 32, CModule GRU 512 x 2 -> 32,
    FksModule k_max 6, dropout 0.1; quantization weighting 0.5. With `ema`,
    bench.py's trained-guard twin: the EMA quantizer (decay 0.99) and
    weighting 0.25."""
    from vqcpcb_tpu_torch.models.cpc import CModule, FksModule, VQCPCModel
    from vqcpcb_tpu_torch.models.data_processor import BachCPCDataProcessor
    from vqcpcb_tpu_torch.models.downscalers import GruDownscaler
    from vqcpcb_tpu_torch.models.encoder import Encoder
    from vqcpcb_tpu_torch.models.upscalers import MlpUpscaler
    from vqcpcb_tpu_torch.ops.quantizer import (EMAProductVectorQuantizer,
                                                ProductVectorQuantizer)
    torch.manual_seed(1 if ema else 0)
    ticks = ENC_BLOCKS * 16 // 4
    quantizer = (EMAProductVectorQuantizer(CODEBOOK_SIZE, 3, 0.25, 1, ema_decay=0.99)
                 if ema else ProductVectorQuantizer(CODEBOOK_SIZE, 3, 0.25, 1))
    encoder = Encoder(
        BachCPCDataProcessor(32, 2 * ticks, [ENC_VOCAB] * 4, num_tokens_per_block=16),
        GruDownscaler(32, 3, [16], 512, num_layers=2, dropout=0.1, bidirectional=True),
        quantizer, MlpUpscaler(3, 32, 512, 0.1))
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

# The entry points as a user calls them, at full width: the encoder CLI on
# configs/encoder_random_synthetic.py (GRU 512 x 2, codebook 32 x 3, batch
# 16), the decoder CLI on copies of configs/decoder_synthetic.py (the
# flagship AC/D/C: d_model 512, 3+3 layers, 8 heads, 384 tokens from 24
# codes, batch 64) and of it with decoder_type 'transformer_relative' (the
# AC/AC/C decoder, cross relbias at ratio 16), each over the encoder the
# first call trained. Epochs and batches are cut; widths are not.
ENTRY_ENCODER_BATCHES = 60
ENTRY_DECODER_BATCHES = 40
ENTRY_RELATIVE_BATCHES = 10
# the CLI calls of the counted main path, and the kernels each must launch
# (K1 = vq_nearest; K2-fwd / K3-fwd = relbias_attention_fwd, in training /
# at inference; K2-bwd = relbias_attention_bwd)
ENTRY_KERNELS = {
    "encoder -t": ("vq_nearest",),
    "decoder -t": ("vq_nearest", "relbias_attention_fwd", "relbias_attention_bwd"),
    "decoder -l -r": ("vq_nearest", "relbias_attention_fwd"),
    "decoder -l --num_examples 1": ("vq_nearest", "relbias_attention_fwd"),
    "AC/AC/C -t": ("vq_nearest", "relbias_attention_fwd", "relbias_attention_bwd"),
    "AC/AC/C -l -r": ("vq_nearest", "relbias_attention_fwd"),
}
TRAINING_CALLS = ("encoder -t", "decoder -t", "AC/AC/C -t")


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


def _check_model_dir(model_dir: str, epochs: int) -> list:
    """config.py, both slots and one finite metrics row per epoch; returns
    the rows."""
    for name in ("config.py", "overfitted", "early_stopped", "metrics.jsonl"):
        if not os.path.exists(os.path.join(model_dir, name)):
            raise AssertionError(f"{model_dir} holds no {name}")
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if [r["epoch"] for r in rows] != list(range(epochs)) or not all(
            np.isfinite(r["loss/train"]) and np.isfinite(r["loss/val"])
            for r in rows):
        raise AssertionError(f"{model_dir}/metrics.jsonl: {rows}")
    return rows


def phase_entry_points(card: str) -> dict:
    """The port's CLIs in process (main([...])) in a fresh working directory
    under build/: (a) encoder -t, with the cluster dumps; (b) the flagship
    decoder -t over that encoder, -l -r, -l --num_examples 1; (c) the
    AC/AC/C decoder -t, -l -r; (d) the checks: every call returns 0, the
    model directories, the written grids' tokens, the reloaded decoder's
    eval loss, and one AC/AC/C step on the kernel route against the f32
    plain route. The launches of the calls are counted from zero (the main
    path); the trainers the calls build are recorded for (d)."""
    import glob
    import shutil
    from vqcpcb_tpu_torch import main_decoder, main_encoder
    from vqcpcb_tpu_torch.data.dataloaders import BachDataloaderGenerator
    from vqcpcb_tpu_torch.training.decoder_trainer import DecoderTrainer
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "entry_points")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "configs"))

    trainers, grids, reharm_s = {}, [], []
    originals = {name: getattr(cls, name) for cls, name in (
        (DecoderTrainer, "train_model"), (DecoderTrainer, "load"),
        (DecoderTrainer, "generate_reharmonisation"),
        (BachDataloaderGenerator, "write"))}

    # the trainers by model directory, the first of each kind kept
    def train_model(self, **kw):
        trainers.setdefault("trained", {}).setdefault(
            os.path.abspath(self.model_dir), self)
        return originals["train_model"](self, **kw)

    def load(self, early_stopped):
        trainers.setdefault("loaded", {}).setdefault(
            os.path.abspath(self.model_dir), self)
        return originals["load"](self, early_stopped)

    def generate_reharmonisation(self, *args, **kw):
        out, sec = synced_seconds(
            lambda: originals["generate_reharmonisation"](self, *args, **kw))
        reharm_s.append(sec)
        return out

    def write(self, x, path):
        grids.append((self.dataset.vocabulary.num_tokens_per_channel,
                      np.asarray(x)))
        return originals["write"](self, x, path)

    calls, per_call = {}, {}
    cwd = os.getcwd()
    os.chdir(work)
    DecoderTrainer.train_model, DecoderTrainer.load = train_model, load
    DecoderTrainer.generate_reharmonisation = generate_reharmonisation
    BachDataloaderGenerator.write = write
    try:
        def run(label, cli, argv):
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
        main_counts = counts()
    finally:
        os.chdir(cwd)
        for (cls, name) in ((DecoderTrainer, "train_model"), (DecoderTrainer, "load"),
                            (DecoderTrainer, "generate_reharmonisation"),
                            (BachDataloaderGenerator, "write")):
            setattr(cls, name, originals[name])

    # (d) the checks
    for label, kernels in ENTRY_KERNELS.items():
        missing = [k for k in kernels if not per_call[label][k]]
        others = [k for k, c in per_call[label].items() if c and k not in kernels]
        if missing or others:
            raise AssertionError(f"{label}: launched {per_call[label]}: "
                                 f"missing {missing}, unexpected {others}")
    rows = {kind: _check_model_dir(d, 1) for kind, d in dirs.items()}
    for kind in ("decoder", "AC/AC/C"):
        written = glob.glob(os.path.join(dirs[kind], "reharmonisations", "*.mid"))
        if len(written) < 3:
            raise AssertionError(f"{kind}: {len(written)} re-harmonisations")
    if not glob.glob(os.path.join(dirs["encoder"], "clusters_train", "*.mid")):
        raise AssertionError("the encoder CLI wrote no cluster dump")
    if len(glob.glob(os.path.join(dirs["decoder"], "generations", "*.mid"))) != 6:
        raise AssertionError("--num_examples 1 did not write 6 scores")
    for vocab, grid in grids:
        if grid.min() < 0 or (grid >= np.asarray(vocab)).any():
            raise AssertionError(f"a written grid's tokens leave the vocabulary "
                                 f"{vocab}")
    log(f"# [entry] (d) every call returned 0; {len(grids)} written grids "
        f"(cluster dumps, re-harmonisations, generations), every token inside "
        f"its voice's vocabulary")

    # the reloaded decoders against the trained ones, one fixed val batch
    trained, reloaded = trainers["trained"], trainers["loaded"]
    for kind in ("decoder", "AC/AC/C"):
        a, b = trained[dirs[kind]], reloaded[dirs[kind]]
        x = next(a.dataloader_generator.dataloaders(batch_size=64)[1])["x"]
        la, lb = a.eval_step(x)["loss"].item(), b.eval_step(x)["loss"].item()
        log(f"# [entry] (d) {kind}: eval loss of val batch 0, trained in memory "
            f"{la!r}, reloaded by -l {lb!r} (need equal)")
        if la != lb:
            raise AssertionError(f"{kind}: the reloaded decoder's eval loss differs")

    # one AC/AC/C step, kernel route vs the CPU f32 plain route, dropout 0
    acac = trained[dirs["AC/AC/C"]]
    dec = acac.decoder
    set_dropout(dec, 0.0)
    small = torch.as_tensor(next(acac.dataloader_generator.dataloaders(
        batch_size=2)[0])["x"], device=acac.device)
    codes = acac.encode_codes(small)
    kernel = loss_and_grads(dec, codes, small, autocast=True)
    plain = loss_and_grads(copy.deepcopy(dec).cpu(), codes.cpu(), small.cpu(),
                           autocast=False)
    loss_err, worst_cos, _ = compare_routes(
        "[entry] (d) AC/AC/C (cross relbias at ratio 16), batch 2, dropout 0, "
        "kernel route vs CPU f32 plain route", kernel, plain)

    # (e) the numbers
    tokens = {kind: r[0]["tokens_per_sec/train"] for kind, r in rows.items()}
    log(f"# [entry] (e) {card}: encoder epoch {tokens['encoder']:.1f} tokens/s "
        f"({ENTRY_ENCODER_BATCHES} steps at batch 16), flagship decoder epoch "
        f"{tokens['decoder']:.1f} tokens/s ({ENTRY_DECODER_BATCHES} steps at batch "
        f"64), AC/AC/C epoch {tokens['AC/AC/C']:.1f} tokens/s "
        f"({ENTRY_RELATIVE_BATCHES} steps); re-harmonisation (3 variants of the "
        f"corpus's first score) {reharm_s[0]:.3f} s flagship, {reharm_s[1]:.3f} s "
        f"AC/AC/C; CLI seconds {json.dumps({k: round(v, 2) for k, v in calls.items()})}")
    # one counter serves the training forward (K2-fwd) and the inference
    # forward (K3-fwd: val epochs and -l); each training forward has one
    # backward, so K2-fwd = K2-bwd launches and K3-fwd the rest
    by_kernel = {"K1": {l: c["vq_nearest"] for l, c in per_call.items()},
                 "K2-fwd": {l: c["relbias_attention_bwd"] for l, c in per_call.items()},
                 "K2-bwd": {l: c["relbias_attention_bwd"] for l, c in per_call.items()},
                 "K3-fwd": {l: c["relbias_attention_fwd"] - c["relbias_attention_bwd"]
                            for l, c in per_call.items()}}
    for name, calls_ in by_kernel.items():
        log(f"# [entry] (e) {card}: {name} launches {sum(calls_.values())} on this "
            f"path: {json.dumps({l: n for l, n in calls_.items() if n})}")
    return dict(launches=main_counts, tokens_per_s=tokens, reharm_s=reharm_s,
                cli_s=calls, by_kernel=by_kernel, acac_loss_err=loss_err,
                acac_worst_cos=worst_cos)


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
    fused = phase_fused(gen)
    profile = "--profile" in sys.argv[1:]
    by_path = {}
    by_path["serving"] = phase_serving(gen, profile, "flagship")["launches"]
    by_path["decoder_training"] = phase_decoder_training(gen, profile, "flagship")["launches"]
    by_path["absolute_serving"] = phase_serving(gen, profile, "absolute")["launches"]
    by_path["absolute_training"] = phase_decoder_training(gen, profile, "absolute")["launches"]
    by_path["explicit_bias"] = phase_explicit_bias(gen)["launches"]
    by_path["encoder_training"] = phase_encoder_training(gen, profile)["launches"]
    by_path["entry_points"] = phase_entry_points(card)["launches"]
    launches = {k: sum(path[k] for path in by_path.values()) for k in counts()}
    log(f"# main-path launches: {json.dumps(by_path)}")

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
        # encoder-training ones among them, under "shapes"
        entry("vq_nearest", "vqcpcb_tpu_torch/csrc/vq_nearest.cu",
              "vqcpcb_tpu/ops/pallas_vq.py:28", "vqcpcb_tpu/ops/pallas_vq.py:_kernel",
              [], vq, shapes=vq["shapes"]),
        # top-level times at the serving prefill's shape (B=512, T=S=384, f32
        # inputs), as since the kernel was first ported; the training shape
        # (B=32, T=S=384, packed bf16, dropout 0.2) under "training"
        # redesigned: the bf16-dot kernel of attention_fwd_mma.cuh, launched
        # from relbias_attention.cu (the f32-dot kernel stays there)
        entry("relbias_attention_fwd", "vqcpcb_tpu_torch/csrc/attention_fwd_mma.cuh",
              f"{pa}:571", f"{pa}:_relbias_fwd_kernel", [f"{pa}:875"],
              dict(rb, max_abs_err=max(rb["max_abs_err"],
                                       rb_train["fwd"]["max_abs_err"])),
              training={k: rb_train["fwd"][k] for k in train_keys},
              redesigned=True, via="vqcpcb_tpu_torch/csrc/relbias_attention.cu"),
        # times at the training shape, the only one the backward runs at
        entry("relbias_attention_bwd",
              "vqcpcb_tpu_torch/csrc/relbias_attention_bwd.cu",
              f"{pa}:895", f"{pa}:_relbias_bwd_kernel_packed", [f"{pa}:582"],
              rb_train["bwd"]),
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
