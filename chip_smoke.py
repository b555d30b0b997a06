"""Smoke run of the PyTorch + CUDA port (vqcpcb_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py             # the smoke run
    python3 chip_smoke.py --profile   # plus a profiler breakdown of sampling

Phases, in order; any failure raises and the run exits non-zero:
  1. environment: the card's name and power limit, torch / CUDA versions,
     TF32 off for matmuls and cuDNN (the comparisons below are in f32);
  2. build every CUDA kernel of the port from csrc/ with nvcc (sm_90a);
  3. nearest-codebook kernel vs its plain PyTorch version, timed;
  4. relative-bias attention kernel vs its plain version, timed beside its
     bound and beside scaled_dot_product_attention as a yardstick;
  5. the re-harmonisation serving path end to end at full width (random
     weights from a seed): encoder codes, KV-cached sampling at batch 512,
     re-harmonisation of a random template, and kernel-route vs plain-route
     logits plus greedy KV-cached tokens vs the teacher-forced argmax;
  6. one JSON line of per-kernel numbers, then the result line.

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

# Shapes of the slice at full width: 512 templates of 96 events x 4 voices,
# 24 codes each (blocks of 16 tokens), decoder d_model 512 / 8 heads.
BATCH = 512
NUM_EVENTS = 96
NUM_CODES = 24
HEADS = 8
HEAD_DIM = 64
CODEBOOK_SIZE = 32


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
    from vqcpcb_tpu_torch.ops import vq_kernels as vk
    dev = torch.device("cuda")
    result = {}
    for n, k, d, s in [(BATCH * NUM_CODES, 1, 3, CODEBOOK_SIZE),
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
        if (n, k, d, s) == (BATCH * NUM_CODES, 1, 3, CODEBOOK_SIZE):
            ms = time_cuda(lambda: vk.nearest_codebook_indices_cuda(x, e), 200)
            plain_ms = time_cuda(lambda: vk.nearest_codebook_indices_plain(x, e), 50)
            bytes_moved = 4 * (x.numel() + e.numel() + n * k)
            flops = n * k * s * (2 * d + 3) + n * k * 2 * d
            bound_ms, bound_by = bound(bytes_moved, flops, F32_FLOPS)
            # error as distance: how much farther the kernel's code lies
            # than the plain version's (0 when every index agrees)
            err = (dist.gather(-1, got.long()[..., None])
                   - dist.gather(-1, want.long()[..., None])).abs().max().item()
            result = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                          bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
            log(f"# vq_nearest at the slice shape ({n},{k},{d},{s}): "
                f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bound "
                f"{bound_ms:.6f} ms ({bound_by})")
        elif n == 1048576:
            ms = time_cuda(lambda: vk.nearest_codebook_indices_cuda(x, e), 50)
            plain_ms = time_cuda(lambda: vk.nearest_codebook_indices_plain(x, e), 10)
            log(f"# vq_nearest at ({n},{k},{d},{s}): kernel {ms:.5f} ms, "
                f"plain {plain_ms:.5f} ms")
    return result


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
# layers) against the f32 plain route: each bf16 rounding is 2**-9 relative;
# through 6 post-LN layers the logits keep a few such errors, so 2e-2 of the
# largest logit bounds them with room and still catches a wrong kernel.
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

def synthetic_vocabulary():
    """4 voices of 56 pitches 'p<midi>' plus the 6 special symbols: 62
    tokens per voice, the vocabulary size of the flagship decoder."""
    from vqcpcb_tpu_torch.data.vocab import Vocabulary, midi_of_plain_name
    return Vocabulary.from_note_sets(
        [{f"p{m}" for m in range(36 + 6 * v, 36 + 6 * v + 56)} for v in range(4)],
        midi_of_plain_name)


def build_models(vocab):
    """Full width, random weights from torch's init under a fixed seed:
    the encoder of configs/encoder_random_config.py and the flagship AC/D/C
    decoder of configs/decoder_relative_AC_D_C_random.py."""
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
        total_upscaling=16, source_vocab_size=CODEBOOK_SIZE)
    return encoder, decoder


def random_templates(vocab, gen, batch, events):
    """Random pitch tokens (no special symbols) on the card, (B, events, 4)."""
    pitches = [sorted(i for n, i in d.items() if n.startswith("p"))
               for d in vocab.note2index_dicts]
    cols = [torch.tensor(p, device="cuda")[
        torch.randint(len(p), (batch, events), generator=gen, device="cuda")]
        for p in pitches]
    return torch.stack(cols, dim=-1).int()


def reset_counts():
    from vqcpcb_tpu_torch.ops import attention_kernels as ak, vq_kernels as vk
    vk.launches = 0
    ak.launches = 0


def counts():
    from vqcpcb_tpu_torch.ops import attention_kernels as ak, vq_kernels as vk
    return {"vq_nearest": vk.launches, "relbias_attention_fwd": ak.launches}


def synced_seconds(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_end_to_end(gen: torch.Generator, profile: bool) -> dict:
    from vqcpcb_tpu_torch.training.decoder_trainer import DecoderGenerator
    vocab = synthetic_vocabulary()
    encoder, decoder = build_models(vocab)
    generator = DecoderGenerator(encoder, decoder, vocab, CODEBOOK_SIZE, seed=0)
    templates = random_templates(vocab, gen, BATCH, NUM_EVENTS)
    with torch.no_grad():
        # data-dependent codebook init (the reference's first-batch init,
        # vqcpcb_tpu/ops/quantizer.py:29): codes drawn from the downscaler's
        # outputs, so the codes of the templates spread over the codebook
        z = encoder.downscaler(encoder.embed_tokens(templates)).reshape(-1, 3)
        pick = torch.randperm(z.shape[0], generator=gen, device="cuda")[:CODEBOOK_SIZE]
        encoder.quantizer.embeddings[0].copy_(z[pick])
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
    log(f"# (a) encode_codes: {BATCH} templates -> codes {tuple(codes.shape)}, "
        f"{len(codes.unique())} distinct of {CODEBOOK_SIZE}, {encode_s * 1e3:.3f} ms")

    # (b) KV-cached sampling of all 384 positions at batch 512, int8 caches
    tokens0 = torch.zeros((BATCH, NUM_EVENTS, 4), dtype=torch.int32, device="cuda")
    n_tok = NUM_EVENTS * 4
    sampled, sample_s = synced_seconds(lambda: decoder.sample_range(
        codes, tokens0, 0, n_tok, generator.generator, temperature=0.95,
        top_p=0.8))
    after_b = counts()
    prefill_launches = after_b["relbias_attention_fwd"] - after_a["relbias_attention_fwd"]
    if prefill_launches != 6:
        raise AssertionError(f"one prefill launched relbias_attention "
                             f"{prefill_launches} times, not 6")
    sizes = torch.tensor(vocab.num_tokens_per_channel, device="cuda")
    if not ((sampled >= 0) & (sampled < sizes)).all():
        raise AssertionError("sampled tokens outside their channel's vocabulary")
    tokens_per_s = BATCH * n_tok / sample_s
    log(f"# (b) sample_range batch {BATCH} x {n_tok} positions (T 0.95, "
        f"top_p 0.8, int8 caches): {sample_s:.4f} s, {tokens_per_s:.1f} "
        f"tokens/s")

    # (c) re-harmonisation of a random 40-beat template, 8 variants
    template = random_templates(vocab, gen, 1, 40 * 4).cpu().numpy()
    before_c = counts()
    outs, reharm_s = synced_seconds(lambda: generator.generate_reharmonisation(
        template, 8, temperature=0.95, top_p=0.8, exclude_meta_symbols=True))
    after_c = counts()
    windows, rest = divmod(after_c["relbias_attention_fwd"]
                           - before_c["relbias_attention_fwd"], 6)
    if rest or not windows:
        raise AssertionError(f"re-harmonisation launched relbias_attention "
                             f"{6 * windows + rest} times, not 6 per window")
    forbidden = generator._forbidden(True)
    for grid in outs:
        if grid.shape != (160, 4):
            raise AssertionError(f"re-harmonisation grid {grid.shape}")
        for c in range(4):
            if np.isin(grid[:, c], forbidden[c]).any():
                raise AssertionError("a meta symbol was sampled while excluded")
    log(f"# (c) generate_reharmonisation 40 beats x 8 variants: "
        f"{reharm_s:.4f} s, {windows} windows, {len(outs) * 160 * 4} tokens")
    # the main path is (a)-(c); what follows launches the kernels outside it
    main_counts = counts()

    with torch.no_grad():
        _, prefill_s = synced_seconds(lambda: decoder.prefill(codes, tokens0,
                                                              torch.int8))
    log(f"# prefill alone at batch {BATCH} (int8 caches): "
        f"{prefill_s * 1e3:.3f} ms")
    if profile:
        phase_profile(decoder, codes, generator.generator)

    # (d) kernel route vs plain route, greedy KV cache vs teacher forcing
    small_codes, small = codes[:8], sampled[:8]
    with torch.no_grad():
        kernel_logits = decoder(small_codes, small)["weights_per_category"]
        plain = copy.deepcopy(decoder).cpu()
        plain_logits = plain(small_codes.cpu(), small.cpu())["weights_per_category"]
    scale = max(lg.abs().max().item() for lg in plain_logits)
    err = max((k.cpu() - p).abs().max().item()
              for k, p in zip(kernel_logits, plain_logits))
    log(f"# (d) decoder logits at batch 8, kernel route (bf16 dots) vs plain "
        f"route (f32, CPU): max abs err {err:.4e}, max |logit| {scale:.3f} "
        f"(tolerance {LOGITS_RTOL} * max |logit|)")
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
    log(f"# (d) greedy f32-cache tokens vs teacher-forced argmax: "
        f"{rate * 100:.3f}% of {agree.numel()} positions agree (need >= 99%)")
    if rate < 0.99:
        raise AssertionError(f"greedy agreement {rate}")
    return dict(launches=main_counts, encode_ms=encode_s * 1e3,
                prefill_ms=prefill_s * 1e3, tokens_per_s=tokens_per_s,
                reharm_s=reharm_s, windows=windows)


def phase_profile(decoder, codes, generator: torch.Generator) -> None:
    """Device time by kernel over one sample_range of 64 positions at batch
    512 (a prefill and 64 decode steps), from torch.profiler, and the share
    of the wall time the card was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tokens0 = torch.zeros((codes.shape[0], NUM_EVENTS, 4), dtype=torch.int32,
                          device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_s = synced_seconds(lambda: decoder.sample_range(
            codes, tokens0, 0, 64, generator, temperature=0.95, top_p=0.8))
    # kernels only: the aten ops above them carry the same device time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"# profile: sample_range batch {codes.shape[0]}, 64 positions: wall "
        f"{wall_s * 1e3:.3f} ms (under the profiler), device busy "
        f"{busy_ms:.3f} ms ({busy_ms / (wall_s * 1e3) * 100:.1f}%)")
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:12]:
        log(f"# profile {e.self_device_time_total / 1e3:10.3f} ms "
            f"{e.count:6d} calls  {e.key[:90]}")


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
    phase_environment()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    vq = phase_vq(gen)
    rb = phase_relbias(gen)
    e2e = phase_end_to_end(gen, profile="--profile" in sys.argv[1:])
    launches = e2e["launches"]
    log(f"# main-path launches: {json.dumps(launches)}")

    kernels = [
        dict(name="vq_nearest", route="cuda",
             source="vqcpcb_tpu_torch/csrc/vq_nearest.cu",
             replaces="vqcpcb_tpu/ops/pallas_vq.py:28",
             pallas_counterpart="vqcpcb_tpu/ops/pallas_vq.py:_kernel",
             launches=launches["vq_nearest"], max_abs_err=vq["max_abs_err"],
             ms=vq["ms"], plain_ms=vq["plain_ms"], bound_ms=vq["bound_ms"],
             bound_by=vq["bound_by"], library_ms=vq["library_ms"]),
        dict(name="relbias_attention_fwd", route="cuda",
             source="vqcpcb_tpu_torch/csrc/relbias_attention.cu",
             replaces="vqcpcb_tpu/ops/pallas_attention.py:571",
             pallas_counterpart="vqcpcb_tpu/ops/pallas_attention.py:_relbias_fwd_kernel",
             launches=launches["relbias_attention_fwd"],
             max_abs_err=rb["max_abs_err"],
             ms=rb["ms"], plain_ms=rb["plain_ms"],
             bound_ms=rb["bound_ms"], bound_by=rb["bound_by"],
             library_ms=rb["library_ms"]),
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
