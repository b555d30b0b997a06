"""Bulk generation in whole calls, back to back: each call encodes a set
of templates tiled `tile` times and samples every position of every row at
the traffic's temperature and top-p, excluding the forbidden symbols.
Set-up warms that call at the full batch over `warm_positions` positions.
The window runs whole calls until `seconds` have passed, finishing the call
in flight; gen_tokens_per_s = rows x positions of every call / the window's
host time (each call ends with its tokens on the host). A traced run
profiles `profiled` more calls after the window.

After the window (and the traced calls) the same generator makes one
greedy call at the full batch, untimed: greedy tokens are what the check
can compare with the reference's best, and none of the timed calls is
greedy. The check, once the program is freed: the codes of the window's
first call (every row) against the reference encoder's latents of its
templates, and a sample of rows drawn from the seed, of the greedy call
and of the window's calls, whose tokens the reference judges
teacher-forced under the program's codes."""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import torch

from portbench.harness import compare, tracing, weights


def run(ctx) -> SimpleNamespace:
    cfg, traffic, wl = ctx.cell["config"], ctx.cell["traffic"], ctx.cell["workload"]
    cuda = ctx.device.type == "cuda"
    sysm = ctx.system.Generate(cfg, traffic, ctx.seed, ctx.device)
    ctx.phase("system")
    sysm.call(0, False, positions=int(wl["warm_positions"]))
    if cuda:
        torch.cuda.synchronize()
    ctx.phase("warm-up")
    setup_s = time.time() - ctx.started

    calls = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        i = len(calls)
        calls.append((i, False) + sysm.call(i, False))
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rows, positions = sysm.rows, sysm.positions
    out = SimpleNamespace(
        attempted=len(calls) * rows, failed=0, memory_peak_bytes=int(peak),
        end_to_end={"gen_tokens_per_s": len(calls) * rows * positions / elapsed,
                    "setup_s": setup_s},
        window={"calls": len(calls), "seconds": elapsed, "rows": rows,
                "positions": positions},
        trace=None)
    k = len(calls)
    if ctx.trace:
        out.trace = tracing.profile(lambda j: sysm.call(k + j, False),
                                    int(wl["profiled"]), ctx.log, cuda)
        k += 2 * int(wl["profiled"])
    greedy = (k, True) + sysm.call(k, True)

    sysm.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out.numbers = check(sysm, calls + [greedy], traffic, ctx.seed)
    return out


def pick_rows(calls, traffic, seed):
    """(call index, row) pairs drawn from the seed: check_rows['greedy'] of
    the greedy calls' rows and check_rows['sampled'] of the others'."""
    g = torch.Generator().manual_seed(weights.stream_seed(seed, weights.SAMPLE))
    picked = []
    for greedy, key in ((True, "greedy"), (False, "sampled")):
        pool = [c for c in calls if c[1] == greedy]
        for _ in range(int(traffic["check_rows"][key]) if pool else 0):
            c = pool[int(torch.randint(len(pool), (1,), generator=g))]
            picked.append((c, int(torch.randint(c[2].shape[0], (1,), generator=g))))
    return picked


def check(sysm, calls, traffic, seed) -> dict:
    """The compared numbers: code_gap, greedy_gap, nucleus_excess."""
    first = calls[0]
    unique = sysm.pool[first[0] % len(sysm.pool)]
    dist, _ = sysm.reference_distances(unique)
    per_template = dist.reshape(unique.shape[0], -1, dist.shape[-1])
    rows = torch.arange(sysm.rows) % unique.shape[0]
    numbers = {"code_gap": compare.code_gap(
        per_template[rows.to(dist.device)].reshape(-1, dist.shape[-1]),
        first[2].reshape(-1).to(dist.device))}
    picked = pick_rows(calls, traffic, seed)
    codes = torch.stack([c[2][r] for c, r in picked])
    tokens = torch.stack([c[3][r] for c, r in picked])
    greedy = torch.tensor([c[1] for c, _ in picked])
    ref = sysm.reference_logits(codes, tokens)
    numbers.update(compare.token_numbers(ref, tokens, sysm.forbidden_reference(),
                                         greedy, traffic["temperature"],
                                         traffic["top_p"]))
    return numbers
