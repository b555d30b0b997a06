"""The readings a cell's limits are set from, on the card at the cell's own
size: the program's compared numbers over many seeds (its sound runs), the
control's (the reference in the cell's `control` precision put in the
program's place) and the faults' over a few, all in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 11 12 ... \
        [--controls 3] [--out chiprun_out/calibrate_<name>.json]

Training cells: the program's first three steps against the reference's;
the control's three steps, a half-batch fault (the reference on half of
each batch, its mean over the rest) and a step that leaves the state
unchanged (the reference at learning rate 0, its Adam moments at 0)
against the same reference.
Generation: one sampled and one greedy call at the cell's size, checked
as a run checks them; the control's codes (its encoder at the lower
precision) and its tokens at the checked rows' positions (its best allowed
token; its own draw under the same temperature and top-p) judged by the
reference; a token altered where it is produced (one a checked row); and
two samplers at fault, drawn from the reference's own logits: one that
ignores top-p, one that ignores the temperature."""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import env  # noqa: E402


@contextlib.contextmanager
def tf32(on: bool):
    import torch
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _unpinned(sysm):
    """The reference's loss without the program's codes at near ties (they
    are the whole batch's), where the system keeps them."""
    return (sysm.reference_loss(pin=False) if hasattr(sysm, "recording")
            else sysm.reference_loss())


def train_seed(cell, system, seed, device, control: bool) -> dict:
    import torch
    from portbench.harness import compare, registry
    from portbench.reference.nets import Precision
    train = registry.module("drivers", "train")
    cfg, traffic = cell["config"], cell["traffic"]
    kind = cell["workload"]["control"]
    sysm = system.Train(cfg, traffic, seed, device)
    initial, program = train.first_steps(sysm)
    pool = sysm.pool[:train.FIRST_STEPS]
    opt = train.optimizer_config(cfg)
    sysm.close()
    gc.collect()
    torch.cuda.empty_cache() if device.type == "cuda" else None
    ref = compare.follow(initial, pool, sysm.reference_loss(), opt)
    out = {"program": compare.train_numbers(program, ref)}
    if control:
        prec = Precision("f32" if kind == "tf32" else kind)
        with tf32(kind == "tf32"):
            ctl = compare.follow(initial, pool, sysm.reference_loss(prec), opt)
        out["control"] = compare.train_numbers(ctl, ref)
        halves = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in pool]
        half = compare.follow(initial, halves, _unpinned(sysm), opt)
        out["half_batch"] = compare.train_numbers(half, ref)
        still = compare.follow(initial, pool, sysm.reference_loss(), dict(opt, lr=0.0))
        still["first_grads"] = {k: torch.zeros_like(g) for k, g in ref["first_grads"].items()}
        out["unchanged"] = compare.train_numbers(still, ref)
    return out


def _nucleus_draw(logits, temperature, top_p, g):
    """One draw under the program's rule (top-p keeps the sorted prefix
    whose mass before each token is at most top_p; ties kept) by
    Gumbel-max, from generator g."""
    import torch
    lg = logits / temperature
    srt = torch.sort(lg, dim=-1, descending=True).values
    cum = torch.softmax(srt, -1).cumsum(-1)
    keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool),
                      cum[..., :-1] <= top_p], -1)
    floor = torch.where(keep, srt, torch.full_like(srt, float("inf"))).amin(-1, keepdim=True)
    lg = lg.masked_fill(lg < floor, float("-inf"))
    noise = torch.empty(lg.shape, dtype=lg.dtype).exponential_(generator=g).to(lg.device)
    return torch.argmax(lg - noise.log(), -1)


def generate_seed(cell, system, seed, device, control: bool) -> dict:
    import torch
    from portbench.harness import compare, registry, weights
    from portbench.reference.nets import Precision
    generate = registry.module("drivers", "generate")
    cfg, traffic = cell["config"], cell["traffic"]
    sysm = system.Generate(cfg, traffic, seed, device)
    calls = [(i, i == 1) + sysm.call(i, i == 1) for i in range(2)]
    sysm.close()
    gc.collect()
    torch.cuda.empty_cache() if device.type == "cuda" else None
    out = {"program": generate.check(sysm, calls, traffic, seed)}
    if not control:
        return out
    precision, kv = cell["workload"]["control"].split("+")
    prec = Precision(precision)
    unique = sysm.pool[0]
    dist, own = sysm.reference_distances(unique, prec)
    picked = generate.pick_rows(calls, traffic, seed)
    codes = torch.stack([c[2][r] for c, r in picked])
    tokens = torch.stack([c[3][r] for c, r in picked])
    greedy = torch.tensor([c[1] for c, _ in picked])
    forbidden = sysm.forbidden_reference()
    ref = sysm.reference_logits(codes, tokens)
    low = sysm.reference_logits(codes, tokens, prec, kv_round=kv)
    g = torch.Generator().manual_seed(weights.stream_seed(seed, weights.SAMPLE) + 1)
    chosen = []
    for c, lg in enumerate(low):
        lg = lg.clone()
        lg[..., forbidden[c]] = float("-inf")
        best = lg.argmax(-1)
        drawn = _nucleus_draw(lg, traffic["temperature"], traffic["top_p"], g)
        chosen.append(torch.where(greedy.to(lg.device)[:, None], best, drawn))
    ctl_tokens = torch.stack(chosen, -1).cpu()
    out["control"] = dict(code_gap=compare.code_gap(dist, own.reshape(-1)),
                          **compare.token_numbers(ref, ctl_tokens, forbidden, greedy,
                                                  traffic["temperature"],
                                                  traffic["top_p"]))
    for name, temperature, top_p in (("top_p_ignored", traffic["temperature"], 1.0),
                                     ("temperature_ignored", 1.0, traffic["top_p"])):
        drawn = [_nucleus_draw(lg.clone().index_fill_(-1, torch.tensor(
                     forbidden[c], device=lg.device), float("-inf")),
                               temperature, top_p, g) for c, lg in enumerate(ref)]
        faulty = torch.where(greedy[:, None, None], tokens,
                             torch.stack(drawn, -1).cpu().to(tokens.dtype))
        out[name] = compare.token_numbers(ref, faulty, forbidden, greedy,
                                          traffic["temperature"], traffic["top_p"])
    altered = tokens.clone()
    pos = torch.randint(altered.shape[1], (altered.shape[0],), generator=g)
    voice = torch.randint(altered.shape[2], (altered.shape[0],), generator=g)
    for r in range(altered.shape[0]):
        v = int(voice[r])
        size = ref[v].shape[-1]
        altered[r, pos[r], v] = (altered[r, pos[r], v] + 1) % size
    out["altered_token"] = compare.token_numbers(ref, altered, forbidden, greedy,
                                                 traffic["temperature"], traffic["top_p"])
    return out


def main(argv=None, *, device=None, cell=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--out")
    args = p.parse_args(argv)
    env.prepare()
    import torch
    from portbench.harness import registry
    cell = cell or registry.cell(args.workload)
    if device is None:
        env.card_or_exit(int(cell["entry"]["chips"]))
        env.strict_f32()
        print(f"# card: {env.smi()}", flush=True)
        device = "cuda"
    device = torch.device(device)
    system = registry.module("systems", cell["entry"]["config"])
    one = train_seed if cell["workload"]["driver"] == "train" else generate_seed
    results = {}
    for n, seed in enumerate(args.seeds):
        results[seed] = one(cell, system, seed, device, n < args.controls)
        print(json.dumps({"seed": seed, **results[seed]}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
