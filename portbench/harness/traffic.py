"""The one traffic generator: integer token tensors in the shapes a traffic
file names, drawn from the seed on the device, each voice's tokens from the
configuration's pitch tokens of that voice (the last axis is the voice).

A traffic file holds `pool` (how many batches or template sets) and
`tensors` ({name: shape}); the rest of its keys are the driver's."""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from portbench.harness import weights


def pitch_tables(vocab: dict) -> List[List[int]]:
    """Each voice's pitch token indices in the configuration's vocabulary."""
    return [[i for i, name in enumerate(names) if name.startswith("p")]
            for names in vocabulary_names(vocab)]


def vocabulary_names(vocab: dict) -> List[List[str]]:
    """Each voice's token names, sorted as the corpus's vocabulary sorts
    them: the special symbols and the pitch names p<lo>..p<hi>."""
    return [sorted(set(vocab["specials"]) | {f"p{m}" for m in range(lo, hi + 1)})
            for lo, hi in vocab["voice_ranges"]]


def vocab_sizes(vocab: dict) -> List[int]:
    """Each voice's vocabulary size."""
    return [len(v) for v in vocabulary_names(vocab)]


def forbidden(vocab: dict) -> List[List[int]]:
    """Each voice's indices of the symbols generation excludes."""
    return [[v.index(s) for s in vocab["forbidden"]] for v in vocabulary_names(vocab)]


def tokens(shape: Sequence[int], tables: List[List[int]],
           g: torch.Generator, device) -> torch.Tensor:
    """int32 tokens of `shape` (last axis: the voices), uniform over each
    voice's table, in one draw."""
    counts = torch.tensor([len(t) for t in tables], device=device)
    width = max(len(t) for t in tables)
    table = torch.tensor([t + t[-1:] * (width - len(t)) for t in tables],
                         device=device)
    u = torch.rand(tuple(shape), generator=g, device=device)
    idx = torch.minimum((u * counts).long(), counts - 1)
    voice = torch.arange(len(tables), device=device).expand_as(idx)
    return table[voice, idx].to(torch.int32)


def pool(traffic: dict, vocab: dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """traffic['pool'] entries, each {name: tokens of its shape}."""
    g = torch.Generator(device=device).manual_seed(
        weights.stream_seed(seed, weights.TRAFFIC))
    tables = pitch_tables(vocab)
    n = int(traffic["pool"])
    drawn = {name: tokens((n,) + tuple(shape), tables, g, device)
             for name, shape in traffic["tensors"].items()}
    return [{name: x[i] for name, x in drawn.items()} for i in range(n)]
