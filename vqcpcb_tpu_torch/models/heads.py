"""Per-channel output heads (`pre_softmaxes.{c}`) split by vocabulary over a
model axis: the decoder's, the teacher's and the auxiliary decoders'.

TP_RULES' pre_softmax rule (parallel/mesh.py) leaves each rank the rows of
every head whose vocabulary divides the model axis. `head_logits` then
computes, as JAX's GSPMD does, every head's whole logits on every rank:
copy_to_model on the heads' input, one product a split head on this rank's
rows, their columns concatenated and all-gathered along the vocabulary in
one call (gather_from_model), each head's blocks put back in rank order;
the other heads stay replicated. Without a mesh it is one product a head.
"""
from __future__ import annotations

from typing import Callable, List

import torch
import torch.nn.functional as F

from vqcpcb_tpu_torch.parallel.collectives import copy_to_model, gather_from_model


class VocabParallelHeads:
    """A mixin for a module with a `pre_softmaxes` ModuleList of Linear
    heads: `set_mesh` (which shard_params calls) and `head_logits`."""

    head_mesh = None            # the mesh, when it splits a head
    split_heads: List[int] = []

    def set_mesh(self, mesh, specs) -> None:
        self.split_heads = [c for c in range(len(self.pre_softmaxes))
                            if specs.get(f"pre_softmaxes.{c}.weight") is not None]
        self.head_mesh = mesh if self.split_heads else None

    def head_logits(self, x: torch.Tensor, per_channel: bool,
                    linear: Callable = F.linear) -> List[torch.Tensor]:
        """Head c's logits over x[..., c, :] (per_channel: x (..., C, d), one
        slice a head) or over x itself, each whole; `linear(x, weight,
        bias)` computes a head (F.linear, or the decoder's utils.dense)."""
        heads = self.pre_softmaxes

        def head(inputs: torch.Tensor, c: int) -> torch.Tensor:
            h = heads[c]
            return linear(inputs.select(-2, c) if per_channel else inputs,
                          h.weight, h.bias)

        mesh = self.head_mesh
        if mesh is None:
            return [head(x, c) for c in range(len(heads))]
        shared = copy_to_model(x, mesh)
        local = torch.cat([head(shared, c) for c in self.split_heads], dim=-1)
        gathered = gather_from_model(local, mesh).unflatten(-1, (mesh.n_model, -1))
        logits, offset = {}, 0
        for c in self.split_heads:
            width = heads[c].weight.shape[0]          # this rank's rows
            logits[c] = gathered[..., offset:offset + width].flatten(-2)
            offset += width
        return [logits[c] if c in logits else head(x, c)
                for c in range(len(heads))]

    def head_logit(self, x: torch.Tensor, c: int,
                   linear: Callable = F.linear) -> torch.Tensor:
        """Head c's whole logits over x (..., d): the sampler's head at one
        position. A split head runs on this rank's rows and its logits are
        all-gathered along the vocabulary over `model`."""
        h = self.pre_softmaxes[c]
        if self.head_mesh is None or c not in self.split_heads:
            return linear(x, h.weight, h.bias)
        mesh = self.head_mesh
        return gather_from_model(linear(copy_to_model(x, mesh), h.weight, h.bias),
                                 mesh)
