"""Cells of the benchmark shrunk to CPU test size: the cell's files as
BENCHMARK.json names them, with the widths, depths and batches cut."""
from __future__ import annotations

import copy

from portbench.harness import registry

DECODER = {"d_model": 32, "n_head": 2, "num_encoder_layers": 1,
           "num_decoder_layers": 2, "dim_feedforward": 48, "num_events": 8,
           "sequences_size": 2}
ENCODER = {"hidden_size": 16, "upscaler_hidden_size": 16}
CPC = dict(ENCODER, context_hidden_size=16, num_blocks_left=2, num_blocks_right=2)


def cell(name: str) -> dict:
    c = copy.deepcopy(registry.cell(name))
    cfg, traffic = c["config"], c["traffic"]
    if "config_encoder" in cfg:
        cfg.update(DECODER)
        cfg["config_encoder"].update(ENCODER)
    else:
        cfg.update(CPC)
    t = traffic["tensors"]
    traffic["pool"] = 4
    if "x" in t:
        t["x"] = [2, cfg["num_events"], 4]
    if "templates" in t:
        t["templates"] = [2, cfg["num_events"], 4]
        traffic["tile"] = 2
        traffic["check_rows"] = {"greedy": 2, "sampled": 2}
    if "x_left" in t:
        t["x_left"] = [2, 8, 4]
        t["x_right"] = [2, 8, 4]
        t["negative_samples"] = [2, 3, 2, 4, 4]
    c["workload"]["profiled"] = 1
    return c
