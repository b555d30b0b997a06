"""Cluster and codebook analysis (counterpart of
vqcpcb_tpu/training/analysis.py): per-cluster score dumps (`plot_clusters`,
:19-61) and the codebook's nearest neighbours (`show_nn_clusters`, :64-76),
NumPy only. Cluster indices are merged product codes, so multi-codebook
encoders work too. The matplotlib plots (`scatterplot_clusters_3d`,
`plot_attention`) wait for an environment with matplotlib (ROADMAP.md Queue
1, item 3).
"""
from __future__ import annotations

import os
import random
from typing import Callable, Dict, List

import numpy as np


def plot_clusters(encode_fn: Callable,
                  dataloader_generator,
                  split_name: str,
                  model_dir: str,
                  num_events_for_one_index: int,
                  batch_size: int = 32,
                  num_batches: int = 64,
                  max_elements: int = 50) -> Dict[int, int]:
    """Write every excerpt slice assigned to each code to
    {model_dir}/clusters_{split}/{cluster} (reference: encoder.py:112-176).

    encode_fn: x (B, events, channels) NumPy -> merged code indices (B, S),
    any array-like. Returns {cluster_index: num_elements}. The shuffle of
    each cluster's slices draws from python's `random`, as in JAX."""
    loaders = dataloader_generator.dataloaders(batch_size=batch_size)
    generator = dict(zip(("train", "val", "test"), loaders))[split_name]

    d: Dict[int, List[np.ndarray]] = {}
    for k, tensor_dict in enumerate(generator):
        x = tensor_dict["x"]
        codes = np.asarray(encode_fn(x))
        for batch_index in range(x.shape[0]):
            for s in range(codes.shape[1]):
                sl = x[batch_index, s * num_events_for_one_index:
                       (s + 1) * num_events_for_one_index]
                d.setdefault(int(codes[batch_index, s]), []).append(sl)
        if k > num_batches:
            break

    out_dir = os.path.join(model_dir, f"clusters_{split_name}")
    os.makedirs(out_dir, exist_ok=True)
    for unit_index, elements in d.items():
        random.shuffle(elements)
        dataloader_generator.write(
            np.concatenate(elements[:max_elements], axis=0),
            os.path.join(out_dir, str(unit_index)))
    return {k: len(v) for k, v in d.items()}


def show_nn_clusters(codebooks: np.ndarray, k: int = 3) -> Dict[int, list]:
    """The k nearest codewords of each codeword of the first sub-codebook
    (reference: encoder.py:178-185); prints and returns them."""
    clusters = np.asarray(codebooks)[0]
    dists = np.linalg.norm(clusters[None] - clusters[:, None], axis=-1)
    print("Nearest neighbours list:")
    out = {}
    for i in range(dists.shape[0]):
        res = np.argsort(dists[i])[1:k + 1]
        out[i] = res.tolist()
        print(f"{i}: {res}")
    return out
