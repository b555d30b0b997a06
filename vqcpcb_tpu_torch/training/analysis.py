"""Cluster, codebook and attention analysis (counterpart of
vqcpcb_tpu/training/analysis.py): per-cluster score dumps (`plot_clusters`,
:19-61) and the codebook's nearest neighbours (`show_nn_clusters`, :62-73),
NumPy only; the per-head attention heatmaps (`plot_attention`, :76-100) and
the codebook's 3-d scatter (`scatterplot_clusters_3d`, :103-123), PDFs
under JAX's names. Cluster indices are merged product codes, so
multi-codebook encoders work too.

The plots import matplotlib (the Agg backend) and, for the heatmaps,
seaborn inside the two functions only, so nothing else of the port needs
either package; without one, the call raises Python's ImportError, which
names it.
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


def plot_attention(attentions, out_path: str, batch_index: int = 0) -> str:
    """Per-head attention heatmaps of one batch item, one subplot a head,
    written to out_path (reference: decoders/decoder.py:1019-1050).

    attentions: (batch, heads, tgt, src), any array-like. Returns out_path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import seaborn as sns

    att = np.asarray(attentions)[batch_index]
    num_heads = att.shape[0]
    plt.clf()
    plt.cla()
    for head_index in range(num_heads):
        plt.subplot(1, num_heads, head_index + 1)
        plt.title(f"Head {head_index}")
        sns.heatmap(att[head_index], vmin=0, vmax=1, cmap="YlGnBu")
        plt.grid(True)
    if os.path.dirname(out_path):
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
    plt.savefig(out_path)
    plt.close()
    return out_path


def scatterplot_clusters_3d(codebooks, model_dir: str) -> str:
    """The first sub-codebook's codewords as labelled points in 3-d, written
    to {model_dir}/clusters_scatter.pdf (reference: encoder.py:187-228);
    1- and 2-d codewords are zero-padded to 3 axes, wider ones cut to their
    first 3. Returns the path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    clusters = np.asarray(codebooks)[0]
    if clusters.shape[1] < 3:
        pad = np.zeros((clusters.shape[0], 3 - clusters.shape[1]))
        clusters = np.concatenate([clusters, pad], axis=1)
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    for i, (x, y, z) in enumerate(clusters[:, :3]):
        ax.scatter(x, y, z, color="b")
        ax.text(x, y, z, str(i), size=12, zorder=1, color="k")
    savepath = os.path.join(model_dir, "clusters_scatter.pdf")
    plt.savefig(savepath)
    plt.close(fig)
    return savepath
