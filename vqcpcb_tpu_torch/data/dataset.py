"""Window-tensor dataset with on-disk caching, train/val/test splits and
batching: a port-local copy of vqcpcb_tpu/data/dataset.py:24-129.

The cache is a plain .npz of int32 windows plus a JSON vocabulary, under
`cache_root` (default: the data/ directory at the root of the checkout,
git-ignored, the JAX package's default too; both write the same files under
the same keys).
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from vqcpcb_tpu_torch.data.tokenizer import make_window_dataset
from vqcpcb_tpu_torch.data.vocab import Vocabulary

DEFAULT_CACHE_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "data")


class ChoraleBeatsDataset:
    """Sliding-window chorale dataset over a corpus backend."""

    def __init__(self,
                 corpus,
                 sequences_size: int,
                 subdivision: int = 4,
                 cache_root: Optional[str] = None,
                 vocabulary: Optional[Vocabulary] = None):
        self.corpus = corpus
        self.sequences_size = sequences_size
        self.subdivision = subdivision
        self.cache_root = os.path.abspath(cache_root or DEFAULT_CACHE_ROOT)
        os.makedirs(self.cache_root, exist_ok=True)
        self._vocab = vocabulary
        self._windows: Optional[np.ndarray] = None

    # ---- vocabulary (shared across sequence sizes, like the reference's
    # index_dicts cache, chorale_dataset.py:70-107) -------------------------

    @property
    def vocab_path(self) -> str:
        return os.path.join(self.cache_root, "index_dicts",
                            f"{self.corpus.cache_key}.json")

    @property
    def vocabulary(self) -> Vocabulary:
        if self._vocab is None:
            if os.path.exists(self.vocab_path):
                self._vocab = Vocabulary.load(self.vocab_path)
            else:
                self._vocab = self.corpus.build_vocabulary()
                self._vocab.save(self.vocab_path)
        return self._vocab

    # ---- window tensor -----------------------------------------------------

    @property
    def tensor_path(self) -> str:
        # the vocabulary fingerprint is part of the key: token ids depend on
        # the index dicts, so a dataset built with an injected vocabulary
        # (e.g. Vocabulary.from_reference_pickle for parity runs) must not
        # reuse windows tokenized under the default sorted vocab
        vocab_fp = hashlib.sha1(json.dumps(
            self.vocabulary.note2index_dicts, sort_keys=True,
            default=str).encode()).hexdigest()[:10]
        return os.path.join(
            self.cache_root,
            f"{self.corpus.cache_key}_seq{self.sequences_size}"
            f"_sub{self.subdivision}_v{vocab_fp}.npz")

    @property
    def windows(self) -> np.ndarray:
        """(num_windows, num_voices, ticks) int32"""
        if self._windows is None:
            if os.path.exists(self.tensor_path):
                self._windows = np.load(self.tensor_path)["windows"]
            else:
                self._windows = make_window_dataset(
                    self.corpus, self.vocabulary,
                    self.sequences_size, self.subdivision)
                # through a temporary file, so a process reading the cache
                # while another builds it never sees a partial file
                tmp = f"{self.tensor_path}.{os.getpid()}.tmp"
                with open(tmp, "wb") as f:
                    np.savez_compressed(f, windows=self._windows)
                os.replace(tmp, self.tensor_path)
        return self._windows

    def splits(self, split=(0.85, 0.10)) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Contiguous train/val/test split (chorale_dataset.py:561-567)."""
        assert sum(split) < 1
        w = self.windows
        n = len(w)
        a, b = split
        return (w[:int(a * n)],
                w[int(a * n):int((a + b) * n)],
                w[int((a + b) * n):])


def batch_iterator(windows: np.ndarray,
                   batch_size: int,
                   rng: Optional[np.random.RandomState],
                   drop_last: bool = True) -> Iterator[np.ndarray]:
    """Shuffled (or sequential) batches of windows, dropping the remainder
    like the reference DataLoaders (chorale_dataset.py:569-595)."""
    n = len(windows)
    order = np.arange(n)
    if rng is not None:
        rng.shuffle(order)
    end = n - (n % batch_size) if drop_last else n
    for start in range(0, end, batch_size):
        yield windows[order[start:start + batch_size]]
