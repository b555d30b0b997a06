"""CPC batches for the encoder: a port-local NumPy copy of
BachCPCDataloaderGenerator (vqcpcb_tpu/data/dataloaders.py:135-329), with
both negative-sampling methods.

Each batch is a dict of NumPy int32 arrays {'x_left', 'x_right',
'negative_samples', 'negative_samples_back'}; the trainer moves them to its
device. The shuffles draw from np.random.RandomState, as in the JAX package,
so the same corpus and seed give the JAX generator's batches element for
element ('random': independent negative window streams; 'same_sequence':
the other blocks of the same excerpt; reference:
VQCPCB/dataloaders/bach_cpc_dataloader.py).
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from vqcpcb_tpu_torch.data.dataset import ChoraleBeatsDataset, batch_iterator

SUBDIVISION = 4
NUM_VOICES = 4


class BachCPCDataloaderGenerator:
    """Train / val / test CPC batch iterators over a corpus's windows; every
    dataloaders() call draws its shuffles from the one RandomState(seed)."""

    def __init__(self,
                 num_tokens_per_block: int,
                 num_blocks_left: int,
                 num_blocks_right: int,
                 negative_sampling_method: str,
                 num_negative_samples: int,
                 corpus,
                 cache_root=None,
                 seed: int = 0):
        assert num_tokens_per_block % (SUBDIVISION * NUM_VOICES) == 0
        self.num_tokens_per_block = num_tokens_per_block
        self.num_blocks_left = num_blocks_left
        self.num_blocks_right = num_blocks_right
        self.negative_sampling_method = negative_sampling_method
        self.num_negative_samples = num_negative_samples
        self._rng = np.random.RandomState(seed)
        num_tokens_per_beat = SUBDIVISION * NUM_VOICES
        num_tokens = num_tokens_per_block * (num_blocks_left + num_blocks_right)
        assert num_tokens % num_tokens_per_beat == 0
        num_beats_positive = num_tokens // num_tokens_per_beat
        self.dataset_positive = ChoraleBeatsDataset(
            corpus, sequences_size=num_beats_positive,
            subdivision=SUBDIVISION, cache_root=cache_root)
        if negative_sampling_method == "random":
            num_beats_negative = num_tokens_per_block // num_tokens_per_beat
            self.dataset_negative = ChoraleBeatsDataset(
                corpus, sequences_size=num_beats_negative,
                subdivision=SUBDIVISION, cache_root=cache_root)
        elif negative_sampling_method == "same_sequence":
            self.dataset_negative = None
        else:
            raise NotImplementedError(negative_sampling_method)

    def dataloaders(self, batch_size, shuffle_train=True, shuffle_val=False
                    ) -> Tuple[Iterator, Iterator, Iterator]:
        if self.negative_sampling_method == "random":
            return self._dataloader_random(batch_size, shuffle_train, shuffle_val)
        return self._dataloader_same_sequence(batch_size, shuffle_train, shuffle_val)

    # ---- helpers -------------------------------------------------------------

    def _split_left_right(self, batch: np.ndarray):
        """batch: (B, voices, ticks_total) -> x_left/x_right as
        (B, ticks, voices) (reference: bach_cpc_dataloader.py:136-147)."""
        ticks_left = (self.num_tokens_per_block * self.num_blocks_left
                      // NUM_VOICES)
        x_left = batch[:, :, :ticks_left].transpose(0, 2, 1)
        x_right = batch[:, :, ticks_left:].transpose(0, 2, 1)
        return (np.ascontiguousarray(x_left), np.ascontiguousarray(x_right))

    def _dataloader_random(self, batch_size, shuffle_train, shuffle_val):
        """Independent positive and negative window streams
        (reference: bach_cpc_dataloader.py:183-260)."""
        pos_splits = self.dataset_positive.splits()
        neg_splits = self.dataset_negative.splits()
        neg_bs = batch_size * self.num_negative_samples * self.num_blocks_right
        ticks_block = self.num_tokens_per_block // NUM_VOICES

        def gen(pos, neg, shuffle):
            rng = self._rng if shuffle else None
            # The negative stream is ALWAYS shuffled, even when the positive
            # stream is not (val/test). The reference zips an unshuffled val
            # DataLoader into the negative stream (chorale_dataset.py:578-585,
            # bach_cpc_dataloader.py:203-215), which makes each positive's
            # negatives CONSECUTIVE corpus windows deterministically aligned
            # with the positive stream — on the synthetic corpus this produced
            # a bimodal per-k val accuracy (0.17/0.93 by block) from
            # same-window collisions and near-duplicate negative sets
            # (BENCHMARKS.md "val plateau"). A fixed-seed RNG keeps val
            # deterministic across epochs while decorrelating the streams.
            neg_rng = rng if rng is not None else np.random.RandomState(
                0x5EED + len(neg))
            # small corpora may hold fewer windows than one negative batch:
            # tile so every epoch yields at least one batch. An EMPTY pool
            # would make neg_stream() below spin forever without yielding —
            # fail loudly instead (can happen for a tiny corpus whose val
            # split rounds to zero negative windows).
            neg_pool = neg
            if len(neg_pool) == 0:
                raise ValueError(
                    "negative-sample split is empty — the corpus is too "
                    "small for a 0.85/0.10/0.05 split at this window size; "
                    "use a larger corpus or longer chorales")
            if len(neg_pool) < neg_bs:
                reps = -(-neg_bs // len(neg_pool))
                neg_pool = np.tile(neg_pool, (reps, 1, 1))

            def neg_stream():
                # negatives loop forever over reshuffled epochs so the zip is
                # limited by the positive stream, as with the reference's
                # independently-sized DataLoaders
                while True:
                    yield from batch_iterator(neg_pool, neg_bs, neg_rng)

            neg_iter = neg_stream()
            neg_back_iter = neg_stream()
            for p in batch_iterator(pos, batch_size, rng):
                try:
                    n = next(neg_iter)
                    n_back = next(neg_back_iter)
                except StopIteration:
                    return
                x_left, x_right = self._split_left_right(p)
                negative = n.reshape(
                    batch_size, self.num_negative_samples,
                    self.num_blocks_right, NUM_VOICES, ticks_block
                ).transpose(0, 1, 2, 4, 3)
                negative_back = n_back.reshape(
                    batch_size, self.num_negative_samples,
                    self.num_blocks_right, NUM_VOICES, ticks_block
                ).transpose(0, 1, 2, 4, 3)
                yield {
                    "x_left": x_left,
                    "x_right": x_right,
                    "negative_samples": np.ascontiguousarray(negative),
                    "negative_samples_back": np.ascontiguousarray(negative_back),
                }

        train_p, val_p, test_p = pos_splits
        train_n, val_n, test_n = neg_splits
        return (gen(train_p, train_n, shuffle_train),
                gen(val_p, val_n, shuffle_val),
                gen(test_p, test_n, False))

    def _dataloader_same_sequence(self, batch_size, shuffle_train, shuffle_val):
        """Negatives are the other blocks of the same excerpt
        (reference: bach_cpc_dataloader.py:110-181). The configured
        num_negative_samples is ignored: num_neg = blocks_left+blocks_right-1."""
        num_neg = self.num_blocks_left + self.num_blocks_right - 1
        splits = self.dataset_positive.splits()

        def gen(split, shuffle):
            rng = self._rng if shuffle else None
            for p in batch_iterator(split, batch_size, rng):
                x_left, x_right = self._split_left_right(p)
                negative = self._build_negatives_same_seq(x_left, x_right)
                negative_back = self._build_negatives_same_seq(x_right, x_left)
                yield {
                    "x_left": x_left,
                    "x_right": x_right,
                    "negative_samples": negative,
                    "negative_samples_back": negative_back,
                }

        train, val, test = splits
        return (gen(train, shuffle_train), gen(val, shuffle_val), gen(test, False))

    def _build_negatives_same_seq(self, x_left: np.ndarray, x_right: np.ndarray
                                  ) -> np.ndarray:
        """(B, ticks, voices) pair -> (B, num_neg, blocks_right, ticks_block,
        voices) (reference: bach_cpc_dataloader.py:159-181)."""
        tb = self.num_tokens_per_block // NUM_VOICES
        b = x_left.shape[0]
        # block counts from the arrays: the backward direction swaps them
        left_b = x_left.reshape(b, -1, tb, NUM_VOICES)
        right_b = x_right.reshape(b, -1, tb, NUM_VOICES)
        outs = [np.concatenate([left_b, right_b[:, :k], right_b[:, k + 1:]],
                               axis=1)[:, :, None]
                for k in range(right_b.shape[1])]
        return np.ascontiguousarray(np.concatenate(outs, axis=2))
