"""The epoch loop shared by the trainers (counterpart of
vqcpcb_tpu/training/loop.py): `TrainLoopMixin.train_model` (:156-231) runs
fresh data loaders per epoch (reseeded per epoch), a train and a half-length
val epoch, prints both, saves `overfitted` every epoch and `early_stopped`
on the best val monitor, and writes metrics.jsonl. A resumed run continues
the epoch numbering and the early-stopping bar from metrics.jsonl.

Step checkpoints: with `checkpoint_every_steps` (the argument, the config
key, or VQCPCB_CKPT_EVERY_STEPS as the JAX package reads it) the train epoch
runs in chunks and saves the trainer state after each into the step slot,
whose sidecar holds the epoch, the batches done, the partial metric sums
and the state of every generator the trainer draws from. `train_model` on
the same model directory then restores it and skips the batches already
trained: the per-epoch reseed replays the same stream, so the resumed run
ends where the uninterrupted one does.

A trainer provides `epoch()`, `init_state()`, `_init_from_first()`,
`_checkpointed()` (the module whose state_dict is saved), `_generators()`
(name -> every torch.Generator it draws from), `model_dir`,
`dataloader_generator`, `optimizer` (None before init_state) and `step`,
and may override `monitor_key` and `_epoch_kwargs`.
"""
from __future__ import annotations

import itertools
import os
from typing import Dict, Optional

import numpy as np
import torch

from vqcpcb_tpu_torch.training import checkpoints
from vqcpcb_tpu_torch.training.metrics import MetricsWriter
from vqcpcb_tpu_torch.utils import dict_pretty_print


class _CountingIterator:
    """Counts the items taken, so chunked epoch() calls over one stream know
    how many batches each consumed."""

    def __init__(self, it):
        self._it = iter(it)
        self.count = 0

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self._it)
        self.count += 1
        return item


def _merge_sums(sums: dict, count: int, means: dict, n: int):
    """sums += means * n per key (scalars or per-k lists)."""
    for k, v in means.items():
        arr = np.asarray(v, dtype=np.float64) * n
        sums[k] = np.asarray(sums[k], dtype=np.float64) + arr if k in sums else arr
    return sums, count + n


def _sums_to_means(sums: dict, count: int) -> dict:
    """Scalars as floats, vectors as lists, as the epochs return them."""
    out = {}
    for k, v in sums.items():
        arr = np.asarray(v, dtype=np.float64) / max(count, 1)
        out[k] = float(arr) if arr.ndim == 0 else arr.tolist()
    return out


class TrainLoopMixin:
    monitor_key = "loss"

    def _epoch_kwargs(self, corrupt_labels: bool) -> dict:
        return {}

    # ---- the trainer's state ----------------------------------------------------

    def state_dict(self) -> Dict:
        """The module's parameters and buffers, the optimizer, the step and
        every generator's state (with its device type)."""
        return {"model": self._checkpointed().state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step,
                "generators": {name: {"device": g.device.type,
                                      "state": g.get_state()}
                               for name, g in self._generators().items()}}

    def load_state_dict(self, state: Dict) -> None:
        """Restore a state_dict(); init_state first (it builds the
        optimizer). A generator state saved on another device type (a
        card's generator read on the CPU) leaves that generator as it is."""
        self._checkpointed().load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        generators = self._generators()
        for name, saved in state["generators"].items():
            if saved["device"] == generators[name].device.type:
                generators[name].set_state(
                    torch.as_tensor(saved["state"], dtype=torch.uint8).cpu())

    # ---- the two slots --------------------------------------------------------

    def save(self, early_stopped: bool) -> None:
        checkpoints.save_state(self.model_dir, early_stopped, self.state_dict())

    def load(self, early_stopped: bool) -> None:
        """The whole state of a slot; init_state first (it builds the
        optimizer whose moments this restores, as the JAX load does)."""
        if self.optimizer is None:
            raise RuntimeError("call init_state before load, so the optimizer "
                               "exists")
        self.load_state_dict(checkpoints.load_state(self.model_dir, early_stopped))

    # ---- the step slot --------------------------------------------------------

    def _save_step_checkpoint(self, epoch_id: int, batches_done: int,
                              sums: dict, count: int) -> None:
        state = self.state_dict()
        generators = state.pop("generators")
        info = {"epoch": int(epoch_id), "batches_done": int(batches_done),
                "metric_sums": {k: np.asarray(v, dtype=np.float64).tolist()
                                for k, v in sums.items()},
                "metric_count": int(count),
                "generators": {name: {"device": g["device"],
                                      "state": g["state"].tolist()}
                               for name, g in generators.items()}}
        checkpoints.save_step_state(self.model_dir, state, info)

    def _restore_step_checkpoint(self, info: dict) -> None:
        state = checkpoints.load_step_state(self.model_dir)
        state["generators"] = info["generators"]
        self.load_state_dict(state)

    def _train_epoch_chunked(self, generator_train, num_batches,
                             checkpoint_every_steps: Optional[int],
                             epoch_id: int, skip: int, partial: Optional[dict],
                             ek: dict) -> dict:
        """The train epoch, with a step checkpoint every
        `checkpoint_every_steps` batches; returns the epoch's mean metrics,
        weighted over the chunks and any partial sums from before a crash."""
        if checkpoint_every_steps is None:
            return self.epoch(generator_train, True, num_batches, **ek)
        sums, count = {}, 0
        if partial is not None:
            sums = {k: np.asarray(v, dtype=np.float64)
                    for k, v in partial.get("metric_sums", {}).items()}
            count = int(partial.get("metric_count", 0))
        counting = _CountingIterator(generator_train)
        consumed = 0
        while num_batches is None or consumed < num_batches:
            chunk = checkpoint_every_steps
            if num_batches is not None:
                chunk = min(chunk, num_batches - consumed)
            before = counting.count
            means = self.epoch(counting, True, chunk, **ek)
            n = counting.count - before
            if n == 0:
                break
            sums, count = _merge_sums(sums, count, means, n)
            consumed += n
            self._save_step_checkpoint(epoch_id, skip + consumed, sums, count)
            if n < chunk:
                break                    # the stream ended inside the chunk
        return _sums_to_means(sums, count)

    # ---- the loop ---------------------------------------------------------------

    def train_model(self,
                    batch_size: int,
                    num_batches: Optional[int] = None,
                    num_epochs: int = 10,
                    lr: float = 1e-3,
                    corrupt_labels: bool = False,
                    schedule_lr: bool = False,
                    plot: bool = False,
                    num_workers: int = 0,
                    initialize: bool = True,
                    checkpoint_every_steps: Optional[int] = None,
                    **kwargs) -> None:
        writer = MetricsWriter(self.model_dir, plot=plot)
        start_epoch = writer.epochs_logged()
        best_val = writer.best_val(self.monitor_key)
        ek = self._epoch_kwargs(corrupt_labels)
        if checkpoint_every_steps is None:
            env = int(os.environ.get("VQCPCB_CKPT_EVERY_STEPS", "0"))
            checkpoint_every_steps = env if env > 0 else None

        resume = checkpoints.read_step_sidecar(self.model_dir)
        if resume is not None and resume.get("epoch", -1) < start_epoch:
            # stale: the epoch it belongs to completed (its metrics row exists)
            checkpoints.clear_step_state(self.model_dir)
            resume = None

        for epoch_id in range(start_epoch, start_epoch + num_epochs):
            self.dataloader_generator.reseed(epoch_id)
            generator_train, generator_val, _ = \
                self.dataloader_generator.dataloaders(
                    batch_size=batch_size, num_workers=num_workers)
            if self.optimizer is None:
                generator_train = iter(generator_train)
                first = next(generator_train)
                self._init_from_first(first, lr, schedule_lr, initialize)
                # the init batch is trained on too
                generator_train = itertools.chain([first], generator_train)

            skip, partial = 0, None
            if resume is not None and resume["epoch"] == epoch_id:
                self._restore_step_checkpoint(resume)
                skip = int(resume["batches_done"])
                partial = resume
                generator_train = itertools.islice(iter(generator_train), skip,
                                                   None)
                print(f"resuming epoch {epoch_id} from step checkpoint "
                      f"({skip} batches already trained)")
            resume = None

            remaining = (None if num_batches is None
                         else max(num_batches - skip, 0))
            monitored_train = self._train_epoch_chunked(
                generator_train, remaining, checkpoint_every_steps, epoch_id,
                skip, partial, ek)
            monitored_val = self.epoch(
                generator_val, False,
                num_batches // 2 if num_batches is not None else None, **ek)

            print(f"======= Epoch {epoch_id} =======")
            print("---Train---")
            dict_pretty_print(monitored_train, endstr=" " * 5)
            print()
            print("---Val---")
            dict_pretty_print(monitored_val, endstr=" " * 5)
            print("\n")

            self.save(early_stopped=False)
            valid_loss = monitored_val.get(self.monitor_key, 1e8)
            if valid_loss < best_val:
                self.save(early_stopped=True)
                best_val = valid_loss
            writer.write(epoch_id, monitored_train, monitored_val)
            # the epoch-boundary saves supersede any mid-epoch checkpoint
            checkpoints.clear_step_state(self.model_dir)
