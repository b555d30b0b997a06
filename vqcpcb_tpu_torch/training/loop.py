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

`load` also reads a weights-only slot (a migrated reference checkpoint,
checkpoints.save_weights_only): the module entries it names are adopted,
the optimizers keep their fresh moments and `step` its value, so `-t -l`
continues training from reference weights.

With VQCPCB_PROFILE_DIR set, each train epoch is traced
(profiling.maybe_profile, as the JAX loop at :208).

A trainer provides `init_state()`, `_init_from_first()`,
`_checkpointed()` (the module whose state_dict is saved), `_generators()`
(name -> every torch.Generator it draws from), `model_dir`,
`dataloader_generator`, `optimizer` (None before init_state) and `step`,
and may override `monitor_key`, `_epoch_kwargs`, `_optimizers()` (name
-> every optimizer it steps, each saved under its name; by default
`optimizer`, saved as "optimizer") and `epoch()` (by default the mean of
the {'loss'} that `train_step(x)` / `eval_step(x)` return).

Over a mesh of several ranks (a trainer's `mesh`, parallel/mesh.py) every
rank runs the loop on the same global batches (the per-epoch reseed is the
same everywhere) and calls every save, whose state it gathers into the
one-GPU layout (collective); rank 0 alone writes the slots, the step slot,
metrics.jsonl and the events file, and prints. A state keeps every rank's
generators (`generators_by_rank`) beside rank 0's (`generators`, which a
one-rank load reads); every rank loads the one-GPU layout and keeps its
blocks.
"""
from __future__ import annotations

import itertools
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from vqcpcb_tpu_torch.parallel.mesh import (gather_params, local_state_dict,
                                            module_specs)
from vqcpcb_tpu_torch.training import checkpoints
from vqcpcb_tpu_torch.training.metrics import MetricsWriter
from vqcpcb_tpu_torch.training.profiling import maybe_profile
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

    def epoch(self, batches: Iterable, train: bool,
              num_batches: Optional[int] = None) -> Dict[str, float]:
        """Train or evaluate over up to num_batches batches, each a dict
        whose 'x' holds a token batch, as the data loaders give them, with
        train_step / eval_step returning {'loss'} as a device scalar;
        returns the mean loss and tokens/s (the elements of 'x'), with one
        read of the device at the end (decoder_trainer.py:204-230,
        prior_trainer.py:139-167)."""
        total, count, tokens = None, 0, 0
        t0 = time.perf_counter()
        for batch in itertools.islice(batches, num_batches):
            x = batch["x"]
            loss = (self.train_step(x) if train else self.eval_step(x))["loss"]
            total = loss.float() if total is None else total + loss.float()
            count += 1
            tokens += int(np.prod(x.shape))
        if not count:
            return {}
        mean = total.item() / count
        return {"loss": mean,
                "tokens_per_sec": tokens / max(time.perf_counter() - t0, 1e-9)}

    def _epoch_kwargs(self, corrupt_labels: bool) -> dict:
        return {}

    def _optimizers(self) -> Dict:
        return {"optimizer": self.optimizer}

    @property
    def initialized(self) -> bool:
        """Whether init_state has built the optimizers."""
        return all(opt is not None for opt in self._optimizers().values())

    # ---- the mesh ------------------------------------------------------------------

    @property
    def _multi_rank_mesh(self):
        """The trainer's mesh when it has several ranks, else None."""
        mesh = getattr(self, "mesh", None)
        return mesh if mesh is not None and mesh.size > 1 else None

    @property
    def _writes(self) -> bool:
        """Whether this rank writes the files (rank 0, or the only rank)."""
        mesh = self._multi_rank_mesh
        return mesh is None or mesh.rank == 0

    def _generator_states(self) -> Dict:
        """{"generators": rank 0's states, and over several ranks
        "generators_by_rank": every rank's, in rank order (collective)}."""
        own = {name: {"device": g.device.type, "state": g.get_state()}
               for name, g in self._generators().items()}
        if self._multi_rank_mesh is None:
            return {"generators": own}
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, own)
        return {"generators": everyone[0], "generators_by_rank": everyone}

    def _restore_generators(self, state: Dict) -> None:
        """This rank's saved generator states (rank 0's when the state was
        saved by another number of ranks); a state saved on another device
        type (a card's generator read on the CPU) leaves that generator as
        it is."""
        saved = state["generators"]
        mesh = self._multi_rank_mesh
        by_rank = state.get("generators_by_rank")
        if mesh is not None and by_rank is not None and len(by_rank) == mesh.size:
            saved = by_rank[mesh.rank]
        generators = self._generators()
        for name, entry in saved.items():
            if entry["device"] == generators[name].device.type:
                generators[name].set_state(
                    torch.as_tensor(entry["state"], dtype=torch.uint8).cpu())

    def _local_weights(self, weights: Dict[str, torch.Tensor]) -> Dict:
        """A one-GPU-layout state_dict cut to this rank's blocks."""
        mesh = self._multi_rank_mesh
        if mesh is None:
            return weights
        return local_state_dict(weights, module_specs(self._checkpointed()), mesh)

    # ---- the trainer's state ----------------------------------------------------

    def state_dict(self) -> Dict:
        """The module's parameters and buffers, each optimizer, the step and
        every generator's state (with its device type), in the one-GPU
        layout (collective over a mesh of several ranks)."""
        module = self._checkpointed()
        mesh = self._multi_rank_mesh
        return {"model": (module.state_dict() if mesh is None
                          else gather_params(module, mesh)),
                **{name: opt.state_dict()
                   for name, opt in self._optimizers().items()},
                "step": self.step, **self._generator_states()}

    def load_state_dict(self, state: Dict) -> None:
        """Restore a state_dict(); init_state first (it builds the
        optimizers). A generator state saved on another device type (a
        card's generator read on the CPU) leaves that generator as it is.
        A weights-only state (checkpoints.save_weights_only) is adopted
        instead (adopt_weights)."""
        if checkpoints.is_weights_only(state):
            self.adopt_weights(state["model"])
            return
        self._checkpointed().load_state_dict(self._local_weights(state["model"]))
        for name, opt in self._optimizers().items():
            opt.load_state_dict(state[name])
        self.step = int(state["step"])
        self._restore_generators(state)

    def adopt_weights(self, weights: Dict[str, torch.Tensor]) -> None:
        """Copy the entries of a weights-only state into the checkpointed
        module (vqcpcb_tpu/training/checkpoints.py:62-118): entries it does
        not name keep their values (a VQ-CPC model's context and scorer nets,
        which the reference never saves), the optimizers their fresh moments,
        `step` and the generators their state. Every entry must land on a
        module entry of its shape, else ValueError."""
        module = self._checkpointed()
        target = module.state_dict()
        weights = self._local_weights(weights)
        unmatched = sorted(set(weights) - set(target))
        if unmatched:
            fused = [k for k in unmatched if k.endswith(("in_proj_weight", "in_proj_bias"))
                     and k.rsplit(".", 1)[0] + ".q_proj.weight" in target]
            hint = (f"; {fused[0]}: the reference's fused in_proj does not fit a "
                    "grouped-query attention (n_head_kv below n_head keeps "
                    "separate q_proj / kv_proj)" if fused else "")
            raise ValueError(f"weights-only checkpoint: {len(unmatched)} of "
                             f"{len(weights)} entries have no matching module "
                             f"entry (first: {unmatched[0]}){hint}")
        for name, value in weights.items():
            if tuple(value.shape) != tuple(target[name].shape):
                raise ValueError(f"weights-only entry {name}: shape "
                                 f"{tuple(value.shape)} != the module's "
                                 f"{tuple(target[name].shape)}")
        module.load_state_dict({**target, **weights})

    # ---- the two slots --------------------------------------------------------

    def save(self, early_stopped: bool) -> None:
        """Every rank calls it; rank 0 writes."""
        state = self.state_dict()
        if self._writes:
            checkpoints.save_state(self.model_dir, early_stopped, state)

    def load(self, early_stopped: bool) -> None:
        """The whole state of a slot; init_state first (it builds the
        optimizer whose moments this restores, as the JAX load does)."""
        if not self.initialized:
            raise RuntimeError("call init_state before load, so the optimizer "
                               "exists")
        self.load_state_dict(checkpoints.load_state(self.model_dir, early_stopped))

    # ---- the step slot --------------------------------------------------------

    def _save_step_checkpoint(self, epoch_id: int, batches_done: int,
                              sums: dict, count: int) -> None:
        state = self.state_dict()
        if not self._writes:
            return

        def listed(generators):
            return {name: {"device": g["device"], "state": g["state"].tolist()}
                    for name, g in generators.items()}

        info = {"epoch": int(epoch_id), "batches_done": int(batches_done),
                "metric_sums": {k: np.asarray(v, dtype=np.float64).tolist()
                                for k, v in sums.items()},
                "metric_count": int(count),
                "generators": listed(state.pop("generators"))}
        if "generators_by_rank" in state:
            info["generators_by_rank"] = [listed(g) for g in
                                          state.pop("generators_by_rank")]
        checkpoints.save_step_state(self.model_dir, state, info)

    def _restore_step_checkpoint(self, info: dict) -> None:
        state = checkpoints.load_step_state(self.model_dir)
        state["generators"] = info["generators"]
        if "generators_by_rank" in info:
            state["generators_by_rank"] = info["generators_by_rank"]
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
        writer = MetricsWriter(self.model_dir, plot=plot and self._writes)
        start_epoch = writer.epochs_logged()
        best_val = writer.best_val(self.monitor_key)
        ek = self._epoch_kwargs(corrupt_labels)
        if checkpoint_every_steps is None:
            env = int(os.environ.get("VQCPCB_CKPT_EVERY_STEPS", "0"))
            checkpoint_every_steps = env if env > 0 else None

        resume = checkpoints.read_step_sidecar(self.model_dir)
        if resume is not None and resume.get("epoch", -1) < start_epoch:
            # stale: the epoch it belongs to completed (its metrics row exists)
            if self._writes:
                checkpoints.clear_step_state(self.model_dir)
            resume = None

        for epoch_id in range(start_epoch, start_epoch + num_epochs):
            self.dataloader_generator.reseed(epoch_id)
            generator_train, generator_val, _ = \
                self.dataloader_generator.dataloaders(
                    batch_size=batch_size, num_workers=num_workers)
            if not self.initialized:
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
                if self._writes:
                    print(f"resuming epoch {epoch_id} from step checkpoint "
                          f"({skip} batches already trained)")
            resume = None

            remaining = (None if num_batches is None
                         else max(num_batches - skip, 0))
            with maybe_profile(f"epoch_{epoch_id}_train"):
                monitored_train = self._train_epoch_chunked(
                    generator_train, remaining, checkpoint_every_steps,
                    epoch_id, skip, partial, ek)
            monitored_val = self.epoch(
                generator_val, False,
                num_batches // 2 if num_batches is not None else None, **ek)

            if self._writes:
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
            if self._writes:
                writer.write(epoch_id, monitored_train, monitored_val)
                # the epoch-boundary saves supersede any mid-epoch checkpoint
                checkpoints.clear_step_state(self.model_dir)
