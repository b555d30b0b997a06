"""The VQ-CPC encoder trainer (counterpart of
vqcpcb_tpu/training/encoder_trainer.py): the data-dependent codebook init
(:65-120), the train and eval steps (:133-188), the epoch with its
tokens/s (:191-238), the epoch loop with its checkpoints (training/loop.py)
and `encode`.

`VQCPCEncoderTrainer` holds a VQCPCModel on one device (the card unless the
caller names another), the clipped Adam of training/optim.py, the step count
and two generators every random draw comes from: one on that device
(dropout and label corruption) and one on the host (the dropout seeds of a
transformer downscaler's attention layers); the codebook-init permutation
comes from a device generator seeded with the seed, the same on every rank.
Steps run in f32, as the JAX steps do (the GRU recurrence is f32
there by design); VQCPCB_COMPUTE_DTYPE=bfloat16 puts a transformer
downscaler's layers in bf16 and nothing else, as in JAX
(utils.layer_compute_dtype). `save` / `load` (training/loop.py) keep the whole state:
parameters, the BatchNorm and EMA buffers, the optimizer, the step and the
generators. Under a profiler a train step is the span vqcpcb.train_step
over vqcpcb.forward, .backward and .optimizer (training/profiling.py).

Over a (data, model) mesh (`mesh`, by default parallel/mesh.make_mesh()
over every rank, as JAX's trainer builds one over every device,
encoder_trainer.py:45-55) the model keeps its blocks (shard_params: a
transformer downscaler's layers split over `model`; the GRUs, the CModule,
the scorers and the upscaler stay replicated, as JAX's TP_RULES have them)
and each step takes this rank's rows: cut from the global batch by
shard_batch, or, with `local_batches`, passed in by the caller, the rank's
shard of the global batch (shard_batch_local; every rank of one data index
passes the same rows, each the same count). The quantizer's BatchNorm and
EMA statistics, the codebook-usage histograms and the metrics are the
global batch's (ops/quantizer.py, models/cpc.py); Adam averages the
gradients over `data` and its clip counts a model-split gradient once;
tokens_per_sec counts the global batch; the codebook init runs on the
global batch on every rank (gathered over `data` under local_batches),
its permutations drawn from one generator. A train batch must divide the
data axis (a batch kept whole on every rank would count the EMA
statistics once a rank). The device generator is seeded with seed + data_index (each data rank's own
dropout stream), the host seed generator with seed on every rank (the K7
wrappers offset it per shard). Rank 0 writes the one-GPU layout
(training/loop.py) and every rank's `load` keeps its blocks. A one-rank
mesh is the single-device path.
"""
from __future__ import annotations

import time
from itertools import islice
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from vqcpcb_tpu_torch.models.cpc import VQCPCModel
from vqcpcb_tpu_torch.ops.quantizer import (EMAProductVectorQuantizer,
                                            ProductVectorQuantizer,
                                            initialize_codebooks)
from vqcpcb_tpu_torch.ops.transformer import wire_generators
from vqcpcb_tpu_torch.parallel.collectives import gather_over_data
from vqcpcb_tpu_torch.parallel.mesh import (make_mesh, module_specs,
                                            shard_batch, shard_batch_local,
                                            shard_params)
from vqcpcb_tpu_torch.training.loop import TrainLoopMixin
from vqcpcb_tpu_torch.training.optim import (WARMUP_STEPS, Adam,
                                             trapezoid_schedule,
                                             warmup_steps_from_env)
from vqcpcb_tpu_torch.training.profiling import check_finite, count, span
from vqcpcb_tpu_torch.utils import resolve_device, to_device

# batch keys whose elements count as the step's tokens (encoder_trainer.py:227)
TOKEN_KEYS = ("x_left", "x_right", "negative_samples")


def whole_batch(x, mesh, local_batches: bool, device: torch.device) -> torch.Tensor:
    """The global batch on `device`: x itself or, when x is this rank's rows
    (local_batches), every data rank's rows gathered in data order."""
    x = to_device(x, device)
    return gather_over_data(x.contiguous(), mesh) if local_batches else x


def place_rows(batch, mesh, local_batches: bool, train: bool):
    """This rank's rows of a batch: shard_batch of the global batch, or the
    caller's own rows (shard_batch_local). A train batch must divide the
    data axis under a mesh of several data ranks."""
    if local_batches:
        return shard_batch_local(batch, mesh)
    if train and mesh.n_data > 1:
        rows = {int(np.shape(x)[0]) for x in
                (batch.values() if isinstance(batch, dict) else [batch])}
        if any(r % mesh.n_data for r in rows):
            raise ValueError(f"a train batch of {sorted(rows)} rows does not "
                             f"divide the data axis ({mesh.n_data} ranks)")
    return shard_batch(batch, mesh)


class VQCPCEncoderTrainer(TrainLoopMixin):
    """model_dir and dataloader_generator serve train_model, save and load
    (training/loop.py); the steps need neither. mesh: the (data, model) mesh
    to train over; local_batches: every batch given to the steps, the
    epochs and init_state is this rank's rows (see the module
    docstring)."""

    monitor_key = "loss_monitor"

    def __init__(self, model: VQCPCModel, device=None, seed: int = 0,
                 model_dir: Optional[str] = None, dataloader_generator=None,
                 mesh=None, local_batches: bool = False):
        self.model_dir = model_dir
        self.dataloader_generator = dataloader_generator
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.local_batches = local_batches
        self.seed = seed
        self.model = shard_params(model.to(self.device), self.mesh)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + self.mesh.data_index)
        self.seed_generator = torch.Generator().manual_seed(seed)
        wire_generators(self.model, self.generator, self.seed_generator)
        self.optimizer: Optional[Adam] = None
        self.step = 0

    def _batch(self, batch: Dict, train: bool = False) -> Dict[str, torch.Tensor]:
        keys = TOKEN_KEYS + (("negative_samples_back",)
                             if self.model.bidirectional else ())
        rows = place_rows({k: batch[k] for k in keys}, self.mesh,
                          self.local_batches, train)
        return {k: to_device(v, self.device) for k, v in rows.items()}

    @torch.no_grad()
    def init_state(self, sample_batch: Dict, lr: float,
                   schedule_lr: bool = False,
                   perms: Optional[Sequence] = None,
                   warmup_steps: int = WARMUP_STEPS,
                   initialize: bool = True) -> "VQCPCEncoderTrainer":
        """Fresh optimizer state at step 0 and, when `initialize`, the
        data-dependent codebook init (product quantizers) from the batch's
        negatives stream, the first tensor to reach the quantizer
        (vector_quantizer.py:101-102 of the reference): the downscaler's
        latents of all negatives of the global batch (gathered over `data`
        under local_batches), in eval mode, permuted by `perms` (one per
        sub-codebook) or by permutations from a device generator seeded with
        the trainer's seed: every rank sets the codebooks one rank sets from
        the whole batch. A trainer about to load a checkpoint passes
        initialize=False. The weights are the module's own."""
        quantizer = self.model.encoder.quantizer
        if initialize and isinstance(quantizer, (ProductVectorQuantizer,
                                                 EMAProductVectorQuantizer)):
            neg = whole_batch(sample_batch["negative_samples"], self.mesh,
                              self.local_batches, self.device)
            b, n, k, ticks, voices = neg.shape
            z = self.model.encoder.downscale(
                neg.reshape(b * n * k, ticks, voices), training=False)
            quantizer.set_codebooks(initialize_codebooks(
                z.reshape(-1, quantizer.codebook_dim), quantizer.num_codebooks,
                quantizer.codebook_size,
                torch.Generator(device=self.device).manual_seed(self.seed), perms))
        specs = module_specs(self.model)
        named = list(self.model.named_parameters())
        self.optimizer = Adam(
            [p for _, p in named],
            trapezoid_schedule(lr, warmup_steps) if schedule_lr else lr,
            mesh=self.mesh, specs=[specs.get(name) for name, _ in named])
        self.step = 0
        return self

    def train_step(self, batch: Dict, corrupt_labels: bool = False
                   ) -> Dict[str, torch.Tensor]:
        """One clipped Adam step; returns the metrics as device tensors (not
        read back)."""
        if self.optimizer is None:
            raise RuntimeError("init_state before train_step")
        with span("vqcpcb.train_step"):
            count("steps")
            batch = self._batch(batch, train=True)
            self.model.train()
            self.optimizer.zero_grad()
            with span("vqcpcb.forward"):
                loss, metrics = self.model(batch, training=True,
                                           corrupt_labels=corrupt_labels,
                                           generator=self.generator)
            check_finite(loss)
            with span("vqcpcb.backward"):
                loss.backward()
            self.optimizer.step()
            self.step += 1
            return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        self.model.eval()
        return self.model(self._batch(batch), training=False,
                          generator=self.generator)[1]

    def epoch(self, data_loader: Iterable, train: bool,
              num_batches: Optional[int] = None,
              corrupt_labels: bool = False) -> Dict:
        """Train or evaluate over up to num_batches batches; returns each
        metric's mean (vectors as lists), tokens_per_sec (x_left + x_right +
        negatives elements of the global batch over the wall time) and
        loss_monitor (minus the mean accuracy). The metrics accumulate on
        the device, read once at the end."""
        sums, count, tokens = None, 0, 0
        t0 = time.perf_counter()
        for batch in islice(data_loader, num_batches):
            metrics = (self.train_step(batch, corrupt_labels) if train
                       else self.eval_step(batch))
            metrics = {k: v.float() for k, v in metrics.items()}
            sums = metrics if sums is None else {
                k: sums[k] + metrics[k] for k in sums}
            count += 1
            tokens += sum(int(np.prod(batch[k].shape)) for k in TOKEN_KEYS) * (
                self.mesh.n_data if self.local_batches else 1)
        if sums is None:
            return {}
        host = {k: v.cpu().double().numpy() / count for k, v in sums.items()}
        elapsed = time.perf_counter() - t0
        means = {k: v.tolist() if v.ndim else float(v) for k, v in host.items()}
        means["tokens_per_sec"] = tokens / max(elapsed, 1e-9)
        if "accuracy" in means:
            means["loss_monitor"] = -float(np.mean(means["accuracy"]))
        return means

    # ---- the epoch loop (training/loop.py) and its state --------------------

    def _init_from_first(self, first, lr, schedule_lr, initialize):
        self.init_state(first, lr=lr, schedule_lr=schedule_lr,
                        warmup_steps=warmup_steps_from_env(),
                        initialize=initialize)

    def _epoch_kwargs(self, corrupt_labels):
        return {"corrupt_labels": corrupt_labels}

    def _checkpointed(self):
        """The whole VQ-CPC model, its BatchNorm statistics and EMA
        codebooks included."""
        return self.model

    def _generators(self) -> Dict[str, torch.Generator]:
        return {"generator": self.generator,
                "seed_generator": self.seed_generator}

    @torch.no_grad()
    def encode(self, x):
        """Token windows (B, ticks, voices) -> (z_quantized, indices,
        q_loss) in eval mode."""
        self.model.eval()
        return self.model.encoder(to_device(x, self.device), training=False)
