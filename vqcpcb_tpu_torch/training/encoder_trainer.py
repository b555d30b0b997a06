"""The VQ-CPC encoder trainer (counterpart of
vqcpcb_tpu/training/encoder_trainer.py): the data-dependent codebook init
(:65-120), the train and eval steps (:133-188), the epoch with its
tokens/s (:191-238), the epoch loop with its checkpoints (training/loop.py)
and `encode`.

`VQCPCEncoderTrainer` holds a VQCPCModel on one device (the card unless the
caller names another), the clipped Adam of training/optim.py, the step count
and two generators every random draw comes from: one on that device
(dropout, label corruption and the codebook-init permutation) and one on
the host (the dropout seeds of a transformer downscaler's attention
layers). Steps run in f32, as the JAX steps do (the GRU recurrence is f32
there by design); VQCPCB_COMPUTE_DTYPE=bfloat16 puts a transformer
downscaler's layers in bf16 and nothing else, as in JAX
(utils.layer_compute_dtype). `save` / `load` (training/loop.py) keep the whole state:
parameters, the BatchNorm and EMA buffers, the optimizer, the step and the
generators.
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
from vqcpcb_tpu_torch.training.loop import TrainLoopMixin
from vqcpcb_tpu_torch.training.optim import (WARMUP_STEPS, Adam,
                                             trapezoid_schedule,
                                             warmup_steps_from_env)
from vqcpcb_tpu_torch.utils import resolve_device, to_device

# batch keys whose elements count as the step's tokens (encoder_trainer.py:227)
TOKEN_KEYS = ("x_left", "x_right", "negative_samples")


class VQCPCEncoderTrainer(TrainLoopMixin):
    """model_dir and dataloader_generator serve train_model, save and load
    (training/loop.py); the steps need neither."""

    monitor_key = "loss_monitor"

    def __init__(self, model: VQCPCModel, device=None, seed: int = 0,
                 model_dir: Optional[str] = None, dataloader_generator=None):
        self.model_dir = model_dir
        self.dataloader_generator = dataloader_generator
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.seed_generator = torch.Generator().manual_seed(seed)
        wire_generators(self.model, self.generator, self.seed_generator)
        self.optimizer: Optional[Adam] = None
        self.step = 0

    def _batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        keys = TOKEN_KEYS + (("negative_samples_back",)
                             if self.model.bidirectional else ())
        return {k: to_device(batch[k], self.device) for k in keys}

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
        latents of all negatives, in eval mode, permuted by `perms` (one per
        sub-codebook) or by permutations from the trainer's generator. A
        trainer about to load a checkpoint passes initialize=False. The
        weights are the module's own."""
        quantizer = self.model.encoder.quantizer
        if initialize and isinstance(quantizer, (ProductVectorQuantizer,
                                                 EMAProductVectorQuantizer)):
            neg = to_device(sample_batch["negative_samples"], self.device)
            b, n, k, ticks, voices = neg.shape
            z = self.model.encoder.downscale(
                neg.reshape(b * n * k, ticks, voices), training=False)
            quantizer.set_codebooks(initialize_codebooks(
                z.reshape(-1, quantizer.codebook_dim), quantizer.num_codebooks,
                quantizer.codebook_size, self.generator, perms))
        self.optimizer = Adam(
            self.model.parameters(),
            trapezoid_schedule(lr, warmup_steps) if schedule_lr else lr)
        self.step = 0
        return self

    def train_step(self, batch: Dict, corrupt_labels: bool = False
                   ) -> Dict[str, torch.Tensor]:
        """One clipped Adam step; returns the metrics as device tensors (not
        read back)."""
        if self.optimizer is None:
            raise RuntimeError("init_state before train_step")
        batch = self._batch(batch)
        self.model.train()
        self.optimizer.zero_grad()
        loss, metrics = self.model(batch, training=True,
                                   corrupt_labels=corrupt_labels,
                                   generator=self.generator)
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
        negatives elements over the wall time) and loss_monitor (minus the
        mean accuracy). The metrics accumulate on the device, read once at
        the end."""
        sums, count, tokens = None, 0, 0
        t0 = time.perf_counter()
        for batch in islice(data_loader, num_batches):
            metrics = (self.train_step(batch, corrupt_labels) if train
                       else self.eval_step(batch))
            metrics = {k: v.float() for k, v in metrics.items()}
            sums = metrics if sums is None else {
                k: sums[k] + metrics[k] for k in sums}
            count += 1
            tokens += sum(int(np.prod(batch[k].shape)) for k in TOKEN_KEYS)
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
