"""The student (distilled VQ-VAE) encoder trainer (counterpart of
vqcpcb_tpu/training/student_trainer.py): `mask_batch` (:37) and
`StudentEncoderTrainer` (:58) -- the data-dependent codebook init
(:104-144), the two Adams (:152-159), the train and eval steps (:161-275),
the epoch (:279-304), and the epoch loop with its checkpoints
(training/loop.py).

One step trains two groups in turn on one batch. The teacher, a masked
language model with its own data processor, sees the chorale with one
event (drawn per batch) and the num_events_masked events on each side of it
replaced by the mask token, and learns the masked event by cross entropy.
The encoder and the auxiliary decoder then learn to match the teacher's
soft prediction of that event, taken before the teacher's update and
detached: the distilled cross entropy plus quantization_weighting times
the mean commitment loss. Each group has its own clipped Adam
(training/optim.py). Everything runs in f32 on one device (the card unless
the caller names another); VQCPCB_COMPUTE_DTYPE=bfloat16 puts the
transformer layers of the three modules in bf16, as in JAX
(utils.layer_compute_dtype).

The trainer holds the three modules in one ModuleDict (`model`: encoder,
teacher, auxiliary_decoder; the teacher's data processor lies under
teacher.data_processor), both optimizers, the step count and two
generators every random draw comes from: one on the device (the masked
event, the dropout layers, the codebook-init permutation) and one on the
host (the attention layers' dropout seeds). `save` / `load` keep them all.
"""
from __future__ import annotations

import time
from itertools import islice
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from vqcpcb_tpu_torch.models.encoder import Encoder
from vqcpcb_tpu_torch.ops.losses import (categorical_crossentropy,
                                         distilled_categorical_crossentropy)
from vqcpcb_tpu_torch.ops.quantizer import (EMAProductVectorQuantizer,
                                            ProductVectorQuantizer,
                                            initialize_codebooks)
from vqcpcb_tpu_torch.ops.transformer import wire_generators
from vqcpcb_tpu_torch.training.loop import TrainLoopMixin
from vqcpcb_tpu_torch.training.optim import (WARMUP_STEPS, Adam,
                                             trapezoid_schedule,
                                             warmup_steps_from_env)
from vqcpcb_tpu_torch.utils import resolve_device, to_device

METRICS = ("loss_teacher", "loss_quantization", "loss_reconstruction",
           "loss_encdec", "loss_monitor")


def mask_batch(x: torch.Tensor, masked_event_index: Union[int, torch.Tensor],
               num_events_masked: int, num_tokens_per_channel: Sequence[int]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, E, C) tokens -> (masked_x, notes_to_be_predicted): events within
    num_events_masked of masked_event_index take each channel's mask token
    (its vocabulary size, the tables' extra row); notes_to_be_predicted
    (B, E, C) int32 is 1 at the masked event only. The index may be a
    device scalar, so nothing is read back."""
    events = torch.arange(x.shape[1], device=x.device)
    index = torch.as_tensor(masked_event_index, device=x.device)
    to_mask = (events >= index - num_events_masked) & (events <= index + num_events_masked)
    mask_tokens = torch.tensor(list(num_tokens_per_channel), dtype=x.dtype,
                               device=x.device)
    masked_x = torch.where(to_mask[None, :, None], mask_tokens, x)
    predict = (events == index)[None, :, None].expand(x.shape).to(torch.int32)
    return masked_x, predict


class StudentEncoderTrainer(TrainLoopMixin):
    """model_dir and dataloader_generator serve train_model, save and load
    (training/loop.py); the steps need neither."""

    monitor_key = "loss_monitor"

    def __init__(self, encoder: Encoder, teacher: nn.Module,
                 auxiliary_decoder: nn.Module, num_events_masked: int,
                 quantization_weighting: float, device=None, seed: int = 0,
                 model_dir: Optional[str] = None, dataloader_generator=None):
        self.model_dir = model_dir
        self.dataloader_generator = dataloader_generator
        self.device = resolve_device(device)
        self.model = nn.ModuleDict({"encoder": encoder, "teacher": teacher,
                                    "auxiliary_decoder": auxiliary_decoder}
                                   ).to(self.device)
        self.encoder, self.teacher = encoder, teacher
        self.auxiliary_decoder = auxiliary_decoder
        self.num_events_masked = num_events_masked
        self.quantization_weighting = quantization_weighting
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.seed_generator = torch.Generator().manual_seed(seed)
        wire_generators(self.model, self.generator, self.seed_generator)
        self.optimizer_teacher: Optional[Adam] = None
        self.optimizer_encdec: Optional[Adam] = None
        self.step = 0

    @torch.no_grad()
    def init_state(self, sample_x, lr: float, schedule_lr: bool = False,
                   perms: Optional[Sequence] = None,
                   warmup_steps: int = WARMUP_STEPS,
                   initialize: bool = True) -> "StudentEncoderTrainer":
        """Fresh optimizers at step 0 -- one for the teacher and its data
        processor, one for the encoder and the auxiliary decoder -- and,
        when `initialize`, the data-dependent codebook init (product
        quantizers): the downscaler's latents of `sample_x` in eval mode,
        permuted by `perms` (one per sub-codebook) or by permutations from
        the trainer's generator; the batch must give at least codebook_size
        latents. A trainer about to load a checkpoint passes
        initialize=False."""
        quantizer = self.encoder.quantizer
        if initialize and isinstance(quantizer, (ProductVectorQuantizer,
                                                 EMAProductVectorQuantizer)):
            z = self.encoder.downscale(to_device(sample_x, self.device),
                                       training=False)
            quantizer.set_codebooks(initialize_codebooks(
                z.reshape(-1, quantizer.codebook_dim), quantizer.num_codebooks,
                quantizer.codebook_size, self.generator, perms))
        schedule = trapezoid_schedule(lr, warmup_steps) if schedule_lr else lr
        self.optimizer_teacher = Adam(self.teacher.parameters(), schedule)
        self.optimizer_encdec = Adam(
            list(self.encoder.parameters())
            + list(self.auxiliary_decoder.parameters()), schedule)
        self.step = 0
        return self

    # ---- the steps ---------------------------------------------------------

    def losses(self, x, masked_event_index=None, training: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """(teacher loss, encoder-decoder loss, metrics) of a token batch
        (B, E, C) in train or eval mode, with their graphs: the teacher's
        cross entropy at the masked event, and the distilled cross entropy
        against the teacher's detached logits plus the weighted mean
        commitment loss. The two losses reach disjoint parameters. The
        masked event is `masked_event_index` or drawn from the device
        generator."""
        x = to_device(x, self.device)
        if masked_event_index is None:
            index = torch.randint(0, x.shape[1], (), generator=self.generator,
                                  device=self.device)
        else:
            index = torch.as_tensor(masked_event_index, device=self.device)
        masked_x, predict = mask_batch(
            x, index, self.num_events_masked,
            self.teacher.data_processor.num_tokens_per_channel)
        self.model.train(training)
        teacher_logits = self.teacher(self.teacher.data_processor(masked_x))
        loss_t = categorical_crossentropy(teacher_logits, x, predict)
        z, _, qloss = self.encoder(x, training=training, generator=self.generator)
        reconstruct = distilled_categorical_crossentropy(
            self.auxiliary_decoder(z), [t.detach() for t in teacher_logits],
            predict)
        loss_q = qloss.mean()
        loss_e = self.quantization_weighting * loss_q + reconstruct
        metrics = dict(zip(METRICS, (t.detach() for t in (
            loss_t, loss_q, reconstruct, loss_e, reconstruct))))
        return loss_t, loss_e, metrics

    def train_step(self, x, masked_event_index=None) -> Dict[str, torch.Tensor]:
        """One step of each optimizer on a token batch (B, E, C); the
        teacher's update does not reach the logits the encoder and the
        auxiliary decoder learn from. Returns the metrics as device tensors
        (not read back)."""
        if not self.initialized:
            raise RuntimeError("init_state before train_step")
        self.optimizer_teacher.zero_grad()
        self.optimizer_encdec.zero_grad()
        loss_t, loss_e, metrics = self.losses(x, masked_event_index)
        (loss_t + loss_e).backward()
        self.optimizer_teacher.step()
        self.optimizer_encdec.step()
        self.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, x, masked_event_index=None) -> Dict[str, torch.Tensor]:
        """The train step's losses in eval mode, no update."""
        return self.losses(x, masked_event_index, training=False)[2]

    def epoch(self, batches: Iterable, train: bool,
              num_batches: Optional[int] = None) -> Dict[str, float]:
        """Train or evaluate over up to num_batches batches (dicts whose 'x'
        holds a token batch); returns each metric's mean and tokens/s, with
        one read of the device at the end."""
        sums, count, tokens = None, 0, 0
        t0 = time.perf_counter()
        for batch in islice(batches, num_batches):
            x = batch["x"]
            metrics = self.train_step(x) if train else self.eval_step(x)
            stacked = torch.stack([metrics[k].float() for k in METRICS])
            sums = stacked if sums is None else sums + stacked
            count += 1
            tokens += int(np.prod(x.shape))
        if not count:
            return {}
        means = dict(zip(METRICS, (sums.double().cpu().numpy() / count).tolist()))
        means["tokens_per_sec"] = tokens / max(time.perf_counter() - t0, 1e-9)
        return means

    # ---- the epoch loop (training/loop.py) and its state --------------------

    def _init_from_first(self, first, lr, schedule_lr, initialize):
        self.init_state(first["x"], lr=lr, schedule_lr=schedule_lr,
                        warmup_steps=warmup_steps_from_env(),
                        initialize=initialize)

    def _checkpointed(self):
        """The three modules; the encoder's entries start with 'encoder.',
        as the decoder CLI reads them."""
        return self.model

    def _optimizers(self) -> Dict[str, Optional[Adam]]:
        return {"optimizer_teacher": self.optimizer_teacher,
                "optimizer_encdec": self.optimizer_encdec}

    def _generators(self) -> Dict[str, torch.Generator]:
        return {"generator": self.generator,
                "seed_generator": self.seed_generator}

    @torch.no_grad()
    def encode(self, x):
        """Token batch (B, E, C) -> (z_quantized, indices, q_loss) in eval
        mode."""
        self.encoder.eval()
        return self.encoder(to_device(x, self.device), training=False)
