"""The prior trainer and unconditional code generation (counterpart of
vqcpcb_tpu/training/prior_trainer.py): the training steps (:66-106), the
epoch (:139-167), the epoch loop and its checkpoints (training/loop.py) and
the generation surface (:184-243).

`PriorTrainer` trains a PriorRelative on the codes of a frozen encoder: one
step encodes the token batch (the nearest-codebook kernel on the card, no
grad), merges the codes, runs the prior in train mode in f32 (its transformer
layers in bf16 under VQCPCB_COMPUTE_DTYPE=bfloat16, as in JAX; the
relative-bias kernels on the card) and applies the clipped Adam of
training/optim.py without a schedule (optim.py:39 with
schedule_lr=False). It holds the prior, the optimizer, the step count and
two generators every random draw comes from: one on the device (the
prior's dropout layers and the sampler) and one on the host (the attention
layers' dropout seeds); `save` / `load` keep them with the rest. Generation
samples codes window by window (`generate_codes`) and decodes them with a
decoder trainer's `generate_from_code_long`, writing the scores. Runs on
the card unless the caller names another device.

Over a (data, model) mesh (`mesh`, by default make_mesh() over every rank,
prior_trainer.py:54-57) it trains as DecoderTrainer does
(training/decoder_trainer.py): the prior's blocks, this rank's rows through
the frozen encoder and the prior, gradients and losses averaged over
`data`, the dropout generator seeded per data rank. It generates over the
mesh on every rank as DecoderTrainer does: each rank samples its rows of a
batch that divides the data axis (the whole batch otherwise) with rank 0's
generator state, the rows gathered over `data` before the window glue;
rank 0 writes.
"""
from __future__ import annotations

import os
from datetime import datetime
from typing import Dict, List, Optional

import numpy as np
import torch

from vqcpcb_tpu_torch.models.encoder import Encoder, merge_codes
from vqcpcb_tpu_torch.models.prior import PriorRelative
from vqcpcb_tpu_torch.ops.transformer import wire_generators
from vqcpcb_tpu_torch.parallel.collectives import (common_generator,
                                                   gather_rows, mean_over_data)
from vqcpcb_tpu_torch.parallel.mesh import (generation_rows, make_mesh,
                                            module_specs, shard_batch,
                                            shard_params)
from vqcpcb_tpu_torch.training.loop import TrainLoopMixin
from vqcpcb_tpu_torch.training.optim import Adam
from vqcpcb_tpu_torch.training.profiling import check_finite
from vqcpcb_tpu_torch.utils import resolve_device, to_device


class PriorTrainer(TrainLoopMixin):
    """model_dir and dataloader_generator serve train_model, save / load and
    `generate`; the steps need neither. mesh: the (data, model) mesh to
    train over."""

    def __init__(self, encoder: Encoder, prior: PriorRelative,
                 codebook_size: int, device=None, seed: int = 0,
                 model_dir: Optional[str] = None, dataloader_generator=None,
                 mesh=None):
        self.model_dir = model_dir
        self.dataloader_generator = dataloader_generator
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.encoder = encoder.to(self.device).eval().requires_grad_(False)
        self.prior = shard_params(prior.to(self.device), self.mesh)
        self.codebook_size = codebook_size
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + self.mesh.data_index)
        self.seed_generator = torch.Generator().manual_seed(seed)
        wire_generators(self.prior, self.generator, self.seed_generator)
        self.optimizer: Optional[Adam] = None
        self.step = 0

    def init_state(self, lr: float) -> "PriorTrainer":
        """Fresh optimizer state at step 0, no schedule (prior_trainer.py:125;
        the prior's weights are the module's own)."""
        specs = module_specs(self.prior)
        named = list(self.prior.named_parameters())
        self.optimizer = Adam([p for _, p in named], lr, mesh=self.mesh,
                              specs=[specs.get(name) for name, _ in named])
        self.step = 0
        return self

    @torch.no_grad()
    def encode_codes(self, x) -> torch.Tensor:
        """Token batch (B, events, voices) -> merged codes (B, S) on the
        device, no grad."""
        _, indices, _ = self.encoder(to_device(x, self.device))
        return merge_codes(indices, self.codebook_size)

    def train_step(self, x) -> Dict[str, torch.Tensor]:
        """One clipped Adam step on a (global) token batch; returns {'loss'},
        the mean over `data`, as a device scalar (not read back)."""
        if self.optimizer is None:
            raise RuntimeError("init_state before train_step")
        codes = self.encode_codes(shard_batch(x, self.mesh))
        self.prior.train()
        self.optimizer.zero_grad()
        loss = self.prior(codes)["loss"]
        check_finite(loss)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return {"loss": mean_over_data(loss.detach(), self.mesh)}

    @torch.no_grad()
    def eval_step(self, x) -> Dict[str, torch.Tensor]:
        self.prior.eval()
        loss = self.prior(self.encode_codes(shard_batch(x, self.mesh)))["loss"]
        return {"loss": mean_over_data(loss, self.mesh)}

    # ---- the epoch loop (training/loop.py) and its state --------------------

    def _init_from_first(self, first, lr, schedule_lr, initialize):
        self.init_state(lr=lr)

    def _checkpointed(self):
        """The prior; the frozen encoder is the encoder's checkpoint."""
        return self.prior

    def _generators(self) -> Dict[str, torch.Generator]:
        return {"generator": self.generator,
                "seed_generator": self.seed_generator}

    # ---- generation (prior_trainer.py:184-243) -------------------------------

    def generate_codes(self, num_tokens: int, num_generated_codes: int = 1,
                       temperature: float = 1.0,
                       chunk: Optional[int] = None, top_k: int = 0) -> np.ndarray:
        """Sample (num_generated_codes, num_tokens) codes, KV-cached.

        The first model window's codes come from one sample_window call
        from position 0 (no prefill); beyond it the window slides in chunks: each chunk is one
        prefill over the last (model_tokens - chunk) codes and `chunk` decode
        steps, so each code sees between model_tokens - chunk and
        model_tokens - 1 earlier codes (the reference slides by one,
        prior_relative.py:327-353). `chunk` (default VQCPCB_PRIOR_CHUNK, else
        half the model window, as the JAX code does) is clipped to
        [1, model_tokens - 1]. The logits are multiplied by `temperature`
        (PriorRelative.sample_window; top_k, its filter, 0 as JAX's
        generate_codes samples, 1 greedy). Over the mesh each rank samples its
        rows (generation_rows) from rank 0's generator state; every rank
        returns the whole batch."""
        model_tokens = self.prior.num_tokens
        if num_tokens < model_tokens:
            raise ValueError(f"{num_tokens} codes is shorter than the prior's "
                             f"window of {model_tokens}")
        if chunk is None:
            chunk = int(os.environ.get("VQCPCB_PRIOR_CHUNK",
                                       str(max(1, model_tokens // 2))))
        chunk = max(1, min(chunk, model_tokens - 1))
        b = num_generated_codes
        x = np.zeros((b, num_tokens), dtype=np.int32)
        generator = common_generator(self.generator, self.mesh)
        rows = generation_rows(b, self.mesh)

        def sample(window, start, num_steps):
            out = self.prior.sample_window(
                rows.of(window), start, num_steps, generator,
                temperature=float(temperature), top_k=top_k,
                device=self.device, rows=rows)
            return gather_rows(out, rows, self.mesh).cpu().numpy().astype(np.int32)

        x[:, :model_tokens] = sample(x[:, :model_tokens], 0, model_tokens)
        pos = model_tokens
        while pos < num_tokens:
            n = min(chunk, num_tokens - pos)
            window = np.concatenate([x[:, pos - (model_tokens - n):pos],
                                     np.zeros((b, n), dtype=np.int32)], axis=1)
            x[:, pos:pos + n] = sample(window, model_tokens - n, n)[:, model_tokens - n:]
            pos += n
        return x

    def generate(self, num_tokens: int, decoder_trainer, temperature: float = 1.0,
                 num_generated_codes: int = 1,
                 num_decodings_per_generated_code: int = 1) -> List[np.ndarray]:
        """Sample codes, decode each num_decodings_per_generated_code times
        through `decoder_trainer` (a DecoderTrainer over the same encoder's
        codes) and write the scores under {model_dir}/generations
        (prior_trainer.py:229; rank 0 writes). Returns the token grids. Over
        a mesh both trainers run over it (the same ranks)."""
        codes = self.generate_codes(num_tokens,
                                    num_generated_codes=num_generated_codes,
                                    temperature=temperature)
        grids = decoder_trainer._generation().generate_from_code_long(
            codes, temperature=temperature,
            num_decodings=num_decodings_per_generated_code)
        if not self._writes:
            return grids
        timestamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        save_dir = os.path.join(self.model_dir, "generations")
        os.makedirs(save_dir, exist_ok=True)
        for k, grid in enumerate(grids):
            decoder_trainer.dataloader_generator.write(
                grid, os.path.join(save_dir, f"{timestamp}_{k}"))
        return grids
