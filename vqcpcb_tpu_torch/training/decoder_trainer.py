"""The decoder trainer (counterpart of vqcpcb_tpu/training/decoder_trainer.py):
its training steps (:120-160, 204-230), its epoch loop and checkpoints
(training/loop.py) and its generation surface (:55-65, 250-549).

`DecoderTrainer` trains a decoder on the codes of a frozen encoder: one step
encodes the batch (the nearest-codebook kernel on the card), runs the
decoder in train mode in the compute dtype (bf16 transformer layers on CUDA,
f32 on the CPU, unless VQCPCB_COMPUTE_DTYPE says otherwise:
utils.compute_dtype, utils.default_compute_dtype),
and applies the clipped Adam of training/optim.py (under a profiler the
spans vqcpcb.train_step over vqcpcb.encode, .forward, .backward and
.optimizer, training/profiling.py). It holds the
model, the optimizer and the step count, the counterpart of the JAX
TrainState, and two generators every random draw comes from: one on the
device (the decoder's dropout layers and sampling) and one on the host (the
attention layers' dropout seeds); `save` / `load` keep them with the rest.
Its generation methods write scores (`generate`, `generate_reharmonisation`
from scores, `generate_alla_mano`) through a `DecoderGenerator` over its
modules; `dump_attention_maps` writes one teacher-forced forward's
attention heatmaps. `DecoderGenerator` holds a frozen encoder and a decoder on one
device and an explicit torch.Generator for the draws: frozen-encoder codes
for a template, then sliding-window KV-cached decoding of the code
sequence. Both run on the card unless the caller names another device.
Over an encoder without a quantizer, the decoder's source is the encoder's
z in place of merged codes, on every path that takes it (`encode_source`).

Over a (data, model) mesh (`mesh`, by default parallel/mesh.make_mesh()
over every rank, as JAX's trainer builds one over every device,
decoder_trainer.py:87-90) the decoder keeps its blocks (shard_params), each
step takes this rank's rows of the global batch (shard_batch) through the
frozen encoder (K1 on those rows) and the decoder, Adam averages the
gradients over `data`, and the losses are averaged over `data`. The
dropout layers' generator is seeded with seed + data_index (a distinct
stream per data rank, the same for the ranks of one data index, whose
activations are replicated); the attention's seed generator with seed on
every rank (the K7 wrappers offset it per shard). A one-rank mesh is the
single-device path.

Generation runs over the same mesh on every rank (JAX's sampler over its
mesh, tests/test_multichip.py:391): a batch that divides the data axis is
split over it (parallel/mesh.generation_rows), each rank encoding its rows
(K1 on them) and sampling them with the draws of the global batch from a
generator common to every rank (parallel/collectives.common_generator:
rank 0's state), the decoder on its heads and blocks; a batch that does
not divide runs whole on every data rank. The rows are gathered over
`data` before the host-side window glue, which every rank repeats; rank 0
writes the scores.
"""
from __future__ import annotations

import os
from datetime import datetime
from typing import Dict, List, Optional

import numpy as np
import torch

from vqcpcb_tpu_torch.data.vocab import (END_SYMBOL, PAD_SYMBOL, START_SYMBOL,
                                         Vocabulary)
from vqcpcb_tpu_torch.models.decoder import Decoder
from vqcpcb_tpu_torch.models.encoder import Encoder, merge_codes
from vqcpcb_tpu_torch.ops.transformer import train_mode, wire_generators
from vqcpcb_tpu_torch.parallel.collectives import (common_generator,
                                                   gather_rows, mean_over_data)
from vqcpcb_tpu_torch.parallel.mesh import (Mesh, generation_rows, make_mesh,
                                            module_specs, shard_batch,
                                            shard_params)
from vqcpcb_tpu_torch.training.loop import TrainLoopMixin
from vqcpcb_tpu_torch.training.optim import (WARMUP_STEPS, Adam,
                                             trapezoid_schedule,
                                             warmup_steps_from_env)
from vqcpcb_tpu_torch.training.profiling import check_finite, count, span
from vqcpcb_tpu_torch.utils import (compute_dtype, default_compute_dtype,
                                    resolve_device, to_device)


def encode_source(encoder: Encoder, x: torch.Tensor,
                  codebook_size: int) -> torch.Tensor:
    """The decoder's source for a token batch: the frozen encoder's merged
    codes (B, S), or its z (B, S, dim) when it has no quantizer
    (decoder_trainer.py:110-116)."""
    z, indices, _ = encoder(x)
    return z if indices is None else merge_codes(indices, codebook_size)


def compute_start_end_times(t: int, num_blocks: int, num_blocks_model: int):
    """Sliding-window bookkeeping: (t_begin, t_end, t_relative) of the model
    window that decodes code t (decoder_trainer.py:55)."""
    if num_blocks_model // 2 <= t < num_blocks - num_blocks_model // 2:
        t_relative = num_blocks_model // 2
    elif t < num_blocks_model // 2:
        t_relative = t
    else:
        t_relative = num_blocks_model - (num_blocks - t)
    t_begin = min(max(0, t - num_blocks_model // 2), num_blocks - num_blocks_model)
    return t_begin, t_begin + num_blocks_model, t_relative


class DecoderTrainer(TrainLoopMixin):
    """Decoder training on frozen-encoder codes, and generation that writes
    scores.

    seed: seeds the device generator the decoder's dropout layers and the
    sampler draw from, and the host generator the attention layers draw
    their dropout seeds from. model_dir and dataloader_generator serve
    train_model, save / load and the generation methods; the steps need
    neither. mesh: the (data, model) mesh to train over (see the module
    docstring)."""

    def __init__(self, encoder: Encoder, decoder: Decoder, codebook_size: int,
                 device=None, seed: int = 0, model_dir: Optional[str] = None,
                 dataloader_generator=None, mesh=None):
        self.model_dir = model_dir
        self.dataloader_generator = dataloader_generator
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.encoder = encoder.to(self.device).eval().requires_grad_(False)
        self.decoder = shard_params(decoder.to(self.device), self.mesh)
        self.codebook_size = codebook_size
        self.compute_dtype = compute_dtype(
            torch.bfloat16 if self.device.type == "cuda" else torch.float32)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + self.mesh.data_index)
        self.seed_generator = torch.Generator().manual_seed(seed)
        wire_generators(self.decoder, self.generator, self.seed_generator)
        self.optimizer: Optional[Adam] = None
        self.step = 0

    def init_state(self, lr: float, schedule_lr: bool = False,
                   warmup_steps: int = WARMUP_STEPS) -> "DecoderTrainer":
        """Fresh optimizer state at step 0 (decoder_trainer.py:init_state;
        the decoder's weights are the module's own)."""
        specs = module_specs(self.decoder)
        named = list(self.decoder.named_parameters())
        self.optimizer = Adam(
            [p for _, p in named],
            trapezoid_schedule(lr, warmup_steps) if schedule_lr else lr,
            mesh=self.mesh, specs=[specs.get(name) for name, _ in named])
        self.step = 0
        return self

    @torch.no_grad()
    def encode_codes(self, x: torch.Tensor) -> torch.Tensor:
        """Token batch (B, events, voices) -> merged codes (B, S), or z
        (B, S, dim) over an unquantized encoder; no grad."""
        return encode_source(self.encoder, x, self.codebook_size)

    def _loss(self, x: torch.Tensor) -> torch.Tensor:
        """The step's loss in the trainer's compute dtype, the frozen
        encoder's codes included, as JAX traces both inside its scope
        (decoder_trainer.py:233-242)."""
        with default_compute_dtype(self.compute_dtype):
            with span("vqcpcb.encode"):
                codes = self.encode_codes(x)
            with span("vqcpcb.forward"):
                return self.decoder(codes, x)["loss"]

    def train_step(self, x) -> Dict[str, torch.Tensor]:
        """One clipped Adam step on a (global) token batch; returns {'loss'},
        the mean over `data`, as a device scalar (not read back)."""
        if self.optimizer is None:
            raise RuntimeError("init_state before train_step")
        with span("vqcpcb.train_step"):
            count("steps")
            x = to_device(shard_batch(x, self.mesh), self.device)
            self.decoder.train()
            self.optimizer.zero_grad()
            loss = self._loss(x)
            check_finite(loss)
            with span("vqcpcb.backward"):
                loss.backward()
            self.optimizer.step()
            self.step += 1
            return {"loss": mean_over_data(loss.detach(), self.mesh)}

    @torch.no_grad()
    def eval_step(self, x) -> Dict[str, torch.Tensor]:
        self.decoder.eval()
        loss = self._loss(to_device(shard_batch(x, self.mesh), self.device))
        return {"loss": mean_over_data(loss, self.mesh)}

    # ---- the epoch loop (training/loop.py) and its state --------------------

    def _init_from_first(self, first, lr, schedule_lr, initialize):
        self.init_state(lr=lr, schedule_lr=schedule_lr,
                        warmup_steps=warmup_steps_from_env())

    def _checkpointed(self):
        """The decoder; the frozen encoder is the encoder's checkpoint."""
        return self.decoder

    def _generators(self) -> Dict[str, torch.Generator]:
        return {"generator": self.generator,
                "seed_generator": self.seed_generator}

    # ---- generation that writes scores (decoder_trainer.py:281-549) ---------

    @property
    def _vocab(self):
        return self.dataloader_generator.dataset.vocabulary

    def _generation(self) -> "DecoderGenerator":
        """A DecoderGenerator over this trainer's modules and mesh (which
        puts the decoder in eval mode), drawing from the trainer's device
        generator (rank 0's, on every rank)."""
        sampler = DecoderGenerator(self.encoder, self.decoder, self._vocab,
                                   self.codebook_size, device=self.device,
                                   mesh=self.mesh)
        sampler.generator = common_generator(self.generator, self.mesh)
        return sampler

    def generate(self, temperature: float, batch_size: int = 1, top_k: int = 0,
                 top_p: float = 1.0, seed_set: str = "val",
                 exclude_meta_symbols: bool = False,
                 code_juxtaposition: bool = False) -> List[str]:
        """Seed-excerpt generation (decoder_trainer.py:281): the codes of one
        excerpt of `seed_set` (with code_juxtaposition, the first half of
        one and the second half of another), every position sampled
        `batch_size` times; writes the originals and the samples under
        generations/ (or juxtapositions/) and returns the written paths
        (rank 0; the other ranks of a mesh sample with it and return [])."""
        sampler = self._generation()
        generator_train, generator_val, _ = \
            self.dataloader_generator.dataloaders(batch_size=1, shuffle_val=True)
        pick = {"train": generator_train, "val": generator_val}[seed_set]
        if code_juxtaposition:
            a = next(iter(pick))["x"]
            b = next(iter(pick))["x"]
            half = a.shape[1] // 2
            x_original_single = np.concatenate([a[:, :half], b[:, half:]], axis=1)
        else:
            x_original_single = next(iter(pick))["x"]
        x_original = np.tile(x_original_single, (batch_size, 1, 1))
        codes = sampler.encode_codes(x_original)
        sampled = sampler.sample(
            codes, np.zeros_like(x_original), 0,
            self.decoder.data_processor.num_tokens,
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p),
            forbidden_indices=sampler._forbidden(exclude_meta_symbols))
        if not self._writes:
            return []

        timestamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        save_dir = os.path.join(
            self.model_dir,
            "juxtapositions" if code_juxtaposition else "generations")
        os.makedirs(save_dir, exist_ok=True)
        scores = [self.dataloader_generator.write(
                      grid, os.path.join(save_dir, f"{timestamp}_{k}"))
                  for k, grid in enumerate(np.concatenate([x_original, sampled]))]
        print(f"Saved in {save_dir}/{timestamp}")
        return scores

    def generate_reharmonisation(self, num_reharmonisations: int,
                                 temperature: float, top_k: int = 0,
                                 top_p: float = 1.0, scores=None,
                                 write_dir: Optional[str] = None
                                 ) -> List[np.ndarray]:
        """Re-harmonise whole scores (decoder_trainer.py:407-471): each score
        (a NeutralScore; default: the corpus's first) is tokenized and
        re-harmonised `num_reharmonisations` times by
        DecoderGenerator.generate_reharmonisation; variant k of score i is
        written as score{i}_{k} under write_dir (default
        {model_dir}/reharmonisations; rank 0 writes). Returns the grids."""
        from vqcpcb_tpu_torch.data.tokenizer import score_to_ticks
        sampler = self._generation()
        dataset = self.dataloader_generator.dataset
        if scores is None:
            scores = [next(iter(dataset.corpus))]
        write_dir = write_dir or os.path.join(self.model_dir, "reharmonisations")
        if self._writes:
            os.makedirs(write_dir, exist_ok=True)
        all_outputs = []
        for score_id, score in enumerate(scores):
            ticks = score_to_ticks(score, dataset.vocabulary, dataset.subdivision)
            outs = sampler.generate_reharmonisation(
                ticks.T[None], num_reharmonisations, temperature=temperature,
                top_k=top_k, top_p=top_p)
            if self._writes:
                for k, grid in enumerate(outs):
                    self.dataloader_generator.write(
                        grid, os.path.join(write_dir, f"score{score_id}_{k}"))
            all_outputs.extend(outs)
        return all_outputs

    def generate_alla_mano(self, start_codes, end_codes, body_codes,
                           temperature: float, num_decodings: int = 3
                           ) -> List[np.ndarray]:
        """Decode hand-written codes (decoder_trainer.py:473): the body
        between start and end codes, written under alla_mano/ (rank 0)."""
        code_index_start = len(start_codes)
        codes = list(start_codes) + list(body_codes)
        code_index_end = len(codes)
        codes = np.asarray(codes + list(end_codes), dtype=np.int32)[None]
        outs = self._generation().generate_from_code_long(
            codes, temperature=temperature, num_decodings=num_decodings,
            code_index_start=code_index_start, code_index_end=code_index_end)
        if not self._writes:
            return outs
        save_dir = os.path.join(self.model_dir, "alla_mano")
        os.makedirs(save_dir, exist_ok=True)
        for k, grid in enumerate(outs):
            self.dataloader_generator.write(grid, os.path.join(save_dir, str(k)))
        return outs

    # ---- attention-map dumps (decoder_trainer.py:492-512) -------------------

    @torch.no_grad()
    def dump_attention_maps(self, x, out_dir: Optional[str] = None) -> List[str]:
        """One teacher-forced eval forward of the token batch x (B, events,
        voices) on its frozen-encoder codes, collecting every decoder
        layer's weights, and one heatmap PDF of batch item 0 per layer and
        kind, {out_dir}/layer{i}_{a_self_decoder|a_cross}.pdf (out_dir
        defaults to {model_dir}/attention_maps); weights that are None are
        skipped. Returns the written paths. The collecting forward takes the
        plain attention on the card too (the kernels keep no weights), so
        the maps are written there, where JAX's dump on the TPU writes none
        (its kernels return None, decoder_trainer.py:505). Runs in the
        default compute dtype (f32 unless VQCPCB_COMPUTE_DTYPE says
        otherwise), outside the steps' scope, as JAX's. Needs matplotlib and
        seaborn once there is a map to write (training/analysis.py)."""
        from vqcpcb_tpu_torch.training import analysis

        out_dir = out_dir or os.path.join(self.model_dir, "attention_maps")
        x = to_device(x, self.device)
        codes = self.encode_codes(x)
        with train_mode(self.decoder, False):
            out = self.decoder(codes, x, collect_attentions=True)
        written = []
        for layer_idx, att in enumerate(out["attentions_decoder"]):
            for name in ("a_self_decoder", "a_cross"):
                if att.get(name) is None:
                    continue
                path = os.path.join(out_dir, f"layer{layer_idx}_{name}.pdf")
                written.append(analysis.plot_attention(
                    att[name].float().cpu().numpy(), path))
        return written

    # ---- plagiarism check (decoder_trainer.py:515-549) ----------------------

    def _token_width(self) -> int:
        """Chars per token id in the dump: fixed width, so the
        longest-common-substring arithmetic holds for vocabularies of 100
        tokens or more."""
        vmax = max(self.decoder.data_processor.num_tokens_per_channel)
        return max(2, len(str(vmax - 1)))

    def _dump(self, x) -> str:
        w = self._token_width()
        return "_".join(str(int(c)).zfill(w) for c in np.asarray(x).reshape(-1))

    def check_duplicate(self, generation, original) -> float:
        """Tokens in the longest run `generation` shares with `original`."""
        from difflib import SequenceMatcher
        s1, s2 = self._dump(generation), self._dump(original)
        match = SequenceMatcher(None, s1, s2).find_longest_match(
            0, len(s1), 0, len(s2))
        return (match.size - 1) / (self._token_width() + 1)

    def check_duplicate_all_corpus(self, generation):
        """The training excerpt sharing the longest run with `generation`;
        prints that run's length in tokens."""
        from difflib import SequenceMatcher
        s1 = self._dump(generation)
        generator_train, _, _ = self.dataloader_generator.dataloaders(
            batch_size=1, shuffle_train=False)
        best_x, best_size = None, 0
        for tensor_dict in generator_train:
            s2 = self._dump(tensor_dict["x"][0])
            match = SequenceMatcher(None, s1, s2, autojunk=False) \
                .find_longest_match(0, len(s1), 0, len(s2))
            if match.size > best_size:
                best_x, best_size = tensor_dict["x"], match.size
        print("Num tokens plagiarisms: "
              f"{(best_size - 1) / (self._token_width() + 1)}")
        return best_x


class DecoderGenerator:
    """mesh: the mesh the decoder was sharded with (default: the decoder's,
    else one rank); every rank of it makes the same calls, each encoding
    and sampling its rows of every batch (generation_rows) and holding the
    whole batch after them."""

    def __init__(self, encoder: Encoder, decoder: Decoder,
                 vocabulary: Vocabulary, codebook_size: int, device=None,
                 seed: int = 0, mesh=None):
        self.device = resolve_device(device)
        self.encoder = encoder.to(self.device).eval()
        self.decoder = decoder.to(self.device).eval()
        self.vocabulary = vocabulary
        self.codebook_size = codebook_size
        self.mesh = mesh or decoder.mesh or Mesh(1, 1)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @torch.no_grad()
    def encode_codes(self, x) -> torch.Tensor:
        """Token grid (B, ticks, voices) -> merged codes (B, S), or z (B, S,
        dim) over an unquantized encoder, on the device
        (decoder_trainer.py:109): each rank encodes its rows, gathered
        over `data` after."""
        with span("vqcpcb.encode"):
            rows = generation_rows(len(x), self.mesh)
            codes = encode_source(self.encoder, to_device(rows.of(x), self.device),
                                  self.codebook_size)
            return gather_rows(codes, rows, self.mesh)

    def sample(self, source, tokens_init, start: int, num_steps: int,
               **kwargs) -> np.ndarray:
        """Decoder.sample_range over the mesh from the generator: this
        rank's rows of the batch, the whole batch (B, E, C) gathered back
        to the host."""
        rows = generation_rows(len(tokens_init), self.mesh)
        out = self.decoder.sample_range(
            rows.of(source), rows.of(tokens_init), start, num_steps,
            self.generator, device=self.device, rows=rows, **kwargs)
        return gather_rows(out, rows, self.mesh).cpu().numpy()

    def _meta_chunks(self, num_events: int):
        """START/PAD, END/PAD and PAD framing chunks (decoder_trainer.py:250)."""
        vocab = self.vocabulary
        pad = np.array(vocab.symbol_indices(PAD_SYMBOL))
        start = np.array(vocab.symbol_indices(START_SYMBOL))
        end = np.array(vocab.symbol_indices(END_SYMBOL))
        start_chunk = np.tile(pad[None], (num_events, 1))
        start_chunk[-1] = start
        end_pad_chunk = np.tile(pad[None], (num_events, 1))
        end_pad_chunk[0] = end
        pad_chunk = np.tile(pad[None], (num_events, 1))
        return start_chunk, end_pad_chunk, pad_chunk

    def init_generation_chorale(self, num_events: int, start_index: int,
                                batch_size: int) -> np.ndarray:
        """PAD everywhere, START at event start_index - 1."""
        vocab = self.vocabulary
        x = np.tile(np.array(vocab.symbol_indices(PAD_SYMBOL))[None],
                    (num_events, 1))
        x[start_index - 1] = np.array(vocab.symbol_indices(START_SYMBOL))
        return np.tile(x[None], (batch_size, 1, 1)).astype(np.int32)

    def _forbidden(self, exclude_meta_symbols: bool) -> Optional[np.ndarray]:
        """(C, 3) ids of START, END and PAD per channel, or None."""
        if not exclude_meta_symbols:
            return None
        return np.stack([
            np.array([d[s] for s in (START_SYMBOL, END_SYMBOL, PAD_SYMBOL)])
            for d in self.vocabulary.note2index_dicts], axis=0)

    def generate_from_code_long(self, encoding_indices, temperature: float,
                                top_k: int = 0, top_p: float = 1.0,
                                num_decodings: int = 1,
                                code_index_start: Optional[int] = None,
                                code_index_end: Optional[int] = None,
                                exclude_meta_symbols: bool = False,
                                codes_per_window: Optional[int] = None
                                ) -> List[np.ndarray]:
        """Sliding-window decoding of a long code sequence (1 or more rows,
        (B, n_codes), or z (B, n_codes, dim) over an unquantized encoder);
        one sample_range call -- one prefill -- per window,
        batched over decodings. codes_per_window codes are decoded per window
        before it slides (1 is the reference's placement,
        decoder_trainer.py:322); None reads VQCPCB_CODES_PER_WINDOW (default
        1), as JAX does (:365-368). Returns the token grids of codes
        [code_index_start, code_index_end), one per row and decoding."""
        encoding_indices = np.asarray(encoding_indices)
        size_encoding = encoding_indices.shape[1]
        dec = self.decoder
        total_upscaling = dec.total_upscaling
        num_channels = dec.num_channels_decoder
        num_tokens_indices = dec.data_processor.num_tokens // total_upscaling
        events_per_code = total_upscaling // num_channels
        if size_encoding < num_tokens_indices:
            raise ValueError(
                f"code sequence of length {size_encoding} is shorter than "
                f"the model window ({num_tokens_indices} codes); pad the "
                "sequence to at least one window")
        code_index_start = 0 if code_index_start is None else code_index_start
        code_index_end = size_encoding if code_index_end is None else code_index_end
        if codes_per_window is None:
            codes_per_window = int(os.environ.get("VQCPCB_CODES_PER_WINDOW", "1"))
        codes_per_window = max(1, codes_per_window)

        num_events_full = size_encoding * events_per_code
        events_before_start = code_index_start * events_per_code
        events_before_end = code_index_end * events_per_code
        batch_size = num_decodings * encoding_indices.shape[0]
        chorale = self.init_generation_chorale(num_events_full,
                                               events_before_start, batch_size)
        codes_rep = np.repeat(encoding_indices, num_decodings, axis=0)
        forbidden = self._forbidden(exclude_meta_symbols)

        code_index = code_index_start
        while code_index < code_index_end:
            t_begin, t_end, t_relative = compute_start_end_times(
                code_index, num_blocks=size_encoding,
                num_blocks_model=num_tokens_indices)
            chunk = min(codes_per_window, code_index_end - code_index,
                        num_tokens_indices - t_relative)
            ev0, ev1 = t_begin * events_per_code, t_end * events_per_code
            sampled = self.sample(
                codes_rep[:, t_begin:t_end], chorale[:, ev0:ev1],
                t_relative * total_upscaling, chunk * total_upscaling,
                temperature=temperature, top_k=top_k, top_p=top_p,
                forbidden_indices=forbidden)
            rel0 = t_relative * events_per_code
            abs0 = code_index * events_per_code
            n_ev = chunk * events_per_code
            chorale[:, abs0:abs0 + n_ev] = sampled[:, rel0:rel0 + n_ev]
            code_index += chunk
        return list(chorale[:, events_before_start:events_before_end])

    def generate_reharmonisation(self, ticks, num_reharmonisations: int,
                                 temperature: float, top_k: int = 0,
                                 top_p: float = 1.0,
                                 exclude_meta_symbols: bool = False,
                                 codes_per_window: Optional[int] = None
                                 ) -> List[np.ndarray]:
        """Re-harmonise one template given as a tick grid (1, events, voices)
        (decoder_trainer.py:407, which reads it from a score): frame it with
        START/END/PAD chunks, encode, decode `num_reharmonisations` variants.
        Returns one (events, voices) grid per variant. The encoded chunks
        are glued with reshape(1, -1), as JAX glues them (:454): over an
        unquantized encoder that flattens z's feature axis, and the first
        window's decoding raises, as JAX's does (Decoder.embed_source)."""
        x = np.asarray(ticks)
        num_events = self.decoder.data_processor.num_events
        vocab = self.vocabulary
        chunks = [x[:, i:i + num_events] for i in range(0, x.shape[1], num_events)]
        start_chunk, end_pad_chunk, pad_chunk = self._meta_chunks(num_events)

        last = chunks[-1]
        completion = num_events - last.shape[1]
        end_symbols = np.array(vocab.symbol_indices(END_SYMBOL))[None, None]
        if completion > 1:
            filler = np.tile(np.array(vocab.symbol_indices(PAD_SYMBOL))[None, None],
                             (1, completion - 1, 1))
            chunks[-1] = np.concatenate([last, end_symbols, filler], axis=1)
            end_chunk = pad_chunk[None]
        elif completion == 1:
            chunks[-1] = np.concatenate([last, end_symbols], axis=1)
            end_chunk = pad_chunk[None]
        else:
            end_chunk = end_pad_chunk[None]
        x_chunks = np.concatenate([start_chunk[None]] + chunks + [end_chunk],
                                  axis=0).astype(np.int32)

        glued = self.encode_codes(x_chunks).cpu().numpy().reshape(1, -1)
        channels = self.decoder.num_channels_decoder
        total_upscaling = self.decoder.total_upscaling
        code_index_start = num_events * channels // total_upscaling
        code_index_end = glued.shape[1] - (
            (num_events + completion) * channels // total_upscaling)
        return self.generate_from_code_long(
            glued, temperature=temperature, top_k=top_k, top_p=top_p,
            num_decodings=num_reharmonisations,
            code_index_start=code_index_start, code_index_end=code_index_end,
            exclude_meta_symbols=exclude_meta_symbols,
            codes_per_window=codes_per_window)
