"""The port's flagship AC/D/C decoder over the random VQ-CPC encoder, as
the benchmark drives it: the modules built as vqcpcb_tpu_torch/getters.py
builds them for configs/decoder_relative_AC_D_C_random.py, the weights the
benchmark made from the seed loaded into them; `Train` around
DecoderTrainer.train_step, `Generate` around DecoderGenerator.encode_codes
and DecoderGenerator.sample; each with the reference's side of its check."""
from __future__ import annotations

from typing import Dict, List

import torch

from portbench.harness import traffic as traffic_gen
from portbench.harness import weights
from portbench.reference import decoder as ref_decoder
from portbench.reference import encoder as ref_encoder
from portbench.reference.nets import Draws, Precision


def weight_spec(cfg: dict) -> weights.Spec:
    sizes = traffic_gen.vocab_sizes(cfg["vocabulary"])
    return ([(f"encoder.{n}", s, k, v) for n, s, k, v in
             ref_encoder.weight_spec(cfg["config_encoder"], sizes)]
            + [(f"decoder.{n}", s, k, v) for n, s, k, v in
               ref_decoder.weight_spec(cfg, sizes)])


def part(w: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in w.items() if k.startswith(prefix)}


def build_modules(cfg: dict, w: Dict[str, torch.Tensor], device):
    """The port's encoder and decoder holding the weights w."""
    from vqcpcb_tpu_torch.models.data_processor import (BachCPCDataProcessor,
                                                        BachDataProcessor)
    from vqcpcb_tpu_torch.models.decoder import Decoder
    from vqcpcb_tpu_torch.models.downscalers import GruDownscaler
    from vqcpcb_tpu_torch.models.encoder import Encoder
    from vqcpcb_tpu_torch.models.upscalers import MlpUpscaler
    from vqcpcb_tpu_torch.ops.quantizer import ProductVectorQuantizer
    enc = cfg["config_encoder"]
    sizes = traffic_gen.vocab_sizes(cfg["vocabulary"])
    with torch.device("meta"):
        encoder = Encoder(
            BachCPCDataProcessor(enc["embedding_size"], cfg["num_events"], sizes,
                                 num_tokens_per_block=enc["num_tokens_per_block"]),
            GruDownscaler(enc["embedding_size"], enc["codebook_dim"],
                          [enc["num_tokens_per_block"]], enc["hidden_size"],
                          num_layers=enc["downscaler_layers"],
                          dropout=enc["dropout"], bidirectional=enc["bidirectional"]),
            ProductVectorQuantizer(enc["codebook_size"], enc["codebook_dim"],
                                   enc["commitment_cost"], enc["num_codebooks"]),
            MlpUpscaler(enc["codebook_dim"], enc["upscaler_output_dim"],
                        enc["upscaler_hidden_size"], enc["dropout"]))
        voices = cfg["num_voices"]
        decoder = Decoder(
            BachDataProcessor(cfg["embedding_size"], cfg["num_events"], sizes),
            "anticausal", d_model=cfg["d_model"],
            num_encoder_layers=cfg["num_encoder_layers"],
            num_decoder_layers=cfg["num_decoder_layers"], n_head=cfg["n_head"],
            dim_feedforward=cfg["dim_feedforward"],
            positional_embedding_size=cfg["positional_embedding_size"],
            num_channels_encoder=1, num_events_encoder=cfg["sequences_size"],
            num_channels_decoder=voices, num_events_decoder=cfg["num_events"],
            total_upscaling=cfg["total_upscaling"],
            source_vocab_size=enc["codebook_size"] ** enc["num_codebooks"],
            dropout=cfg["dropout"], transformer_type="relative",
            cross_attention_type="diagonal")
    encoder = encoder.to_empty(device=device)
    decoder = decoder.to_empty(device=device)
    encoder.load_state_dict(part(w, "encoder."), strict=True)
    decoder.load_state_dict(part(w, "decoder."), strict=True)
    return encoder, decoder


def _codes(cfg, w, x, prec=Precision("f32")):
    """The reference encoder's codes of token grids x (B, events, voices)."""
    with torch.no_grad():
        z = ref_encoder.latents(part(w, "encoder."), x, cfg["config_encoder"], prec)
        return torch.argmin(ref_encoder.distances(z, w["encoder.quantizer.embeddings.0"]), -1)


class Train:
    """DecoderTrainer at the configuration's batch, dropout and lr."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from vqcpcb_tpu_torch.training.decoder_trainer import DecoderTrainer
        self.cfg, self.device = cfg, torch.device(device)
        self.weights = weights.make(weight_spec(cfg), seed, self.device)
        encoder, decoder = build_modules(cfg, self.weights, self.device)
        self.program_seed = weights.stream_seed(seed, weights.PROGRAM)
        self.trainer = DecoderTrainer(encoder, decoder, cfg["config_encoder"]["codebook_size"],
                                      device=self.device, seed=self.program_seed)
        self.trainer.init_state(lr=cfg["lr"], schedule_lr=cfg["schedule_lr"],
                                warmup_steps=cfg["warmup_steps"])
        self.pool = traffic_gen.pool(traffic, cfg["vocabulary"], seed, self.device)
        x = self.pool[0]["x"]
        self.tokens_per_step = int(x.numel())
        self.names = [n for n, p in self.trainer.decoder.named_parameters()
                      if p.requires_grad]

    def step(self, batch) -> torch.Tensor:
        return self.trainer.train_step(batch["x"])["loss"]

    def parameters(self) -> Dict[str, torch.Tensor]:
        return dict(self.trainer.decoder.named_parameters())

    def adam_first_moments(self) -> List[torch.Tensor]:
        return self.trainer.optimizer.mu

    def initial(self) -> Dict[str, torch.Tensor]:
        return part(self.weights, "decoder.")

    def close(self) -> None:
        del self.trainer

    def reference_loss(self, prec: Precision = Precision("f32")):
        """loss_fn(params, batch) for compare.follow: the reference decoder's
        loss with the program's dropout draws replayed, over the reference
        encoder's codes of the batch (the encoder is frozen)."""
        draws = Draws(self.program_seed, self.device)
        dt = torch.bfloat16 if self.device.type == "cuda" else torch.float32

        def loss_fn(params, batch):
            codes = _codes(self.cfg, self.weights, batch["x"])
            return ref_decoder.loss(params, codes, batch["x"], self.cfg, prec, draws, dt)
        return loss_fn


class Generate:
    """DecoderGenerator over the whole target: encode the templates, sample
    every position, int8 caches (the card's default)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from vqcpcb_tpu_torch.data.vocab import Vocabulary
        from vqcpcb_tpu_torch.training.decoder_trainer import DecoderGenerator
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        self.weights = weights.make(weight_spec(cfg), seed, self.device)
        encoder, decoder = build_modules(cfg, self.weights, self.device)
        names = traffic_gen.vocabulary_names(cfg["vocabulary"])
        vocabulary = Vocabulary([{n: i for i, n in enumerate(v)} for v in names],
                                [tuple(r) for r in cfg["vocabulary"]["voice_ranges"]])
        self.program_seed = weights.stream_seed(seed, weights.PROGRAM)
        self.generator = DecoderGenerator(encoder, decoder, vocabulary,
                                          cfg["config_encoder"]["codebook_size"],
                                          device=self.device, seed=self.program_seed)
        self.pool = [p["templates"] for p in
                     traffic_gen.pool(traffic, cfg["vocabulary"], seed, self.device)]
        self.tile = int(traffic["tile"])
        self.rows = self.pool[0].shape[0] * self.tile
        self.positions = cfg["num_events"] * cfg["num_voices"]
        self.zeros = torch.zeros((self.rows, cfg["num_events"], cfg["num_voices"]),
                                 dtype=torch.int32, device=self.device)
        self.forbidden = self.generator._forbidden(traffic["exclude_meta_symbols"])

    def templates(self, i: int) -> torch.Tensor:
        return self.pool[i % len(self.pool)].repeat(self.tile, 1, 1)

    def call(self, i: int, greedy: bool, positions: int = 0):
        """One whole call on template set i; (codes, tokens) on the host."""
        x = self.templates(i)
        codes = self.generator.encode_codes(x)
        if greedy:
            kw = dict(temperature=1.0, top_k=1, top_p=0.0)
        else:
            kw = dict(temperature=self.traffic["temperature"],
                      top_p=self.traffic["top_p"])
        tokens = self.generator.sample(codes, self.zeros, 0,
                                       positions or self.positions,
                                       forbidden_indices=self.forbidden, **kw)
        return codes.cpu(), torch.as_tensor(tokens)

    def close(self) -> None:
        del self.generator

    # ---- the reference's side ----------------------------------------------

    def reference_distances(self, templates: torch.Tensor,
                            prec: Precision = Precision("f32")):
        """The reference's distances of the templates' latents to the
        codewords (N, S) and, for a control's precision, its own codes (N,)
        at that precision (else None)."""
        w = self.weights
        with torch.no_grad():
            z = ref_encoder.latents(part(w, "encoder."), templates,
                                    self.cfg["config_encoder"], Precision("f32"))
            dist = ref_encoder.distances(z, w["encoder.quantizer.embeddings.0"])
            own = _codes(self.cfg, w, templates, prec) if prec.kind != "f32" else None
        return dist.reshape(-1, dist.shape[-1]), own

    def reference_logits(self, codes, tokens, prec: Precision = Precision("f32"),
                         kv_round=None):
        with torch.no_grad():
            return ref_decoder.logits(part(self.weights, "decoder."),
                                      codes.to(self.device), tokens.to(self.device),
                                      self.cfg, prec, kv_round=kv_round)

    def forbidden_reference(self) -> List[List[int]]:
        return traffic_gen.forbidden(self.cfg["vocabulary"])
