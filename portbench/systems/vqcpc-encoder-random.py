"""The port's VQ-CPC encoder of configs/encoder_random_config.py as the
benchmark drives it: VQCPCModel built as vqcpcb_tpu_torch/getters.py builds
it, the weights the benchmark made from the seed (the codebook included, so
no data-dependent init), `Train` around VQCPCEncoderTrainer.train_step,
with the reference's side of its check."""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from portbench.harness import traffic as traffic_gen
from portbench.harness import weights
from portbench.reference import encoder as ref_encoder
from portbench.reference.nets import Draws, Precision


def weight_spec(cfg: dict) -> weights.Spec:
    return ref_encoder.cpc_weight_spec(cfg, traffic_gen.vocab_sizes(cfg["vocabulary"]))


def build_model(cfg: dict, w: Dict[str, torch.Tensor], device):
    from vqcpcb_tpu_torch.models.cpc import CModule, FksModule, VQCPCModel
    from vqcpcb_tpu_torch.models.data_processor import BachCPCDataProcessor
    from vqcpcb_tpu_torch.models.downscalers import GruDownscaler
    from vqcpcb_tpu_torch.models.encoder import Encoder
    from vqcpcb_tpu_torch.models.upscalers import MlpUpscaler
    from vqcpcb_tpu_torch.ops.quantizer import ProductVectorQuantizer
    block = cfg["num_tokens_per_block"]
    voices = len(cfg["vocabulary"]["voice_ranges"])
    ticks = (cfg["num_blocks_left"] + cfg["num_blocks_right"]) * block // voices
    z = cfg["upscaler_output_dim"]
    with torch.device("meta"):
        encoder = Encoder(
            BachCPCDataProcessor(cfg["embedding_size"], ticks,
                                 traffic_gen.vocab_sizes(cfg["vocabulary"]),
                                 num_tokens_per_block=block),
            GruDownscaler(cfg["embedding_size"], cfg["codebook_dim"], [block],
                          cfg["hidden_size"], num_layers=cfg["downscaler_layers"],
                          dropout=cfg["dropout"], bidirectional=cfg["bidirectional"]),
            ProductVectorQuantizer(cfg["codebook_size"], cfg["codebook_dim"],
                                   cfg["commitment_cost"], cfg["num_codebooks"],
                                   use_batch_norm=cfg["use_batch_norm"]),
            MlpUpscaler(cfg["codebook_dim"], z, cfg["upscaler_hidden_size"],
                        cfg["dropout"]))
        model = VQCPCModel(
            encoder, CModule(z, cfg["context_hidden_size"], cfg["context_output_dim"],
                             cfg["context_layers"], cfg["dropout"]),
            FksModule(z, cfg["context_output_dim"], cfg["num_blocks_right"]),
            quantization_weighting=cfg["quantization_weighting"])
    model = model.to_empty(device=device)
    model.load_state_dict(w, strict=True)
    return model


class Train:
    """VQCPCEncoderTrainer at the configuration's batch, dropout and lr, f32."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from vqcpcb_tpu_torch.training.encoder_trainer import VQCPCEncoderTrainer
        self.cfg, self.device = cfg, torch.device(device)
        self.weights = weights.make(weight_spec(cfg), seed, self.device)
        self.program_seed = weights.stream_seed(seed, weights.PROGRAM)
        self.trainer = VQCPCEncoderTrainer(build_model(cfg, self.weights, self.device),
                                           device=self.device, seed=self.program_seed)
        self.pool = traffic_gen.pool(traffic, cfg["vocabulary"], seed, self.device)
        self.trainer.init_state(self.pool[0], lr=cfg["lr"],
                                schedule_lr=cfg["schedule_lr"], initialize=False)
        self.tokens_per_step = sum(int(x.numel()) for x in self.pool[0].values())
        self.names = [n for n, p in self.trainer.model.named_parameters()
                      if p.requires_grad]
        self.codes: List[torch.Tensor] = []

    def step(self, batch) -> torch.Tensor:
        return self.trainer.train_step(batch)["loss"]

    @contextlib.contextmanager
    def recording(self):
        """Keeps the codes of every quantizer call of the block (the first
        steps), which the reference takes at its near ties."""
        def keep(module, inputs, output):
            self.codes.append(output[1].detach().clone())
        handle = self.trainer.model.encoder.quantizer.register_forward_hook(keep)
        try:
            yield
        finally:
            handle.remove()

    def parameters(self) -> Dict[str, torch.Tensor]:
        return dict(self.trainer.model.named_parameters())

    def adam_first_moments(self) -> List[torch.Tensor]:
        return self.trainer.optimizer.mu

    def initial(self) -> Dict[str, torch.Tensor]:
        return self.weights

    def close(self) -> None:
        del self.trainer

    def reference_loss(self, prec: Precision = Precision("f32"), pin: bool = True):
        """loss_fn(params, batch) for compare.follow: the reference VQ-CPC
        loss with the program's dropout draws replayed and, with `pin`, its
        codes at near ties (loss_fn.pins)."""
        draws = Draws(self.program_seed, self.device)
        pins = ref_encoder.Pins(self.codes) if pin else None

        def loss_fn(params, batch):
            return ref_encoder.cpc_loss(params, batch, self.cfg, prec, draws, pins)
        loss_fn.pins = pins
        return loss_fn
