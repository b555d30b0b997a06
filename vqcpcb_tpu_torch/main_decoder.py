"""Decoder training and generation CLI of the port (counterpart of
main_decoder.py).

    python -m vqcpcb_tpu_torch.main_decoder -t -c configs/decoder_synthetic.py
    python -m vqcpcb_tpu_torch.main_decoder -l -r -c models/<savename>_<timestamp>/config.py
    python -m vqcpcb_tpu_torch.main_decoder -l --num_examples 1 -c models/<...>/config.py

The flags of the JAX CLI (main_decoder.py:75-88): -t/--train, -l/--load
(from the model directory holding the given config.py; the early_stopped
slot unless -o/--overfitted), -c/--config, -r/--reharmonization (three
re-harmonisations of the corpus's first score, under reharmonisations/),
--code_juxtaposition, -n/--num_workers, --num_examples (seeded generations
under generations/), --num_epochs and --num_batches (-1: the whole corpus);
plus --device (default: the card; without CUDA the CLI raises unless given
--device cpu). The frozen encoder comes from the config's `config_encoder`
(load_encoder_stack); over an encoder without a quantizer the decoder reads
its z, and -r fails where the JAX CLI's does (Decoder.embed_source).
VQCPCB_DEBUG_NANS=1 turns the NaN checks on and VQCPCB_PROFILE_DIR traces
each train epoch (training/profiling.py), in the three CLIs.

Several GPUs: one process per GPU, started by torchrun (VQCPCB_DISTRIBUTED=1
torchrun --nproc_per_node=N -m vqcpcb_tpu_torch.main_decoder -t -c ...) or
with VQCPCB_COORDINATOR / VQCPCB_NUM_PROCESSES / VQCPCB_PROCESS_ID
(parallel/distributed.py); rank r runs on cuda:LOCAL_RANK and -t trains
over the data mesh of all ranks, as the JAX CLI trains over all devices.
Generation (-r, --num_examples) runs on every rank over the same mesh
(-l loads the one-GPU slot into each rank's blocks), each rank sampling
its rows of a batch that divides the data axis and the whole of one that
does not (the batch of 3 on 2 or 4 ranks), as the JAX CLI samples over its
devices; rank 0 writes the model directory and the scores. Without those
variables the CLI is one rank, as before.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
from datetime import datetime
from typing import TYPE_CHECKING, Dict, Optional, Sequence, Tuple

if TYPE_CHECKING:
    from vqcpcb_tpu_torch.models.encoder import Encoder

# the encoder configuration a decoder config without one uses
# (main_decoder.py:30-31)
DEFAULT_ENCODER_CONFIG = "configs/encoder_random_16C.py"


def load_encoder_stack(config: Dict, cache_root: Optional[str] = None
                       ) -> Tuple["Encoder", Dict]:
    """The frozen encoder of config['config_encoder'] (a VQ-CPC or a
    student encoder) with the weights of its model directory's checkpoint
    (main_decoder.py:16-71): the latest
    slot, `overfitted` first, a trainer's whole state or a weights-only
    one (a migrated reference encoder, migrate_reference_checkpoint.py),
    its `encoder.` entries with the BatchNorm statistics. Without a
    config_encoder it builds
    DEFAULT_ENCODER_CONFIG's encoder; without a checkpoint it warns and keeps
    the fresh weights. Returns (encoder, encoder_config)."""
    from vqcpcb_tpu_torch import getters
    from vqcpcb_tpu_torch.training import checkpoints
    from vqcpcb_tpu_torch.utils import load_config_module

    config_encoder_path = config["config_encoder"]
    load_weights = config_encoder_path is not None
    if config_encoder_path is None:
        config_encoder_path = DEFAULT_ENCODER_CONFIG
    encoder_config = load_config_module(config_encoder_path)
    encoder_config["quantizer_kwargs"]["initialize"] = False
    model_dir_encoder = os.path.dirname(os.path.abspath(config_encoder_path))
    dataloader_generator = getters.get_dataloader_generator(
        dataset=encoder_config["dataset"],
        training_method=encoder_config["training_method"],
        dataloader_generator_kwargs=encoder_config["dataloader_generator_kwargs"],
        config=encoder_config, cache_root=cache_root)
    encoder = getters.get_encoder(dataloader_generator, encoder_config)
    if load_weights:
        slot = checkpoints.latest_slot(model_dir_encoder)
        if slot is not None:
            model = checkpoints.load_state(
                model_dir_encoder, early_stopped=slot == "early_stopped")["model"]
            # the encoder's entries of the VQ-CPC or the student trainer's
            # model state
            encoder.load_state_dict({k[len("encoder."):]: v
                                     for k, v in model.items()
                                     if k.startswith("encoder.")})
        else:
            print(f"WARNING: no checkpoint found in {model_dir_encoder}; "
                  "using fresh encoder weights")
    return encoder, encoder_config


def build_decoder_trainer(config: Dict, encoder: "Encoder",
                          encoder_config: Dict, device, model_dir: str,
                          mesh=None):
    """The DecoderTrainer of a decoder config over `encoder` (main_decoder.py:
    119-155): its data loader, data processor and decoder, on `device`,
    saving to `model_dir`, over `mesh` (the trainer's default: every rank),
    with its optimizer state initialised (lr, schedule, warm-up steps)."""
    from vqcpcb_tpu_torch import getters
    from vqcpcb_tpu_torch.training.decoder_trainer import DecoderTrainer
    from vqcpcb_tpu_torch.training.optim import warmup_steps_from_env

    dataloader_generator = getters.get_dataloader_generator(
        dataset=config["dataset"], training_method=config["training_method"],
        dataloader_generator_kwargs=config["dataloader_generator_kwargs"],
        config=config)
    data_processor = getters.get_data_processor(
        dataloader_generator=dataloader_generator,
        data_processor_type=config["data_processor_type"],
        data_processor_kwargs=config["data_processor_kwargs"])
    decoder = getters.get_decoder(
        dataloader_generator=dataloader_generator,
        data_processor=data_processor, encoder=encoder,
        encoder_config=encoder_config, decoder_type=config["decoder_type"],
        decoder_kwargs=config["decoder_kwargs"])
    trainer = DecoderTrainer(
        encoder, decoder, encoder_config["quantizer_kwargs"]["codebook_size"],
        device=device, model_dir=model_dir,
        dataloader_generator=dataloader_generator, mesh=mesh)
    trainer.init_state(lr=config["lr"],
                       schedule_lr=config.get("schedule_lr", False),
                       warmup_steps=warmup_steps_from_env())
    return trainer


def parse_args(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m vqcpcb_tpu_torch.main_decoder",
        description="Train a decoder, or generate with one (PyTorch port).")
    parser.add_argument("-t", "--train", action="store_true")
    parser.add_argument("-l", "--load", action="store_true")
    parser.add_argument("-o", "--overfitted", action="store_true",
                        help="Load over-fitted weights for the decoder instead "
                             "of early-stopped. Only used with -l")
    parser.add_argument("-c", "--config", dest="config_path", required=True)
    parser.add_argument("-r", "--reharmonization", action="store_true")
    parser.add_argument("--code_juxtaposition", action="store_true")
    parser.add_argument("-n", "--num_workers", type=int, default=0)
    parser.add_argument("--num_examples", type=int, default=0)
    parser.add_argument("--num_epochs", type=int, default=None)
    parser.add_argument("--num_batches", type=int, default=None,
                        help="override config num_batches (-1 = None: full corpus)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; cpu to run on the CPU)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    import torch

    from vqcpcb_tpu_torch.parallel import distributed
    from vqcpcb_tpu_torch.parallel.mesh import make_mesh
    from vqcpcb_tpu_torch.training import checkpoints
    from vqcpcb_tpu_torch.training.profiling import enable_debug_checks
    from vqcpcb_tpu_torch.utils import load_config_module

    distributed.maybe_initialize(args.device)
    enable_debug_checks()
    device = distributed.rank_device(args.device)
    rank = distributed.rank()
    mesh = make_mesh()
    print(f"Device: {device}" + (f" (rank {rank} of a {mesh.n_data} x "
                                 f"{mesh.n_model} mesh)" if mesh.size > 1 else ""))
    config = load_config_module(args.config_path)
    if config.get("timestamp") is None:
        config["timestamp"] = distributed.broadcast_object(
            datetime.now().strftime("%Y-%m-%d_%H-%M-%S"), mesh.size > 1)
    if args.load:
        model_dir = os.path.dirname(os.path.abspath(args.config_path))
    else:
        model_dir = f"models/{config['savename']}_{config['timestamp']}"
    if args.num_epochs is not None:
        config["num_epochs"] = args.num_epochs
    if args.num_batches is not None:
        config["num_batches"] = None if args.num_batches < 0 else args.num_batches

    torch.manual_seed(0)                      # the fresh weights, on every rank
    # rank 0 fills the corpus caches
    with distributed.rank_zero_first(mesh.size > 1):
        encoder, encoder_config = load_encoder_stack(config)
        trainer = build_decoder_trainer(config, encoder, encoder_config, device,
                                        model_dir, mesh)
    if args.load:
        sidecar = checkpoints.read_step_sidecar(model_dir)
        if checkpoints.latest_slot(model_dir) is not None or sidecar is None:
            trainer.load(early_stopped=not args.overfitted)
        elif not args.train:
            # only a mid-epoch step slot: generate from its state, not from
            # fresh weights
            trainer._restore_step_checkpoint(sidecar)
        # else (-t -l before the first epoch ended): train_model resumes
        # from the step slot

    if args.train:
        if not args.load and rank == 0:
            os.makedirs(model_dir, exist_ok=True)
            shutil.copy(args.config_path, os.path.join(model_dir, "config.py"))
        trainer.train_model(
            batch_size=config["batch_size"],
            num_batches=config["num_batches"],
            num_epochs=config["num_epochs"],
            lr=config["lr"],
            schedule_lr=config.get("schedule_lr", False),
            plot=True,
            num_workers=args.num_workers,
            checkpoint_every_steps=config.get("checkpoint_every_steps"))

    for _ in range(args.num_examples):
        if args.code_juxtaposition:
            trainer.generate(temperature=1.0, top_p=0.9, top_k=0, batch_size=3,
                             seed_set="val", code_juxtaposition=True)
        trainer.generate(temperature=0.95, top_p=0.8, top_k=0, batch_size=3,
                         seed_set="val", code_juxtaposition=False)

    if args.reharmonization:
        trainer.generate_reharmonisation(
            temperature=0.9, top_p=0.8, top_k=0, num_reharmonisations=3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
