"""Prior training and generation CLI of the port (counterpart of
main_prior.py).

    python -m vqcpcb_tpu_torch.main_prior -t -c <prior config>
    python -m vqcpcb_tpu_torch.main_prior -l -g -c models/<savename>_<timestamp>/config.py

The flags of the JAX CLI (main_prior.py:18-23): -t/--train, -l/--load (from
the model directory holding the given config.py), -c/--config, -g/--generate
(sample codes with the prior and decode them with the trained decoder of
the config's `config_decoder`, writing the scores under generations/),
-n/--num_workers and --num_epochs; plus --device (default: the card;
without CUDA the CLI raises unless given --device cpu). The frozen encoder
comes from the config's `config_encoder` (main_decoder.load_encoder_stack).
Several GPUs as for main_decoder: -t trains over the data mesh of every
rank (torchrun, or the VQCPCB_* variables), rank 0 writes, and -g runs on
rank 0 alone.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
from datetime import datetime
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m vqcpcb_tpu_torch.main_prior",
        description="Train a code prior, or generate with one (PyTorch port).")
    parser.add_argument("-t", "--train", action="store_true")
    parser.add_argument("-l", "--load", action="store_true")
    parser.add_argument("-c", "--config", dest="config_path", required=True)
    parser.add_argument("-g", "--generate", action="store_true")
    parser.add_argument("-n", "--num_workers", type=int, default=0)
    parser.add_argument("--num_epochs", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; cpu to run on the CPU)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    import torch

    from vqcpcb_tpu_torch import getters
    from vqcpcb_tpu_torch.main_decoder import load_encoder_stack
    from vqcpcb_tpu_torch.parallel import distributed
    from vqcpcb_tpu_torch.parallel.mesh import Mesh, make_mesh
    from vqcpcb_tpu_torch.training import checkpoints
    from vqcpcb_tpu_torch.training.prior_trainer import PriorTrainer
    from vqcpcb_tpu_torch.training.profiling import enable_debug_checks
    from vqcpcb_tpu_torch.utils import load_config_module

    distributed.maybe_initialize(args.device)
    enable_debug_checks()
    device = distributed.rank_device(args.device)
    rank = distributed.rank()
    if not args.train and rank != 0:
        return 0                              # generation runs on rank 0 alone
    mesh = make_mesh() if args.train else Mesh(1, 1)
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

    # rank 0 fills the corpus caches
    with distributed.rank_zero_first(mesh.size > 1):
        dataloader_generator = getters.get_dataloader_generator(
            dataset=config["dataset"], training_method="prior",
            dataloader_generator_kwargs=config["dataloader_generator_kwargs"],
            config=config)
        torch.manual_seed(0)                  # the fresh weights, on every rank
        encoder, encoder_config = load_encoder_stack(config)
    codebook_size = encoder_config["quantizer_kwargs"]["codebook_size"]
    prior = getters.get_prior(
        dataloader_generator=dataloader_generator, encoder=encoder,
        encoder_config=encoder_config,
        prior_type=config.get("prior_type", "transformer_relative"),
        prior_kwargs=config["prior_kwargs"])
    trainer = PriorTrainer(encoder, prior, codebook_size, device=device,
                           model_dir=model_dir,
                           dataloader_generator=dataloader_generator, mesh=mesh)
    trainer.init_state(lr=config["lr"])
    if args.load:
        sidecar = checkpoints.read_step_sidecar(model_dir)
        if checkpoints.latest_slot(model_dir) is not None or sidecar is None:
            trainer.load(early_stopped=True)
        elif not args.train:
            # only a mid-epoch step slot: sample from its state, not from
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
            plot=True,
            num_workers=args.num_workers,
            checkpoint_every_steps=config.get("checkpoint_every_steps"))
        if rank != 0:
            return 0                          # generation runs on rank 0 alone

    if args.generate:
        decoder_trainer = load_decoder_trainer(config, encoder, encoder_config,
                                               device)
        # the code sequence covers at least one decoder window
        decoder = decoder_trainer.decoder
        decoder_window_codes = (decoder.data_processor.num_tokens
                                // decoder.total_upscaling)
        trainer.generate(
            num_tokens=max(prior.num_tokens, decoder_window_codes),
            decoder_trainer=decoder_trainer,
            temperature=config.get("generation_temperature", 1.0),
            num_generated_codes=config.get("num_generated_codes", 1),
            num_decodings_per_generated_code=config.get(
                "num_decodings_per_generated_code", 1))
    return 0


def load_decoder_trainer(config, encoder, encoder_config, device):
    """The trained decoder of config['config_decoder'] (main_prior.py:
    102-154): a DecoderTrainer on `device` rebuilt from the decoder's own
    config (its own sequence geometry) over the prior's frozen encoder
    (main_decoder.build_decoder_trainer), with the early_stopped slot of its
    model directory."""
    from vqcpcb_tpu_torch.main_decoder import build_decoder_trainer
    from vqcpcb_tpu_torch.utils import load_config_module

    config_decoder_path = config.get("config_decoder")
    if config_decoder_path is None:
        raise SystemExit("-g requires 'config_decoder' in the prior config to "
                         "point at a trained decoder's config.py")
    decoder_config = load_config_module(config_decoder_path)
    # the decoder was trained on the codes of its own config_encoder; the
    # prior's codes come from the prior's: if those differ, it decodes codes
    # of an encoder it was not trained with
    prior_encoder = os.path.basename(str(config.get("config_encoder", "")))
    decoder_encoder = os.path.basename(str(decoder_config.get("config_encoder", "")))
    if prior_encoder != decoder_encoder:
        print(f"WARNING: the prior's config_encoder ({prior_encoder!r}) differs "
              f"from the decoder's ({decoder_encoder!r}): the decoder will "
              "consume codes from an encoder it was not trained with")
    from vqcpcb_tpu_torch.parallel.mesh import Mesh
    decoder_trainer = build_decoder_trainer(
        decoder_config, encoder, encoder_config, device,
        os.path.dirname(os.path.abspath(config_decoder_path)), Mesh(1, 1))
    decoder_trainer.load(early_stopped=True)
    return decoder_trainer


if __name__ == "__main__":
    sys.exit(main())
