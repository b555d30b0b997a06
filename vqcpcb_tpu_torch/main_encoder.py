"""Encoder training CLI of the port (counterpart of main_encoder.py).

    python -m vqcpcb_tpu_torch.main_encoder -t -c configs/encoder_random_synthetic.py
    python -m vqcpcb_tpu_torch.main_encoder -l -c models/<savename>_<timestamp>/config.py
    python -m vqcpcb_tpu_torch.main_encoder -t -c tests/configs/encoder_smoke.py --device cpu

The flags of the JAX CLI (main_encoder.py:18-26): -t/--train, -l/--load
(from the model directory holding the given config.py; with -t, training
continues, a mid-epoch step checkpoint included), -c/--config (a Python
module defining `config`), --num_workers, --num_epochs and --num_batches
(-1: the whole corpus) overriding the config; plus --device (default: the
card; without CUDA the CLI raises unless given --device cpu). A new model
directory is models/{savename}_{timestamp}, with the config copied in.
After training or loading, the per-code excerpt dumps (clusters_train/,
clusters_val/) and the codebook's nearest neighbours follow
(main_encoder.py:146-184).
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
        prog="python -m vqcpcb_tpu_torch.main_encoder",
        description="Train or load a VQ-CPC encoder (PyTorch port).")
    parser.add_argument("-t", "--train", action="store_true")
    parser.add_argument("-l", "--load", action="store_true")
    parser.add_argument("-c", "--config", dest="config_path", required=True)
    parser.add_argument("--num_workers", type=int, default=0)
    parser.add_argument("--num_epochs", type=int, default=None,
                        help="override config num_epochs")
    parser.add_argument("--num_batches", type=int, default=None,
                        help="override config num_batches (-1 = None: full corpus)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; cpu to run on the CPU)")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch

    from vqcpcb_tpu_torch import getters
    from vqcpcb_tpu_torch.models.encoder import merge_codes
    from vqcpcb_tpu_torch.training import analysis, checkpoints
    from vqcpcb_tpu_torch.training.encoder_trainer import VQCPCEncoderTrainer
    from vqcpcb_tpu_torch.training.optim import warmup_steps_from_env
    from vqcpcb_tpu_torch.utils import load_config_module, resolve_device

    device = resolve_device(args.device)
    print(f"Device: {device}")
    config = load_config_module(args.config_path)
    if config.get("timestamp") is None:
        config["timestamp"] = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    if args.load:
        model_dir = os.path.dirname(os.path.abspath(args.config_path))
    else:
        model_dir = f"models/{config['savename']}_{config['timestamp']}"
    # provenance only, as in JAX: the codebook init runs in init_state
    config.setdefault("quantizer_kwargs", {})["initialize"] = not args.load
    if args.num_epochs is not None:
        config["num_epochs"] = args.num_epochs
    if args.num_batches is not None:
        config["num_batches"] = None if args.num_batches < 0 else args.num_batches

    training_method = config["training_method"].lower()
    if training_method == "student":
        raise NotImplementedError(
            "the student encoder is not ported to vqcpcb_tpu_torch yet "
            "(ROADMAP.md Queue 1, item 5, M6 (c))")
    if training_method != "vqcpc":
        raise NotImplementedError(training_method)
    dataloader_generator = getters.get_dataloader_generator(
        dataset=config["dataset"], training_method=training_method,
        dataloader_generator_kwargs=config["dataloader_generator_kwargs"],
        config=config)
    torch.manual_seed(0)                      # the fresh weights
    model = getters.get_vqcpc_model(dataloader_generator, config)
    trainer = VQCPCEncoderTrainer(model, device=device, model_dir=model_dir,
                                  dataloader_generator=dataloader_generator)
    schedule_lr = config.get("schedule_lr", False)

    if args.load:
        gen_train, _, _ = dataloader_generator.dataloaders(
            batch_size=config["batch_size"], num_workers=args.num_workers)
        trainer.init_state(next(iter(gen_train)), lr=config["lr"],
                           schedule_lr=schedule_lr,
                           warmup_steps=warmup_steps_from_env(),
                           initialize=False)
        sidecar = checkpoints.read_step_sidecar(model_dir)
        if checkpoints.latest_slot(model_dir) is not None or sidecar is None:
            trainer.load(early_stopped=False)
        elif not args.train:
            # only a mid-epoch step slot: analyse its state, not fresh weights
            trainer._restore_step_checkpoint(sidecar)
        # else (-t -l before the first epoch ended): train_model resumes
        # from the step slot

    if args.train:
        if not args.load:
            os.makedirs(model_dir, exist_ok=True)
            shutil.copy(args.config_path, os.path.join(model_dir, "config.py"))
        trainer.train_model(
            batch_size=config["batch_size"],
            num_batches=config["num_batches"],
            num_epochs=config["num_epochs"],
            lr=config["lr"],
            schedule_lr=schedule_lr,
            corrupt_labels=config["quantizer_regularization"]["corrupt_labels"],
            plot=True,
            num_workers=args.num_workers,
            initialize=not args.load,
            checkpoint_every_steps=config.get("checkpoint_every_steps"))

    # ---- cluster exploration (main_encoder.py:146-184) ----------------------
    if trainer.optimizer is None or config["quantizer_type"] not in ("commitment",
                                                                     "ema"):
        return 0          # nothing trained or loaded, or no discrete codes
    clusters_loader = getters.get_dataloader_generator(
        dataset=config["dataset"], training_method="decoder",
        dataloader_generator_kwargs=dict(sequences_size=config[
            "dataloader_generator_kwargs"].get("sequences_size", 24)),
        config=config)
    codebook_size = config["quantizer_kwargs"]["codebook_size"]

    def encode_fn(x):
        return merge_codes(trainer.encode(x)[1], codebook_size).cpu().numpy()

    num_events_for_one_index = int(
        np.prod(config["downscaler_kwargs"]["downscale_factors"])
        // model.encoder.data_processor.num_channels)
    for split in ("train", "val"):
        analysis.plot_clusters(encode_fn, clusters_loader, split, model_dir,
                               num_events_for_one_index, num_batches=64)
    codebooks = model.encoder.quantizer.codebooks.detach().cpu().numpy()
    analysis.show_nn_clusters(codebooks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
