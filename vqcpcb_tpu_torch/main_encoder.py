"""Encoder training CLI of the port (counterpart of main_encoder.py).

    python -m vqcpcb_tpu_torch.main_encoder -t -c configs/encoder_random_synthetic.py
    python -m vqcpcb_tpu_torch.main_encoder -l -c models/<savename>_<timestamp>/config.py
    python -m vqcpcb_tpu_torch.main_encoder -t -c tests/configs/encoder_smoke.py --device cpu
    python -m vqcpcb_tpu_torch.main_encoder -t -c configs/encoder_student_synthetic.py

The flags of the JAX CLI (main_encoder.py:18-26): -t/--train, -l/--load
(from the model directory holding the given config.py; with -t, training
continues, a mid-epoch step checkpoint included), -c/--config (a Python
module defining `config`), --num_workers, --num_epochs and --num_batches
(-1: the whole corpus) overriding the config; plus --device (default: the
card; without CUDA the CLI raises unless given --device cpu). A new model
directory is models/{savename}_{timestamp}, with the config copied in.
The config's training_method picks the trainer: 'vqcpc'
(VQCPCEncoderTrainer) or 'student' (StudentEncoderTrainer, with the teacher
and the auxiliary decoder the config describes, main_encoder.py:75-103).
After training or loading, the per-code excerpt dumps (clusters_train/,
clusters_val/) and the codebook's nearest neighbours follow, and with
3-d codewords the scatter plot clusters_scatter.pdf (main_encoder.py:146-184;
on a machine without matplotlib a line says it was not written).

On ranks (main_encoder.py:35-37): with VQCPCB_COORDINATOR,
VQCPCB_NUM_PROCESSES and VQCPCB_PROCESS_ID, or VQCPCB_DISTRIBUTED=1 and
torchrun's variables, every process joins the group
(distributed.maybe_initialize: NCCL on the card, gloo with --device cpu)
and -t trains over a data-parallel mesh of all of them (make_mesh), every
rank reading the same global batches; rank 0 fills the corpus caches
first, names the model directory (its timestamp, broadcast), writes the
one-GPU-layout slots, metrics and events, and alone runs the cluster dumps
after training; -l without -t runs on rank 0 alone.
"""
from __future__ import annotations

import argparse
import importlib.util
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
    from vqcpcb_tpu_torch.parallel import distributed
    from vqcpcb_tpu_torch.parallel.mesh import Mesh, make_mesh
    from vqcpcb_tpu_torch.training import analysis, checkpoints
    from vqcpcb_tpu_torch.training.optim import warmup_steps_from_env
    from vqcpcb_tpu_torch.training.profiling import enable_debug_checks
    from vqcpcb_tpu_torch.utils import load_config_module

    distributed.maybe_initialize(args.device)
    enable_debug_checks()
    device = distributed.rank_device(args.device)
    rank = distributed.rank()
    if not args.train and rank != 0:
        return 0                              # -l runs on rank 0 alone
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
    # provenance only, as in JAX: the codebook init runs in init_state
    config.setdefault("quantizer_kwargs", {})["initialize"] = not args.load
    if args.num_epochs is not None:
        config["num_epochs"] = args.num_epochs
    if args.num_batches is not None:
        config["num_batches"] = None if args.num_batches < 0 else args.num_batches

    training_method = config["training_method"].lower()
    if training_method not in ("vqcpc", "student"):
        raise NotImplementedError(training_method)
    # rank 0 fills the corpus caches
    with distributed.rank_zero_first(mesh.size > 1):
        trainer, dataloader_generator = build_encoder_trainer(
            config, device, model_dir, mesh)
    encoder = trainer.encoder if training_method == "student" else trainer.model.encoder
    schedule_lr = config.get("schedule_lr", False)

    if args.load:
        gen_train, _, _ = dataloader_generator.dataloaders(
            batch_size=config["batch_size"], num_workers=args.num_workers)
        first = next(iter(gen_train))
        trainer.init_state(first if training_method == "vqcpc" else first["x"],
                           lr=config["lr"], schedule_lr=schedule_lr,
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
        if not args.load and rank == 0:
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
        if rank != 0:
            return 0                          # the dumps run on rank 0 alone

    # ---- cluster exploration (main_encoder.py:146-184) ----------------------
    if (not trainer.initialized
            or config["quantizer_type"] not in ("commitment", "ema")):
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
        // encoder.data_processor.num_channels)
    for split in ("train", "val"):
        analysis.plot_clusters(encode_fn, clusters_loader, split, model_dir,
                               num_events_for_one_index, num_batches=64)
    # the EMA quantizer's codebooks are its buffer, as JAX reads them from
    # its 'ema' collection
    codebooks = encoder.quantizer.codebooks.detach().cpu().numpy()
    analysis.show_nn_clusters(codebooks)
    if config["quantizer_kwargs"]["codebook_dim"] == 3:
        if importlib.util.find_spec("matplotlib") is None:
            print("clusters_scatter.pdf not written: matplotlib is not installed")
        else:
            analysis.scatterplot_clusters_3d(codebooks, model_dir)
    return 0


def build_encoder_trainer(config, device, model_dir: str, mesh=None):
    """(the config's trainer, its data loader generator): a
    VQCPCEncoderTrainer or a StudentEncoderTrainer over fresh weights from
    torch.manual_seed(0) (the same on every rank), training over `mesh`
    (None: make_mesh())."""
    import torch

    from vqcpcb_tpu_torch import getters
    from vqcpcb_tpu_torch.training.encoder_trainer import VQCPCEncoderTrainer
    training_method = config["training_method"].lower()
    dataloader_generator = getters.get_dataloader_generator(
        dataset=config["dataset"], training_method=training_method,
        dataloader_generator_kwargs=config["dataloader_generator_kwargs"],
        config=config)
    torch.manual_seed(0)                      # the fresh weights
    if training_method == "vqcpc":
        trainer = VQCPCEncoderTrainer(
            getters.get_vqcpc_model(dataloader_generator, config), device=device,
            model_dir=model_dir, dataloader_generator=dataloader_generator,
            mesh=mesh)
    else:
        encoder = getters.get_encoder(dataloader_generator, config)
        trainer = student_trainer(config, dataloader_generator, encoder,
                                  device, model_dir, mesh)
    return trainer, dataloader_generator


def student_trainer(config, dataloader_generator, encoder, device, model_dir,
                    mesh=None):
    """The StudentEncoderTrainer of a 'student' config, its teacher and
    auxiliary decoder built with the widths JAX derives
    (main_encoder.py:75-103): the vocabulary and token counts of the
    encoder's data processor, the codebook dimension, the downscale factors
    reversed as upscale factors, and the bottleneck's token count."""
    import numpy as np

    from vqcpcb_tpu_torch import getters
    from vqcpcb_tpu_torch.training.student_trainer import StudentEncoderTrainer
    aux = config["auxiliary_networks_kwargs"]
    processor = encoder.data_processor
    teacher_kwargs = dict(aux["teacher_kwargs"],
                          num_tokens_per_channel=processor.num_tokens_per_channel,
                          num_tokens=processor.num_tokens)
    factors = config["downscaler_kwargs"]["downscale_factors"]
    decoder_kwargs = dict(
        aux["auxiliary_decoder_kwargs"],
        num_tokens_per_channel=processor.num_tokens_per_channel,
        codebook_dim=config["quantizer_kwargs"]["codebook_dim"],
        upscale_factors=list(reversed(factors)),
        num_tokens_bottleneck=processor.num_tokens // int(np.prod(factors)))
    return StudentEncoderTrainer(
        encoder=encoder,
        teacher=getters.get_teacher(teacher_kwargs, dataloader_generator),
        auxiliary_decoder=getters.get_auxiliary_decoder(
            aux["auxiliary_decoder_type"], decoder_kwargs),
        num_events_masked=aux["num_events_masked"],
        quantization_weighting=aux["quantization_weighting"],
        device=device, model_dir=model_dir,
        dataloader_generator=dataloader_generator, mesh=mesh)


if __name__ == "__main__":
    sys.exit(main())
