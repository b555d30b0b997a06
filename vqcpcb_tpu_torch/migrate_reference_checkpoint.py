"""Migrate a PyTorch-reference model directory into the port's layout
(counterpart of scripts/migrate_reference_checkpoint.py).

    python -m vqcpcb_tpu_torch.migrate_reference_checkpoint REF_DIR [-o OUT] \\
        [--kind auto|encoder|decoder|prior]

The reference keeps per-module state_dicts under
REF_DIR/{early_stopped,overfitted}/: {data_processor, downscaler, quantizer,
upscaler} for an encoder (VQCPCB/encoder.py:47-74), one whole `decoder`
file (decoders/decoder.py:274-292), a `prior` file
(priors/prior_relative.py:109-119), with its config.py beside them. Each
slot, or the model directory itself in the older flat layout (migrated as
`early_stopped`), goes through training/import_reference.py and is written
as a weights-only state (checkpoints.save_weights_only): an encoder under
`encoder.`, as the decoder CLI's `config_encoder` reads it. The geometry
(layer and head counts, the downscaler, the decoder type) comes from the
directory's config.py, which is copied to OUT (default
models/migrated_<name of REF_DIR>). It is a relayout on the CPU: no data
loader is built, so a config naming the `bach` corpus migrates too.

Every trainer's `-l` then reads OUT with fresh optimizer moments (the
reference saves none), `-t -l` continues training from it, and a decoder
or prior config whose `config_encoder` / `config_decoder` names OUT's
config.py decodes through it. Codes match the reference's only over the
same vocabulary (Vocabulary.from_reference_pickle).
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
from typing import Dict, Optional, Sequence

import torch

from vqcpcb_tpu_torch.training import import_reference as ir

KINDS = ("encoder", "decoder", "prior")


def _load_sd(slot_path: str, name: str) -> Optional[Dict]:
    return ir.load_torch_file(os.path.join(slot_path, name))


def detect_kind(slot_path: str) -> str:
    for kind, name in (("encoder", "downscaler"), ("decoder", "decoder"),
                       ("prior", "prior")):
        if os.path.exists(os.path.join(slot_path, name)):
            return kind
    raise ValueError(f"{slot_path}: no reference checkpoint files found "
                     "(expected downscaler|decoder|prior)")


def migrate_slot(slot_path: str, config: Dict, kind: str) -> Dict[str, torch.Tensor]:
    """One slot of a reference directory -> the state_dict that the port's
    trainer of that kind saves as its model: the encoder's under
    `encoder.` (the VQ-CPC model's context nets, never saved by the
    reference, stay fresh), the BatchNorm statistics among them."""
    from vqcpcb_tpu_torch.getters import DECODER_TYPES

    if kind == "encoder":
        dk = config["downscaler_kwargs"]
        quantizer = _load_sd(slot_path, "quantizer")
        sd = ir.import_encoder_state_dicts(
            _load_sd(slot_path, "data_processor"), _load_sd(slot_path, "downscaler"),
            quantizer, _load_sd(slot_path, "upscaler"),
            num_layers_gru=dk.get("num_layers", 2),
            bidirectional=dk.get("bidirectional", True),
            downscaler_type=config["downscaler_type"],
            num_heads=dk.get("n_head", 8),
            list_of_num_layers=dk.get("list_of_num_layers"))
        sd.update(ir.import_encoder_batch_stats(quantizer))
        return {f"encoder.{k}": v for k, v in sd.items()}
    if kind == "decoder":
        dk = config["decoder_kwargs"]
        transformer_type, _, cross = DECODER_TYPES[config["decoder_type"]]
        return ir.import_decoder_state_dict(
            _load_sd(slot_path, "decoder"), num_heads=dk["n_head"],
            num_encoder_layers=dk["num_encoder_layers"],
            num_decoder_layers=dk["num_decoder_layers"],
            aligned_cross=cross == "diagonal", transformer_type=transformer_type)
    if kind == "prior":
        pk = config["prior_kwargs"]
        return ir.import_prior_state_dict(_load_sd(slot_path, "prior"),
                                          num_heads=pk["n_head"],
                                          num_layers=pk["num_layers"])
    raise ValueError(f"unknown kind {kind}")


def num_params(sd: Dict[str, torch.Tensor]) -> int:
    """The parameters' element count, the BatchNorm statistics aside (the
    JAX CLI counts its params tree)."""
    return sum(v.numel() for k, v in sd.items()
               if not k.endswith(("running_mean", "running_var")))


def parse_args(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m vqcpcb_tpu_torch.migrate_reference_checkpoint",
        description="Migrate a PyTorch-reference model directory into "
                    "weights-only checkpoints of the port.")
    parser.add_argument("ref_dir")
    parser.add_argument("-o", "--out_dir", default=None,
                        help="output model dir (default: models/migrated_<refname>)")
    parser.add_argument("--kind", choices=("auto",) + KINDS, default="auto")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    from vqcpcb_tpu_torch.training import checkpoints
    from vqcpcb_tpu_torch.utils import load_config_module

    args = parse_args(argv)
    ref_dir = os.path.abspath(args.ref_dir)
    if not os.path.isdir(ref_dir):
        raise SystemExit(f"{ref_dir}: not a directory")
    config_path = os.path.join(ref_dir, "config.py")
    if not os.path.exists(config_path):
        raise SystemExit(f"{config_path} not found: the reference copies it into "
                         "the model directory")
    config = load_config_module(config_path)
    out_dir = args.out_dir or os.path.join("models",
                                           f"migrated_{os.path.basename(ref_dir)}")
    os.makedirs(out_dir, exist_ok=True)

    slots = [s for s in checkpoints.SLOTS if os.path.isdir(os.path.join(ref_dir, s))]
    flat_layout = not slots
    if flat_layout:            # the pre-slot layout (encoder.py:66-68 fallback)
        slots = ["early_stopped"]
    for slot in slots:
        slot_path = ref_dir if flat_layout else os.path.join(ref_dir, slot)
        kind = detect_kind(slot_path) if args.kind == "auto" else args.kind
        sd = migrate_slot(slot_path, config, kind)
        early_stopped = slot == "early_stopped"
        checkpoints.save_weights_only(out_dir, early_stopped, sd)
        print(f"{slot}: migrated {kind} ({num_params(sd):,} params) -> "
              f"{checkpoints.slot_dir(out_dir, early_stopped)}")
    shutil.copyfile(config_path, os.path.join(out_dir, "config.py"))
    print(f"config copied; point config_encoder / -c at {out_dir}/config.py")
    return 0


if __name__ == "__main__":
    sys.exit(main())
