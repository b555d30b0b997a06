"""Two-slot checkpoints with the whole trainer state, and the step slot
(counterpart of vqcpcb_tpu/training/checkpoints.py on torch.save /
torch.load instead of orbax).

The reference's policy: `overfitted` is saved every epoch, `early_stopped`
on the best validation monitor, each a directory of the model directory
(slot_dir, save_state, load_state, latest_slot: checkpoints.py:121-203). A
third slot, `step_checkpoint/`, holds the state every N train steps with a
JSON sidecar (`step_checkpoint.json`) giving the epoch, the batches done,
the partial metric sums and the generator states, so `-t -l` resumes inside
an interrupted epoch (:206-254).

A state is a dict of state_dicts, tensors and numbers, saved with
torch.save and read with torch.load(weights_only=True): no pickled module.
Every file goes through a temporary file and os.replace, and the step
sidecar is written after its state, so a crash during a save keeps the
previous consistent pair (:214-226).

A weights-only state, {"model": state_dict} with no optimizer, step or
generators (save_weights_only, :133-143), is what the reference-checkpoint
migration writes (migrate_reference_checkpoint.py); every trainer's `-l`
adopts it with fresh optimizer moments (TrainLoopMixin.load_state_dict, as
_adopt_weights_only at :62-118). A model directory without the slot's
directory is read as the reference's pre-slot layout, its state in the
model directory itself (:148-150). The orbax-only legacy QKV layout
(:24-59) has no counterpart here.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import torch

SLOTS = ("early_stopped", "overfitted")
STATE_FILE = "state.pt"
STEP_SLOT = "step_checkpoint"


def _atomic_save(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: str, map_location) -> Dict:
    return torch.load(path, map_location=map_location, weights_only=True)


def slot_dir(model_dir: str, early_stopped: bool) -> str:
    return os.path.join(os.path.abspath(model_dir),
                        "early_stopped" if early_stopped else "overfitted")


def save_state(model_dir: str, early_stopped: bool, state: Dict) -> None:
    _atomic_save(state, os.path.join(slot_dir(model_dir, early_stopped),
                                     STATE_FILE))


def save_weights_only(model_dir: str, early_stopped: bool,
                      model_state: Dict) -> None:
    """A slot holding only a module's state_dict: {"model": model_state}."""
    save_state(model_dir, early_stopped, {"model": model_state})


def is_weights_only(state: Dict) -> bool:
    return set(state) == {"model"}


def load_state(model_dir: str, early_stopped: bool,
               map_location="cpu") -> Dict:
    """A slot's state; without the slot's directory, the state in the model
    directory itself (the reference's pre-slot layout)."""
    path = slot_dir(model_dir, early_stopped)
    if not os.path.exists(path):
        path = os.path.abspath(model_dir)
    return _load(os.path.join(path, STATE_FILE), map_location)


def latest_slot(model_dir: str) -> Optional[str]:
    """For crash-resume: prefer `overfitted` (written every epoch)."""
    for slot in ("overfitted", "early_stopped"):
        if os.path.exists(os.path.join(model_dir, slot, STATE_FILE)):
            return slot
    return None


# ---- step-level (mid-epoch) checkpoints ----------------------------------

def _step_path(model_dir: str) -> str:
    return os.path.join(os.path.abspath(model_dir), STEP_SLOT, STATE_FILE)


def _step_sidecar_path(model_dir: str) -> str:
    return os.path.join(os.path.abspath(model_dir), f"{STEP_SLOT}.json")


def save_step_state(model_dir: str, state: Dict, info: Dict) -> None:
    """The state mid-epoch, then the sidecar describing its position."""
    _atomic_save(state, _step_path(model_dir))
    tmp = _step_sidecar_path(model_dir) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(info, f)
    os.replace(tmp, _step_sidecar_path(model_dir))


def read_step_sidecar(model_dir: str) -> Optional[Dict]:
    """The sidecar, or None when it or its state is missing or unreadable."""
    path = _step_sidecar_path(model_dir)
    if not (os.path.exists(path) and os.path.exists(_step_path(model_dir))):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (ValueError, OSError):
        return None


def load_step_state(model_dir: str, map_location="cpu") -> Dict:
    return _load(_step_path(model_dir), map_location)


def clear_step_state(model_dir: str) -> None:
    shutil.rmtree(os.path.dirname(_step_path(model_dir)), ignore_errors=True)
    if os.path.exists(_step_sidecar_path(model_dir)):
        os.remove(_step_sidecar_path(model_dir))
