"""Epoch metrics: one JSON line per epoch in {model_dir}/metrics.jsonl,
plus TensorBoard scalars when `plot` (counterpart of
vqcpcb_tpu/training/metrics.py, the same record format: "epoch", "time",
and f"{key}/{split}", a list value split into f"{key}_{i}/{split}").
`epochs_logged` and `best_val` read the file back, so a resumed run
continues the epoch numbering and the early-stopping bar.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsWriter:
    def __init__(self, model_dir: str, plot: bool = False):
        self.model_dir = os.path.abspath(model_dir)
        os.makedirs(self.model_dir, exist_ok=True)
        self.jsonl_path = os.path.join(self.model_dir, "metrics.jsonl")
        self._tb = None
        if plot:
            from vqcpcb_tpu_torch.training.tb_writer import SummaryWriter
            self._tb = SummaryWriter(self.model_dir)

    def epochs_logged(self) -> int:
        """Epochs already recorded in metrics.jsonl; a crash-resumed run
        (-t -l) continues numbering from here instead of restarting at 0."""
        if not os.path.exists(self.jsonl_path):
            return 0
        last = -1
        with open(self.jsonl_path) as f:
            for line in f:
                try:
                    last = max(last, int(json.loads(line).get("epoch", -1)))
                except (ValueError, json.JSONDecodeError):
                    continue
        return last + 1

    def best_val(self, key: str) -> float:
        """Minimum of f'{key}/val' over epochs already logged — restores the
        early-stopping bar on crash-resume so a worse post-resume epoch can't
        silently overwrite the early_stopped checkpoint."""
        best = 1e8
        if not os.path.exists(self.jsonl_path):
            return best
        full_key = f"{key}/val"
        with open(self.jsonl_path) as f:
            for line in f:
                try:
                    v = json.loads(line).get(full_key)
                except (ValueError, json.JSONDecodeError):
                    continue
                if v is not None:
                    best = min(best, float(v))
        return best

    def write(self, epoch_id: int, train: Optional[Dict], val: Optional[Dict]):
        record = {"epoch": epoch_id, "time": time.time()}
        for split, quantities in (("train", train), ("val", val)):
            if quantities is None:
                continue
            for k, v in quantities.items():
                if isinstance(v, (list, tuple)):
                    for i, elem in enumerate(v):
                        record[f"{k}_{i}/{split}"] = float(elem)
                        if self._tb:
                            self._tb.add_scalar(f"{k}_{i}/{split}",
                                                float(elem), epoch_id)
                else:
                    record[f"{k}/{split}"] = float(v)
                    if self._tb:
                        self._tb.add_scalar(f"{k}/{split}", float(v), epoch_id)
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb:
            self._tb.flush()
