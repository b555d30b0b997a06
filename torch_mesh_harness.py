"""Shared by tests/test_torch_mesh.py, tests/test_torch_cuda.py and
chip_smoke.py: a decoder or prior trainer over a mesh of rank processes
(`train_over_mesh`, a target of parallel/launch.run_ranks), every kernel
wrapper's launch count (`launch_counts`), and `ReluPins`, which records the
ReLU pre-activations near zero of one run and holds another run's ReLU
masks to them.

    results = run_ranks("torch_mesh_harness:train_over_mesh", 4, payload,
                        timeout_s=120)

Why the pins: two f32 runs of one step over different batch or column
partitions differ by rounding only (cuBLAS picks its algorithm by the
matrix shapes), but a ReLU pre-activation within rounding of zero can take
opposite signs in the two, and such a unit moves its layer's linear1
gradient by one token's whole contribution (on an H100 up to 2.7e-3 of
the gradient's largest value over 4 row blocks of one batch, with no mesh
code). Pinning the masks keeps each value within rounding of the other
run's, passes the gradient through unchanged (value + (ref - value)
.detach()) and leaves every other difference to the comparison.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import torch


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count in this process (K1's also by
    the kernel its shape picked, as "vq_nearest/<kind>")."""
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    from vqcpcb_tpu_torch.ops import fused_attention_kernels as fk
    from vqcpcb_tpu_torch.ops import vq_kernels as vk
    return {**{f"vq_nearest/{kind}": n for kind, n in vk.launches_by_kind.items()},
            "vq_nearest": vk.launches, "relbias_attention_fwd": ak.launches,
            "relbias_attention_bwd": ak.bwd_launches,
            "relbias_attention_packed_tp": ak.tp_launches,
            "relbias_attention_tp": ak.tp_bhld_launches,
            "fused_attention": fk.launches,
            "fused_attention_train_fwd": fk.train_fwd_launches,
            "fused_attention_train_bwd": fk.train_bwd_launches,
            "fused_attention_train_bwd_nobias": fk.train_bwd_nobias_launches,
            "fused_attention_train_tp": fk.train_tp_launches}


def reset_launch_counts() -> None:
    """Every count of launch_counts to 0."""
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    from vqcpcb_tpu_torch.ops import fused_attention_kernels as fk
    from vqcpcb_tpu_torch.ops import vq_kernels as vk
    vk.launches = 0
    vk.launches_by_kind.update(dict.fromkeys(vk.launches_by_kind, 0))
    ak.launches = ak.bwd_launches = ak.tp_launches = ak.tp_bhld_launches = 0
    fk.launches = fk.train_fwd_launches = fk.train_tp_launches = 0
    fk.train_bwd_launches = fk.train_bwd_nobias_launches = 0


# ---- ReLU masks held to another run's ------------------------------------------

class ReluPins:
    """The ReLU calls of the port's transformer layers (ops/transformer.py
    feed_forward), in call order, while the object is entered.

    Recording (`pins=None`): each call's global pre-activation h (B, L, F)
    leaves its elements with |h| <= rel * max|h| as (indices, values) in
    `self.pins`. Pinning (`pins` a recording, this run's place in the
    recorded run's rows and columns from `data` = (index, count) and
    `model` = (index, count)): each call's local block of h takes the
    recorded value wherever the recorded sign differs from its own; the
    numbers of such units by call go to `self.flips`, and the largest
    |local - recorded| over the recorded elements this run holds to
    `self.gap`. Raises if the runs make different numbers of calls."""

    def __init__(self, pins: Optional[List] = None, data=(0, 1), model=(0, 1),
                 rel: float = 1e-4):
        self.pins = [] if pins is None else pins
        self.recording = pins is None
        self.data, self.model, self.rel = data, model, rel
        self.flips: List[int] = []
        self.gap = 0.0
        self._calls = 0

    def __enter__(self) -> "ReluPins":
        from vqcpcb_tpu_torch.ops import transformer
        self._saved = transformer.F
        transformer.F = _Functional(self._relu)
        return self

    def __exit__(self, *exc) -> None:
        from vqcpcb_tpu_torch.ops import transformer
        transformer.F = self._saved
        if exc[0] is None and not self.recording and self._calls != len(self.pins):
            raise AssertionError(f"{self._calls} ReLU calls, the recorded run "
                                 f"made {len(self.pins)}")

    def _relu(self, h: torch.Tensor) -> torch.Tensor:
        import torch.nn.functional as F
        call, self._calls = self._calls, self._calls + 1
        if self.recording:
            hd = h.detach()
            near = hd.abs() <= self.rel * hd.abs().max()
            idx = near.nonzero()
            self.pins.append((tuple(h.shape), idx.cpu(), hd[near].float().cpu()))
            return F.relu(h)
        if call >= len(self.pins):
            raise AssertionError("more ReLU calls than the recorded run made")
        shape, idx, values = self.pins[call]
        offsets = []
        for dim, (index, count) in ((0, self.data), (h.dim() - 1, self.model)):
            width = h.shape[dim]
            if width == shape[dim]:
                offsets.append(0)
            elif width * count == shape[dim]:
                offsets.append(index * width)
            else:
                raise AssertionError(f"ReLU input {tuple(h.shape)} is no block "
                                     f"of the recorded {shape}")
        idx = idx.to(h.device).clone()
        idx[:, 0] -= offsets[0]
        idx[:, -1] -= offsets[1]
        mine = ((idx[:, 0] >= 0) & (idx[:, 0] < h.shape[0])
                & (idx[:, -1] >= 0) & (idx[:, -1] < h.shape[-1]))
        idx, values = idx[mine], values.to(h.device)[mine]
        at = tuple(idx.t())
        local = h.detach()[at].float()
        if len(values):
            self.gap = max(self.gap, (local - values).abs().max().item())
        flip = (local > 0) != (values > 0)
        self.flips.append(int(flip.sum()))
        delta = torch.zeros_like(h)
        delta[tuple(idx[flip].t())] = (values[flip] - local[flip]).to(h.dtype)
        return F.relu(h + delta)


class _Functional:
    """torch.nn.functional with relu replaced."""

    def __init__(self, relu):
        self.relu = relu

    def __getattr__(self, name):
        import torch.nn.functional as F
        return getattr(F, name)


# ---- a trainer over a mesh -------------------------------------------------------

def train_over_mesh(rank: int, world_size: int, payload: Dict) -> Dict:
    """Train a DecoderTrainer or a PriorTrainer over a (world / num_model,
    num_model) mesh of the group and report what rank 0 sees.

    payload: kind ("decoder" or "prior"), encoder and model (modules with
    the full weights, the same on every rank), codebook_size, num_model,
    batches (global token batches, one a step), lr, device ("cpu", or
    "cuda": every rank on the current card), optional model_dir (rank 0
    saves the overfitted slot there after the steps), optional eval_batch,
    env (variables set while the job runs) and relu_pins (a ReluPins
    recording of one rank's first step on the same batch: this rank's
    first step holds its ReLU masks to it). Returns {"losses" (one a step),
    "grads" (the first step's clipped gradients, gathered to the one-GPU
    layout, by name), "eval_loss", "launches" (this rank's, counted over
    the steps), "seconds" (the steps, synchronised), "flips" and "pin_gap"
    (ReluPins' counts, summed over the ranks, and largest gap)}; other
    ranks return their losses, launches and pins' numbers only. A list of
    payloads runs each in turn and returns the list of results."""
    if isinstance(payload, list):
        return [train_over_mesh(rank, world_size, job) for job in payload]
    return with_env(payload.get("env", {}), lambda: _train_over_mesh(rank, payload))


def with_env(env: Dict[str, str], fn):
    """fn() with the variables of `env` set, the environment restored
    after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, value in saved.items():
            if value is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = value


def _train_over_mesh(rank: int, payload: Dict) -> Dict:
    from vqcpcb_tpu_torch.parallel.mesh import gather_tensor, make_mesh, module_specs
    mesh = make_mesh(payload["num_model"])
    device = torch.device(payload["device"])
    if payload["kind"] == "decoder":
        from vqcpcb_tpu_torch.training.decoder_trainer import DecoderTrainer as cls
    else:
        from vqcpcb_tpu_torch.training.prior_trainer import PriorTrainer as cls
    trainer = cls(payload["encoder"], payload["model"], payload["codebook_size"],
                  device=device, model_dir=payload.get("model_dir"), mesh=mesh)
    trainer.init_state(payload["lr"])
    module = trainer.decoder if payload["kind"] == "decoder" else trainer.prior
    before = launch_counts()
    losses, grads, pins = [], None, None
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for batch in payload["batches"]:
        if grads is None and payload.get("relu_pins") is not None:
            pins = ReluPins(payload["relu_pins"], (mesh.data_index, mesh.n_data),
                            (mesh.model_index, mesh.n_model))
            with pins:
                losses.append(float(trainer.train_step(batch)["loss"]))
        else:
            losses.append(float(trainer.train_step(batch)["loss"]))
        if grads is None:
            specs = module_specs(module)
            grads = {name: gather_tensor(
                         torch.zeros_like(p) if p.grad is None else p.grad,
                         specs.get(name), mesh).cpu()
                     for name, p in module.named_parameters()}
    sync()
    seconds = time.perf_counter() - t0
    after = launch_counts()
    result = {"losses": losses, "grads": grads, "seconds": seconds,
              "launches": {k: after[k] - before[k] for k in after}}
    if pins is not None:
        result.update(flips=pins.flips, pin_gap=pins.gap)
    if payload.get("eval_batch") is not None:
        result["eval_loss"] = float(trainer.eval_step(payload["eval_batch"])["loss"])
    if payload.get("model_dir"):
        trainer.save(early_stopped=False)
    if rank == 0:
        return result
    return {k: result[k] for k in ("launches", "losses", "flips", "pin_gap")
            if k in result}
