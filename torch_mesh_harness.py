"""Shared by tests/test_torch_mesh.py, tests/test_torch_cuda.py and
chip_smoke.py: a decoder, prior, VQ-CPC or student trainer over a mesh of
rank processes (`train_over_mesh`, a target of parallel/launch.run_ranks;
`run_job` the same steps over a given mesh, one rank's in the calling
process), the CLIs on the ranks of a group (`run_cli`, the "cli" kind),
the KV-cached samplers over a mesh (`sample_job`, the "sample_decoder" and
"sample_prior" kinds), every kernel
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

The nearest-codebook codes of a VQ-CPC or student step are held the same
way, but only at near ties: a row whose best and second-best squared
distances, in the recorded run, lie within CODE_TIE_REL of the sums that
make them (`search_margins`; a bf16 step where the attention kernels
take bf16 dots) may take the other code over rounding and is held to the
recorded one; any other row whose code differs is reported,
not pinned.
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


# a nearest-codebook row is a near tie when its best and second-best squared
# distances differ by at most this share of |x|^2 + the largest |e|^2 (f32
# rounding; payload["code_tie"]); BF16_STEP, one bf16 step, is the rounding
# of a run whose attention kernels round their dot inputs to bf16, for its
# code ties and its ReLU pins (payload["relu_rel"])
CODE_TIE_REL = 1e-5
BF16_STEP = 2.0 ** -8


def search_margins(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """x (N, K, d) search inputs, codebooks (K, S, d) -> (N, K) float64: the
    gap between the best and the second-best squared distance, over |x|^2 +
    the largest |e|^2 of the sub-codebook (the size of the f32 sums the
    kernel compares)."""
    x, cb = x.double(), codebooks.double()
    x2 = (x * x).sum(-1)                                     # (N, K)
    e2 = (cb * cb).sum(-1)                                   # (K, S)
    d2 = x2[..., None] - 2.0 * torch.einsum("nkd,ksd->nks", x, cb) + e2[None]
    two = d2.topk(2, dim=-1, largest=False).values
    return (two[..., 1] - two[..., 0]) / (x2 + e2.amax(-1)[None]).clamp_min(1e-30)


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
    """Train a DecoderTrainer, a PriorTrainer, a VQCPCEncoderTrainer or a
    StudentEncoderTrainer over a (world / num_model, num_model) mesh of the
    group (run_job) and report what rank 0 sees; other ranks return their
    losses, launches, masked indices, init codebooks and pins' numbers only.
    A list of payloads runs each in turn and returns the list of results."""
    if isinstance(payload, list):
        return [train_over_mesh(rank, world_size, job) for job in payload]
    if payload["kind"] == "cli":
        return run_cli(payload)
    from vqcpcb_tpu_torch.parallel.mesh import make_mesh
    if payload["kind"].startswith("sample_"):
        return with_env(payload.get("env", {}),
                        lambda: sample_job(payload, make_mesh(payload["num_model"])))
    result = with_env(payload.get("env", {}),
                      lambda: run_job(payload, make_mesh(payload["num_model"]),
                                      payload.get("relu_pins")))
    if rank == 0:
        return result
    return {k: result[k] for k in ("launches", "losses", "flips", "pin_gap",
                                   "masked", "init_codebooks", "buffers", "codes",
                                   "code_flips", "code_faults", "code_flip_margin")
            if k in result}


def run_cli(payload: Dict) -> Dict:
    """A CLI's main(payload["argv"]) on this rank of the group (payload
    ["cli"]: "main_encoder", "main_decoder" or "main_prior"), in
    payload["workdir"] (models/ lands there), the corpus caches under
    payload["cache_root"]; returns {"exit": its exit code, "coordinator":
    the VQCPCB_COORDINATOR this rank started from}."""
    import importlib
    from vqcpcb_tpu_torch.data import dataset
    cli = importlib.import_module(f"vqcpcb_tpu_torch.{payload['cli']}")
    saved_cwd, saved_root = os.getcwd(), dataset.DEFAULT_CACHE_ROOT
    os.chdir(payload["workdir"])
    dataset.DEFAULT_CACHE_ROOT = payload["cache_root"]
    try:
        return {"exit": cli.main(payload["argv"]),
                "coordinator": os.environ.get("VQCPCB_COORDINATOR")}
    finally:
        os.chdir(saved_cwd)
        dataset.DEFAULT_CACHE_ROOT = saved_root


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


def build_trainer(payload: Dict, mesh, device: torch.device):
    """The payload's trainer over `mesh`, its state initialised, and the
    module whose gradients are reported."""
    kind = payload["kind"]
    if kind in ("decoder", "prior"):
        if kind == "decoder":
            from vqcpcb_tpu_torch.training.decoder_trainer import DecoderTrainer as cls
        else:
            from vqcpcb_tpu_torch.training.prior_trainer import PriorTrainer as cls
        trainer = cls(payload["encoder"], payload["model"], payload["codebook_size"],
                      device=device, model_dir=payload.get("model_dir"), mesh=mesh)
        trainer.init_state(payload["lr"])
        return trainer, trainer.decoder if kind == "decoder" else trainer.prior
    common = dict(device=device, model_dir=payload.get("model_dir"), mesh=mesh,
                  local_batches=payload.get("local", False))
    if kind == "vqcpc":
        from vqcpcb_tpu_torch.training.encoder_trainer import VQCPCEncoderTrainer
        trainer = VQCPCEncoderTrainer(payload["model"], **common)
    else:
        from vqcpcb_tpu_torch.training.student_trainer import StudentEncoderTrainer
        encoder, teacher, auxiliary_decoder = payload["model"]
        trainer = StudentEncoderTrainer(
            encoder, teacher, auxiliary_decoder, payload["num_events_masked"],
            payload["quantization_weighting"], **common)
    trainer.init_state(_rows(payload, payload["batches"][0], mesh), payload["lr"],
                       perms=payload.get("perms"),
                       initialize=payload.get("initialize", True))
    return trainer, trainer.model


def _rows(payload: Dict, batch, mesh):
    """The batch a step is given: the global one, or with payload["local"]
    this rank's rows only (per-rank feeding)."""
    if not payload.get("local"):
        return batch
    from vqcpcb_tpu_torch.parallel.mesh import shard_batch
    return shard_batch(batch, mesh)


def _quantizer(trainer):
    model = trainer.model
    return (model.encoder if hasattr(model, "bidirectional") else model["encoder"]).quantizer


def _floats(metrics: Dict) -> Dict:
    return {k: v.tolist() if v.dim() else float(v) for k, v in metrics.items()}


def run_job(payload: Dict, mesh, relu_pins: Optional[List] = None,
            record: bool = False) -> Dict:
    """Train one payload's trainer over `mesh` (a one-rank Mesh(1, 1) for a
    reference in the calling process).

    payload: kind ("decoder", "prior", "vqcpc" or "student"), model (a
    module with the full weights, the same on every rank; for the student
    (encoder, teacher, auxiliary decoder)), batches (global batches, one a
    step: token arrays, or the VQ-CPC's dicts), lr, device ("cpu", or
    "cuda": every rank on the current card), num_model, env (variables set
    while the job runs); the decoder and the prior also encoder and
    codebook_size; the student num_events_masked and quantization_weighting;
    optional: model_dir (rank 0 saves the overfitted slot there after the
    steps), eval_batch, local (the VQ-CPC and the student: each rank is given
    only its rows), initialize and perms (their init_state's; initialize
    defaults to True), masked_event_index (the student's, in place of its
    draws), relu_pins (a ReluPins recording of one rank's first
    step on the same batch: this run's first step holds its ReLU masks to
    it); record: record this run's first step's ReLU pre-activations near
    zero instead (within payload["relu_rel"] of each call's max |h|,
    default 1e-4).

    Returns {"losses" (one a step; the student's teacher + encoder-decoder
    loss), "metrics" (every metric of each step), "grads" (the first step's
    clipped gradients, gathered to the one-GPU layout, by name),
    "eval_loss", "launches" (counted over the steps), "seconds" (the steps,
    synchronised), "flips" and "pin_gap" (ReluPins' counts and largest gap)
    or "pins" (recording)}; the VQ-CPC and the student also
    "init_codebooks" (after init_state), "buffers" (the quantizer's buffers
    after each step: BatchNorm's running statistics, the EMA codebooks,
    cluster_size and ema_sums), with payload["record_codes"] "codes" (each
    nearest-codebook search of the first step: (x, codebooks, this run's
    own codes, their search_margins) on the CPU) and, given
    payload["code_pins"] (a recorded run's (codes, margins) of those
    searches, on the whole batch), "code_flips" (by search, the rows whose
    codes differed from the recording's at a near tie, margin <=
    payload["code_tie"] (default CODE_TIE_REL), and were held to them, as ReluPins holds the ReLU masks)
    and "code_faults" (by search, the rows whose codes differed elsewhere,
    not held), "code_flip_margin" (the largest recorded margin of a row
    whose code differed, 0 if none) and, the student, "masked" (the masked event of each
    step)."""
    from vqcpcb_tpu_torch.parallel.mesh import gather_tensor, module_specs
    device = torch.device(payload["device"])
    kind = payload["kind"]
    trainer, module = build_trainer(payload, mesh, device)
    encoder_side = kind in ("vqcpc", "student")
    result = {}
    if encoder_side:
        result["init_codebooks"] = _quantizer(trainer).state_dict()
        result["init_codebooks"] = {k: v.detach().cpu().clone()
                                    for k, v in result["init_codebooks"].items()
                                    if "embeddings" in k or k == "codebooks"}
    searched, code_flips, code_faults, flip_margins = [], [], [], []
    code_pins = payload.get("code_pins")
    if payload.get("record_codes"):
        quantizer = _quantizer(trainer)
        search = quantizer.search

        def recording(x, codebooks):
            codes = search(x, codebooks)
            if grads is not None:                    # the first step's only
                return codes
            searched.append((x.cpu(), codebooks.cpu(), codes.cpu(),
                             search_margins(x, codebooks).cpu()))
            if code_pins is None:
                return codes
            # this rank's rows of the recorded run's codes and margins
            pinned, margins = (t.to(codes.device) for t in code_pins[len(searched) - 1])
            if len(pinned) != len(codes):
                mine = slice(mesh.data_index * len(codes),
                             (mesh.data_index + 1) * len(codes))
                pinned, margins = pinned[mine], margins[mine]
            flip = pinned != codes
            tie = flip & (margins <= payload.get("code_tie", CODE_TIE_REL))
            code_flips.append(int(tie.any(-1).sum()))
            code_faults.append(int((flip & ~tie).any(-1).sum()))
            flip_margins.append(margins[flip].max().item() if flip.any() else 0.0)
            return torch.where(tie, pinned, codes)
        quantizer.search = recording
    before = launch_counts()
    losses, metrics, masked, grads, pins = [], [], [], None, None
    buffers = []
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    fixed = ({"masked_event_index": payload["masked_event_index"]}
             if payload.get("masked_event_index") is not None else {})
    for batch in payload["batches"]:
        step = lambda: trainer.train_step(_rows(payload, batch, mesh), **fixed)  # noqa: E731
        if grads is None and (record or relu_pins is not None):
            pins = (ReluPins(rel=payload.get("relu_rel", 1e-4)) if record else
                    ReluPins(relu_pins, (mesh.data_index, mesh.n_data),
                             (mesh.model_index, mesh.n_model)))
            with pins:
                out = step()
        else:
            out = step()
        metrics.append(_floats(out))
        losses.append(metrics[-1]["loss_teacher"] + metrics[-1]["loss_encdec"]
                      if kind == "student" else metrics[-1]["loss"])
        if kind == "student":
            masked.append(int(trainer.masked_event_index))
        if encoder_side:
            buffers.append({k: v.detach().cpu().clone()
                            for k, v in _quantizer(trainer).named_buffers()})
        if grads is None:
            specs = module_specs(module)
            grads = {name: gather_tensor(
                         torch.zeros_like(p) if p.grad is None else p.grad,
                         specs.get(name), mesh).cpu()
                     for name, p in module.named_parameters()}
    sync()
    seconds = time.perf_counter() - t0
    after = launch_counts()
    result.update(losses=losses, metrics=metrics, grads=grads, seconds=seconds,
                  launches={k: after[k] - before[k] for k in after})
    if encoder_side:
        result["buffers"] = buffers
    if payload.get("record_codes"):
        quantizer.search = search
        result["codes"] = searched
        if code_pins is not None:
            result.update(code_flips=code_flips, code_faults=code_faults,
                          code_flip_margin=max(flip_margins, default=0.0))
    if kind == "student":
        result["masked"] = masked
    if pins is not None and record:
        result["pins"] = pins.pins
    elif pins is not None:
        result.update(flips=pins.flips, pin_gap=pins.gap)
    if payload.get("eval_batch") is not None:
        out = trainer.eval_step(_rows(payload, payload["eval_batch"], mesh))
        result["eval_loss"] = float(out["loss_monitor" if kind == "student"
                                        else "loss"])
    if payload.get("model_dir"):
        trainer.save(early_stopped=False)
    return result


# ---- the samplers over a mesh ------------------------------------------------------

def sample_job(payload: Dict, mesh, record: bool = False) -> Dict:
    """One sampling call over `mesh` (a one-rank Mesh(1, 1) for a reference
    in the calling process), every rank making it with its rows of the
    global batch (parallel/mesh.generation_rows) and a generator seeded
    seed + data_index, which parallel/collectives.common_generator puts in
    rank 0's state on every rank, as the trainers' generation does.

    payload: kind "sample_decoder" (model a Decoder; source, the global
    codes, or encoder and templates, the global token batch each rank
    encodes its rows of with K1 as DecoderGenerator.encode_codes does;
    tokens_init, start, num_steps, top_p) or "sample_prior" (model a
    PriorRelative; x_init, start, num_steps: one sample_window; or encoder,
    codebook_size and num_codes: PriorTrainer.generate_codes of
    len(x_init) rows); temperature, top_k, seed, device, num_model, env.
    The model is moved to the device and sharded over the mesh (its full
    weights are the same on every rank).

    Returns {"tokens" (the global batch, gathered), "local" (this rank's
    rows), "codes" (the encoded source, where encoded), "launches",
    "seconds" (synchronised), "rows" ((start, stop, total)), "cache_heads"
    (each attention's, as sharded; the prior's codes run: unsharded)} and, with
    record, "margins": each draw's top-two logit margin over the logits'
    largest |value|, (B, draws) in draw order, on the CPU, and where the
    source was encoded "code_margins": each row's smallest nearest-codebook
    margin (search_margins) over its codes, (B,)."""
    import copy

    import numpy as np
    from vqcpcb_tpu_torch.models import decoder as decoder_module
    from vqcpcb_tpu_torch.models import prior as prior_module
    from vqcpcb_tpu_torch.parallel.collectives import common_generator, gather_rows
    from vqcpcb_tpu_torch.parallel.mesh import generation_rows, shard_params
    from vqcpcb_tpu_torch.training.decoder_trainer import encode_source
    from vqcpcb_tpu_torch.training.prior_trainer import PriorTrainer
    device = torch.device(payload["device"])
    model = copy.deepcopy(payload["model"]).to(device).eval()
    if "num_codes" not in payload:             # PriorTrainer shards its own
        model = shard_params(model, mesh)
    generator = torch.Generator(device=device).manual_seed(
        payload.get("seed", 0) + mesh.data_index)
    batch = payload["x_init"] if "x_init" in payload else payload["tokens_init"]
    rows = generation_rows(len(batch), mesh)
    margins, code_margins = [], []
    module = decoder_module if payload["kind"] == "sample_decoder" else prior_module
    sample = module.sample_categorical
    if record:
        def recording(gen, logits, *args, **kwargs):
            finite = logits.masked_fill(~torch.isfinite(logits), 0.0)
            top = logits.float().topk(2, dim=-1).values
            scale = finite.float().abs().amax(-1).clamp_min(1e-30)
            margins.append(((top[:, 0] - top[:, 1]) / scale).cpu())
            return sample(gen, logits, *args, **kwargs)
        module.sample_categorical = recording
    before = launch_counts()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    codes = None
    try:
        if payload["kind"] == "sample_decoder":
            source = payload.get("source")
            if source is None:
                encoder = copy.deepcopy(payload["encoder"]).to(device).eval()
                if record:
                    search = encoder.quantizer.search

                    def recording_search(x, codebooks):
                        code_margins.append(search_margins(x, codebooks).cpu())
                        return search(x, codebooks)
                    encoder.quantizer.search = recording_search
                with torch.no_grad():
                    local = encode_source(encoder, torch.as_tensor(
                        rows.of(payload["templates"]), device=device),
                        payload["codebook_size"])
                codes = gather_rows(local, rows, mesh)
                source = codes
            out = model.sample_range(
                rows.of(source), rows.of(payload["tokens_init"]), payload["start"],
                payload["num_steps"], common_generator(generator, mesh),
                temperature=payload.get("temperature", 1.0),
                top_k=payload.get("top_k", 0), top_p=payload.get("top_p", 0.0),
                device=device, rows=rows)
        elif "num_codes" in payload:
            trainer = PriorTrainer(copy.deepcopy(payload["encoder"]), model,
                                   payload["codebook_size"], device=device,
                                   seed=payload.get("seed", 0), mesh=mesh)
            whole = trainer.generate_codes(
                payload["num_codes"], len(batch),
                temperature=payload.get("temperature", 1.0),
                top_k=payload.get("top_k", 0))
            out = torch.as_tensor(rows.of(whole))
        else:
            out = model.sample_window(
                rows.of(payload["x_init"]), payload["start"], payload["num_steps"],
                common_generator(generator, mesh),
                temperature=payload.get("temperature", 1.0),
                top_k=payload.get("top_k", 0), device=device, rows=rows)
        tokens = gather_rows(out.to(device), rows, mesh)
        sync()
    finally:
        module.sample_categorical = sample
    seconds = time.perf_counter() - t0
    after = launch_counts()
    result = {"tokens": tokens.cpu().numpy(), "local": out.cpu().numpy(),
              "codes": None if codes is None else codes.cpu().numpy(),
              "launches": {k: after[k] - before[k] for k in after},
              "seconds": seconds, "rows": (rows.start, rows.stop, rows.total),
              "cache_heads": [m.cache_heads for m in model.modules()
                              if hasattr(m, "cache_heads")]}
    if record:
        result["margins"] = torch.stack(margins, -1).numpy() if margins else np.zeros(0)
        if code_margins:
            result["code_margins"] = torch.cat(code_margins).reshape(
                len(batch), -1).amin(-1).numpy()
    return result


def token_ties(got, want, margins, start: int, tie_rel: float,
               skip_rows=()) -> Dict:
    """Rows of a sampled batch against a recorded run's (flat positions
    [start, start + draws) sampled in order, `margins` the recorded run's
    (B, draws), sample_job's): a row whose first differing position is a
    near tie there (margin <= tie_rel) is "tied"; any other differing row is
    a "fault"; rows in skip_rows (whose source differed at a near tie) are
    left out. Returns {"rows", "tied", "faults", "equal_share" (of the
    sampled tokens), "tie_margin" (the largest margin at a tied row's first
    difference)}."""
    import numpy as np
    got = np.asarray(got).reshape(len(got), -1)
    want = np.asarray(want).reshape(len(want), -1)
    draws = margins.shape[1]
    got_s, want_s = got[:, start:start + draws], want[:, start:start + draws]
    tied, faults, tie_margin = [], [], 0.0
    for row in np.nonzero((got != want).any(-1))[0]:
        if row in skip_rows:
            continue
        first = int(np.argmax(got_s[row] != want_s[row]))
        if (got_s[row] == want_s[row]).all() or margins[row, first] > tie_rel:
            faults.append(int(row))
        else:
            tied.append(int(row))
            tie_margin = max(tie_margin, float(margins[row, first]))
    return {"rows": len(got), "tied": tied, "faults": faults,
            "equal_share": float((got_s == want_s).mean()), "tie_margin": tie_margin}
