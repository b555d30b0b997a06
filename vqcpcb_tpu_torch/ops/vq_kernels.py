"""Nearest-codebook search (counterpart of vqcpcb_tpu/ops/pallas_vq.py).

`nearest_codebook_indices` routes by device: a CPU tensor takes the plain
PyTorch version, a CUDA tensor launches a hand-written kernel
(csrc/vq_nearest.cu) or raises. Both compute argmin_s |x|^2 - 2 x.e_s + |e_s|^2
in f32 per sub-codebook, ties to the lowest index. On the card the shape
alone picks the kernel: a compiled instance for (d, S) = (3, 32) or (8, 16),
the run-time kernel for any other shape; the two give the same indices bit
for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vqcpcb_tpu_torch.ops import _build

# The compiled instances of csrc/vq_nearest.cu by (d, S); every other shape
# takes the run-time kernel. _CODES: each kernel's `instance` code in the C
# launcher.
INSTANCES = {(3, 32): "d3_s32", (8, 16): "d8_s16"}
_CODES = {"runtime": 0, "d3_s32": 1, "d8_s16": 2}

# Launches of the CUDA kernels since the last reset (a plain counter: a run
# sets it to 0, drives the model and reads it back), in all and by kernel.
launches = 0
launches_by_kind = dict.fromkeys(_CODES, 0)

# The launcher, typed once, and the run-time kernel's largest d.
_launch = None
_max_dim = 0


def nearest_codebook_indices_plain(x: torch.Tensor,
                                   codebooks: torch.Tensor) -> torch.Tensor:
    """x: (N, K, d), codebooks: (K, S, d) -> (N, K) int32; the same formula in
    the same order as the kernel (vqcpcb_tpu/ops/pallas_vq.py:_xla_indices)."""
    x = x.float()
    codebooks = codebooks.float()
    x2 = (x * x).sum(-1, keepdim=True)                       # (N, K, 1)
    e2 = (codebooks * codebooks).sum(-1)                     # (K, S)
    xe = torch.einsum("nkd,ksd->nks", x, codebooks)
    return torch.argmin(x2 - 2.0 * xe + e2[None], dim=-1).to(torch.int32)


def _lib():
    global _launch, _max_dim
    lib = _build.library("vq_nearest")
    if _launch is None:
        lib.vq_nearest_max_dim.argtypes = []
        lib.vq_nearest_max_dim.restype = ctypes.c_int
        lib.vq_empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.vq_empty_launch.restype = ctypes.c_int
        lib.vq_io_floor_launch.argtypes = ([ctypes.c_void_p] * 3
                                           + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.vq_io_floor_launch.restype = ctypes.c_int
        _max_dim = lib.vq_nearest_max_dim()
        launch = lib.vq_nearest_launch
        launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        launch.restype = ctypes.c_int
        _launch = launch
    return lib


def kernel_kind(d: int, s: int) -> str:
    """The kernel that csrc/vq_nearest.cu runs for sub-codebooks of S codes of
    dimension d: a compiled instance, else the run-time kernel."""
    return INSTANCES.get((d, s), "runtime")


def nearest_codebook_indices_cuda(x: torch.Tensor, codebooks: torch.Tensor,
                                  kind: Optional[str] = None) -> torch.Tensor:
    """Launch csrc/vq_nearest.cu on contiguous f32 CUDA tensors: the kernel
    that kernel_kind picks by shape, or the one `kind` names ("runtime" runs
    every shape; an instance only its own)."""
    global launches
    n, k, d = x.shape
    s = codebooks.shape[1] if codebooks.dim() == 3 else 0
    if not (codebooks.dim() == 3 and codebooks.shape[0] == k
            and codebooks.shape[2] == d and x.is_cuda
            and x.dtype == codebooks.dtype == torch.float32
            and x.device == codebooks.device
            and x.is_contiguous() and codebooks.is_contiguous()):
        _reject(x, codebooks)
    kind = kernel_kind(d, s) if kind is None else kind
    if _launch is None:
        _lib()
    if kind not in _CODES or (kind != "runtime" and INSTANCES.get((d, s)) != kind):
        raise ValueError(f"no K1 kernel {kind!r} for d = {d}, S = {s}")
    if kind == "runtime" and d > _max_dim:
        raise ValueError(f"sub-codebook dim {d} > {_max_dim}")
    out = torch.empty((n, k), dtype=torch.int32, device=x.device)
    _build.check(_launch(x.data_ptr(), codebooks.data_ptr(), out.data_ptr(),
                         n, k, s, d, _CODES[kind],
                         torch._C._cuda_getCurrentRawStream(x.get_device())),
                 "vq_nearest")
    launches += 1
    launches_by_kind[kind] += 1
    return out


def _reject(x: torch.Tensor, codebooks: torch.Tensor) -> None:
    """Raise naming what nearest_codebook_indices_cuda does not take."""
    if codebooks.dim() != 3 or codebooks.shape[0] != x.shape[1] \
            or codebooks.shape[2] != x.shape[2]:
        raise ValueError(f"codebooks {tuple(codebooks.shape)} do not match x "
                         f"{tuple(x.shape)}: want (K, S, d)")
    for name, t in (("x", x), ("codebooks", codebooks)):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor "
                             f"(got {t.dtype} on {t.device}, contiguous="
                             f"{t.is_contiguous()})")
    raise ValueError("x and codebooks lie on different devices")


def launch_floor_cuda(n: int, k: int, device: torch.device) -> None:
    """Launch an empty kernel on the run-time kernel's grid (256 rows a
    block) for (n, k) rows: a launch's own cost at that shape, timed beside
    the kernel. Not counted in `launches`."""
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(_lib().vq_empty_launch(n, k, stream), "vq_empty")


def io_floor_cuda(x: torch.Tensor, codebooks: torch.Tensor,
                  out: torch.Tensor) -> None:
    """Launch, on the run-time kernel's grid (256 rows a block), a kernel
    that only loads x's rows and the codebook and writes one int per row
    into out (N, K) int32: the floor of any kernel that must read both
    before it stores an index. Its values mean nothing. Not counted in
    `launches`."""
    n, k, d = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(_lib().vq_io_floor_launch(
        x.data_ptr(), codebooks.data_ptr(), out.data_ptr(), n, k,
        codebooks.shape[1], d, stream), "vq_io_floor")


def nearest_codebook_indices(x: torch.Tensor,
                             codebooks: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour indices per sub-codebook.

    x: (N, K, d_sub); codebooks: (K, S, d_sub) -> (N, K) int32. The plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return nearest_codebook_indices_plain(x, codebooks)
    return nearest_codebook_indices_cuda(x, codebooks)
