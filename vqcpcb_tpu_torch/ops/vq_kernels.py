"""Nearest-codebook search (counterpart of vqcpcb_tpu/ops/pallas_vq.py).

`nearest_codebook_indices` routes by device: a CPU tensor takes the plain
PyTorch version, a CUDA tensor launches the hand-written kernel
(csrc/vq_nearest.cu) or raises. Both compute argmin_s |x|^2 - 2 x.e_s + |e_s|^2
in f32 per sub-codebook, ties to the lowest index.
"""
from __future__ import annotations

import ctypes

import torch

from vqcpcb_tpu_torch.ops import _build

# Launches of the CUDA kernel since the last reset (a plain counter: a run
# sets it to 0, drives the model and reads it back).
launches = 0


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
    lib = _build.library("vq_nearest")
    if not getattr(lib, "_typed", False):
        lib.vq_nearest_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.vq_nearest_launch.restype = ctypes.c_int
        lib.vq_nearest_max_dim.argtypes = []
        lib.vq_nearest_max_dim.restype = ctypes.c_int
        lib.vq_empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.vq_empty_launch.restype = ctypes.c_int
        lib.vq_io_floor_launch.argtypes = lib.vq_nearest_launch.argtypes
        lib.vq_io_floor_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def nearest_codebook_indices_cuda(x: torch.Tensor,
                                  codebooks: torch.Tensor) -> torch.Tensor:
    """Launch csrc/vq_nearest.cu on contiguous f32 CUDA tensors."""
    global launches
    n, k, d = x.shape
    if codebooks.dim() != 3 or codebooks.shape[0] != k or codebooks.shape[2] != d:
        raise ValueError(f"codebooks {tuple(codebooks.shape)} do not match x "
                         f"{tuple(x.shape)}: want (K, S, d)")
    for name, t in (("x", x), ("codebooks", codebooks)):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA tensor "
                             f"(got {t.dtype} on {t.device}, contiguous="
                             f"{t.is_contiguous()})")
    if codebooks.device != x.device:
        raise ValueError("x and codebooks lie on different devices")
    lib = _lib()
    if d > lib.vq_nearest_max_dim():
        raise ValueError(f"sub-codebook dim {d} > {lib.vq_nearest_max_dim()}")
    out = torch.empty((n, k), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(lib.vq_nearest_launch(x.data_ptr(), codebooks.data_ptr(),
                                       out.data_ptr(), n, k, codebooks.shape[1],
                                       d, stream), "vq_nearest")
    launches += 1
    return out


def launch_floor_cuda(n: int, k: int, device: torch.device) -> None:
    """Launch an empty kernel on nearest_codebook_indices_cuda's grid for
    (n, k) rows: the launch's own cost at that shape, timed beside the
    kernel. Not counted in `launches`."""
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(_lib().vq_empty_launch(n, k, stream), "vq_empty")


def io_floor_cuda(x: torch.Tensor, codebooks: torch.Tensor,
                  out: torch.Tensor) -> None:
    """Launch, on nearest_codebook_indices_cuda's grid, a kernel that only
    loads x's rows and the codebook and writes one int per row into out
    (N, K) int32: the floor of any kernel that must read both before it
    stores an index. Its values mean nothing. Not counted in `launches`."""
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
