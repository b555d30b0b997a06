"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc for Hopper (sm_90a) into its own
shared library with a plain C interface and loaded with ctypes: no PyTorch
headers are compiled, so a build takes seconds. Libraries land in
`build/kernels/` at the root of the checkout (git-ignored), named by a hash
of the source, the shared headers (`csrc/*.cuh`) and the flags, so an edited
source or header is rebuilt and an unchanged one is reused. The first kernel call builds every missing library, one nvcc
process per source, all started together. A missing or failing nvcc raises:
nothing falls back to the plain PyTorch versions.

Nothing is built or loaded at import time; the CPU tests import this module
on machines without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("vq_nearest", "relbias_attention", "relbias_attention_bwd",
           "fused_attention", "fused_attention_bwd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Loaded libraries, one per source, for the life of the process (a shared
# library is loaded once per process whatever owns the handle).
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all() -> Dict[str, float]:
    """Compile every missing library in parallel; returns wall seconds per
    source (0.0 for one already built). Raises with nvcc's output on a
    failed build. The ptxas report (registers, shared memory, spills) is
    kept beside each library as `<library>.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in SOURCES:
        target = library_path(name)
        if target.exists():
            seconds[name] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        target.with_suffix(".so.log").write_text(out)
        os.replace(tmp, target)   # atomic: concurrent builders never see half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not library_path(name).exists():
                build_all()
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a kernel's C launcher."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
