"""The run's environment: fixed cache directories inside the checkout, the
program's switches cleared, the card checked, its name and limits read.

`prepare` runs before torch is imported."""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# compile caches of the program and its libraries, at fixed paths inside the
# checkout (the port's own nvcc outputs land in build/kernels/ by itself)
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions",
              "TRITON_CACHE_DIR": ROOT / "build" / "triton"}
# packages whose presence in a run's process is refused, by top-level name
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "vqcpcb_tpu")


def process_start_time() -> float:
    """The epoch time this process started, from /proc (Linux); the import
    time of this module where /proc cannot say."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        for line in Path("/proc/stat").read_text().splitlines():
            if line.startswith("btime "):
                return int(line.split()[1]) + start_ticks / ticks
    except (OSError, ValueError, IndexError):
        pass
    return _IMPORTED


_IMPORTED = time.time()


def prepare() -> None:
    """Fixed cache directories, no switch of the program left set, the
    checkout on the import path, few host threads."""
    for key, path in CACHE_DIRS.items():
        os.environ[key] = str(path)
    for key in [k for k in os.environ if k.startswith("VQCPCB_")]:
        del os.environ[key]
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def card_or_exit(chips: int) -> str:
    """The card's name; exits 1 with no result when CUDA or the cell's
    chips are missing."""
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("portbench: CUDA is not available; no result\n")
        sys.exit(1)
    if torch.cuda.device_count() < chips:
        sys.stderr.write(f"portbench: {torch.cuda.device_count()} cards, the "
                         f"cell needs {chips}; no result\n")
        sys.exit(1)
    return torch.cuda.get_device_name(0)


def strict_f32() -> None:
    """f32 products in f32: TF32 off for matmuls and cuDNN."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)


def smi() -> str:
    """nvidia-smi's name, power limit, clocks and temperature, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name is a forbidden package's."""
    roots = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(roots & set(FORBIDDEN_MODULES))
