"""ctypes bindings of the native host-pipeline routines (tokenizer.cpp, a
copy of vqcpcb_tpu/native/tokenizer.cpp): `part_to_ticks_native`,
`extract_windows_native` and `build_negatives_same_seq_native`, called by
data/tokenizer.py and data/dataloaders.py where the JAX package calls its
own (vqcpcb_tpu/data/tokenizer.py:104-109, :215-222;
vqcpcb_tpu/data/dataloaders.py:297-312).

The library is built at its first use with `g++ -O3 -shared -fPIC` into
`build/native/` at the root of the checkout (git-ignored), named by a hash
of the source and the flags, so an edited source is rebuilt and an
unchanged one reused; nothing is built at import time. The knobs are read
where JAX reads them (vqcpcb_tpu/native/__init__.py): VQCPCB_NATIVE=0
selects the NumPy paths, and VQCPCB_NATIVE_LIB names a prebuilt library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

import numpy as np

SOURCE = Path(__file__).resolve().parent / "tokenizer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

# Loaded libraries for the life of the process, by VQCPCB_NATIVE_LIB's
# value ("" for this source's build): the data layer calls the routines
# tens of thousands of times a corpus, so a call touches no file
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def enabled() -> bool:
    """Whether the data layer takes the native routines: unless
    VQCPCB_NATIVE=0 (vqcpcb_tpu/native/__init__.py:64)."""
    return os.environ.get("VQCPCB_NATIVE", "1") != "0"


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libvqcpcb_native-{digest[:16]}.so"


def build() -> Path:
    """Compile tokenizer.cpp unless this source's library exists; returns
    its path.

    Where the JAX package returns None on a failed build and its callers
    fall back to NumPy without a word (vqcpcb_tpu/native/__init__.py:53-54,
    66-69), this raises with the compiler's message: a run that should take
    the native routines does not silently take the slower path. Set
    VQCPCB_NATIVE=0 to take the NumPy paths on purpose."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"the native tokenizer cannot be built: {exc} (set "
                           "VQCPCB_NATIVE=0 for the NumPy paths)") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed building {SOURCE.name} (set "
                           f"VQCPCB_NATIVE=0 for the NumPy paths):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)        # atomic: concurrent builders never see half a file
    return path


def library() -> ctypes.CDLL:
    """The loaded library: VQCPCB_NATIVE_LIB's, or this source's, built at
    its first use in the process."""
    prebuilt = os.environ.get("VQCPCB_NATIVE_LIB", "")
    lib = _LIBS.get(prebuilt)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(prebuilt)
            if lib is None:
                lib = ctypes.CDLL(prebuilt or str(build()))
                _declare(lib)
                _LIBS[prebuilt] = lib
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.part_to_ticks.argtypes = [
        f64p, i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_int32, i32p]
    lib.extract_windows.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int64, i64p, ctypes.c_int64,
        ctypes.c_int64, i32p, i32p, i32p, i32p]
    lib.build_negatives_same_seq.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, i32p]


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def part_to_ticks_native(offsets: np.ndarray, token_index: np.ndarray,
                         length: int, subdivision: int, offset_start: float,
                         slur_index: int) -> np.ndarray:
    """One part's ticks (length,) int32: the articulation loop of
    data/tokenizer.part_to_ticks."""
    offsets = np.ascontiguousarray(offsets, dtype=np.float64)
    token_index = np.ascontiguousarray(token_index, dtype=np.int32)
    if len(token_index) != len(offsets):
        raise ValueError(f"{len(offsets)} offsets for {len(token_index)} tokens")
    out = np.empty((length,), dtype=np.int32)
    library().part_to_ticks(_ptr(offsets, ctypes.c_double),
                            _ptr(token_index, ctypes.c_int32),
                            len(offsets), length, subdivision,
                            float(offset_start), int(slur_index),
                            _ptr(out, ctypes.c_int32))
    return out


def extract_windows_native(grid: np.ndarray, start_ticks: np.ndarray,
                           window_len: int, start_symbols, end_symbols,
                           pad_symbols) -> np.ndarray:
    """(num_windows, num_voices, window_len) int32 windows of a (voices,
    length) grid with START/END/PAD at the edges: data/tokenizer.
    extract_windows_batch."""
    grid = np.ascontiguousarray(grid, dtype=np.int32)
    start_ticks = np.ascontiguousarray(start_ticks, dtype=np.int64)
    num_voices, length = grid.shape
    sym = [np.ascontiguousarray(s, dtype=np.int32)
           for s in (start_symbols, end_symbols, pad_symbols)]
    if any(s.shape != (num_voices,) for s in sym):
        raise ValueError(f"START/END/PAD symbols of shapes "
                         f"{[s.shape for s in sym]} for {num_voices} voices")
    num_windows = len(start_ticks)
    out = np.empty((num_windows, num_voices, window_len), dtype=np.int32)
    library().extract_windows(_ptr(grid, ctypes.c_int32), num_voices, length,
                              _ptr(start_ticks, ctypes.c_int64), num_windows,
                              window_len, *(_ptr(s, ctypes.c_int32) for s in sym),
                              _ptr(out, ctypes.c_int32))
    return out


def build_negatives_same_seq_native(x_left: np.ndarray, x_right: np.ndarray,
                                    blocks_left: int, blocks_right: int,
                                    ticks_block: int) -> np.ndarray:
    """(B, L + R - 1, R, ticks_block, voices) int32 same-sequence negatives:
    data/dataloaders._build_negatives_same_seq."""
    x_left = np.ascontiguousarray(x_left, dtype=np.int32)
    x_right = np.ascontiguousarray(x_right, dtype=np.int32)
    batch, _, voices = x_left.shape
    # the C++ routine indexes raw pointers: the claimed geometry is checked
    # against the arrays before they are handed over (JAX's checks,
    # vqcpcb_tpu/native/__init__.py:131-140; a mismatch would read out of
    # bounds)
    if x_left.shape[1] != blocks_left * ticks_block:
        raise ValueError((x_left.shape, blocks_left, ticks_block))
    if x_right.shape[1] != blocks_right * ticks_block:
        raise ValueError((x_right.shape, blocks_right, ticks_block))
    if x_right.shape[0] != batch or x_right.shape[2] != voices:
        raise ValueError((x_left.shape, x_right.shape))
    num_neg = blocks_left + blocks_right - 1
    out = np.empty((batch, num_neg, blocks_right, ticks_block, voices),
                   dtype=np.int32)
    library().build_negatives_same_seq(
        _ptr(x_left, ctypes.c_int32), _ptr(x_right, ctypes.c_int32),
        batch, blocks_left, blocks_right, ticks_block, voices,
        _ptr(out, ctypes.c_int32))
    return out
