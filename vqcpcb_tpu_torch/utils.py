"""Cross-cutting helpers (counterpart of vqcpcb_tpu/utils.py)."""
from __future__ import annotations

import contextlib
import importlib.util
import os
import sys
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch


def flatten(x: torch.Tensor) -> torch.Tensor:
    """(batch, num_events, num_channels, ...) -> (batch, num_events*num_channels, ...)

    with channels varying fastest (vqcpcb_tpu/utils.py:16)."""
    b, e, c = x.shape[:3]
    return x.reshape((b, e * c) + tuple(x.shape[3:]))


def unflatten(sequence: torch.Tensor, num_channels: int) -> torch.Tensor:
    """(batch, num_events*num_channels, ...) -> (batch, num_events, num_channels, ...)
    (vqcpcb_tpu/utils.py:25)."""
    b, s = sequence.shape[:2]
    if s % num_channels:
        raise ValueError(f"length {s} is not a multiple of {num_channels}")
    return sequence.reshape((b, s // num_channels, num_channels)
                            + tuple(sequence.shape[2:]))


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout whose mask is drawn from `generator` (torch's default
    generator of x's device when None): each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate), as flax's nn.Dropout
    does. The identity outside training or at rate 0.

    On CUDA this is torch's fused dropout kernel, one launch forward and one
    backward as nn.Dropout's, through `torch._fused_dropout`, the variant
    that takes a generator (it has no CPU kernel); on the CPU, a mask from
    torch.rand."""
    if not training or rate == 0.0:
        return x
    if x.is_cuda:
        return torch._fused_dropout(x, 1.0 - rate, generator)[0]
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep / (1.0 - rate)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """Entry-point device rule: the card unless the caller names another.

    None means CUDA; without CUDA that raises rather than falling back to
    the CPU, so a run that was meant for the card cannot silently measure
    the CPU. Pass device="cpu" to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def module_device(module: torch.nn.Module, device=None) -> torch.device:
    """The device `module` lives on, which must be `device` under
    resolve_device's rule (the card unless the caller names another); a
    sampler runs there rather than moving the module."""
    device = resolve_device(device)
    here = next(module.parameters()).device
    if here.type != device.type or (device.index is not None and here != device):
        raise ValueError(f"the {type(module).__name__} lives on {here}, not "
                         f"{device}; move it with .to(device)")
    return here


def to_device(x, device: torch.device) -> torch.Tensor:
    """A tensor, or anything numpy reads (array, list), as a tensor on device."""
    if torch.is_tensor(x):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


# VQCPCB_COMPUTE_DTYPE's values, as vqcpcb_tpu/ops/__init__.py:7 maps them
# (its None, no bf16 compute, is f32); any other value is f32 too
_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                   "": torch.float32}


def compute_dtype(default: torch.dtype) -> torch.dtype:
    """The dtype a decoder trainer computes in: `default` while
    VQCPCB_COMPUTE_DTYPE is unset; otherwise the variable wins, even as '',
    as in JAX (ops/__init__.py:16-31): 'bfloat16' is bf16, '', 'float32' and
    any other value f32."""
    env = os.environ.get("VQCPCB_COMPUTE_DTYPE")
    if env is None:
        return default
    return _COMPUTE_DTYPES.get(env, torch.float32)


# the innermost default_compute_dtype scope's dtype (JAX's _scoped_default)
_scoped_default = [torch.float32]


@contextlib.contextmanager
def default_compute_dtype(dtype: torch.dtype) -> Iterator[None]:
    """Runs the block with `dtype` as the transformer stacks' compute dtype
    unless VQCPCB_COMPUTE_DTYPE says otherwise (ops/__init__.py:34): the
    decoder trainer's steps run in one, bf16 on CUDA."""
    prev = _scoped_default[0]
    _scoped_default[0] = dtype
    try:
        yield
    finally:
        _scoped_default[0] = prev


def layer_compute_dtype() -> torch.dtype:
    """The dtype the transformer stacks' dense layers compute in (the
    attention projections, the feed-forward linears and the decoder's
    output heads in training), read at each call as JAX reads its
    compute_dtype() at each trace: VQCPCB_COMPUTE_DTYPE when set, else the
    innermost default_compute_dtype scope, else f32. Every other layer
    (embeddings, the downscalers' and the prior's own linears, GRUs, the
    upscaler, the quantizer, the losses) computes in f32 whatever this
    says, as in JAX."""
    return compute_dtype(_scoped_default[0])


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor]) -> torch.Tensor:
    """F.linear in layer_compute_dtype. Under bf16 it is flax's
    Dense(dtype=bfloat16): x, the weight and the bias cast to bf16, the
    product rounded to bf16, then the bias added in bf16 (two roundings, as
    XLA has them); the parameters stay f32 (their gradients come back
    through the casts in f32)."""
    dt = layer_compute_dtype()
    if dt == torch.float32:
        return torch.nn.functional.linear(x, weight, bias)
    y = torch.nn.functional.linear(x.to(dt), weight.to(dt))
    return y if bias is None else y + bias.to(dt)


def kv_cache_dtype(device: torch.device) -> Optional[torch.dtype]:
    """Sampler KV-cache dtype policy (None = keep f32).

    Mirrors vqcpcb_tpu/utils.py:35-64: int8 on the accelerator (one int8 row
    plus one f32 scale per cached position, ops/kv_cache.py), f32 on the CPU
    so greedy KV-cached decoding stays comparable with the full forward.
    VQCPCB_KV_DTYPE=bfloat16|float32|int8 overrides."""
    env = os.environ.get("VQCPCB_KV_DTYPE")
    if env in ("bfloat16", "bf16"):
        return torch.bfloat16
    if env in ("float32", "f32", "fp32"):
        return None
    if env in ("int8", "i8"):
        return torch.int8
    if env:
        raise ValueError(
            f"VQCPCB_KV_DTYPE={env!r}: use 'bfloat16'/'bf16', "
            "'float32'/'f32' or 'int8'")
    return torch.int8 if torch.device(device).type == "cuda" else None


def relbias_in_kernel() -> bool:
    """Whether a relative-bias attention layer computes its bias inside the
    relative-bias kernels (the default) or builds the (B*H, T, S) bias in
    PyTorch and passes it to the fused-attention kernels (K4 at inference,
    K6 in training), where autograd carries it back to e1 and e2.

    Reads VQCPCB_PALLAS_RELBIAS as the JAX package does
    (vqcpcb_tpu/ops/pallas_attention.py:use_pallas_relbias): "1" (default)
    is the in-kernel route, "0" the explicit-bias route."""
    return os.environ.get("VQCPCB_PALLAS_RELBIAS", "1") == "1"


def train_dot_dtype(device) -> torch.dtype:
    """The dot type of the attention's training kernels (K2, K6): bf16 on the
    card, f32 on the CPU (the plain versions). VQCPCB_PALLAS_BF16_DOTS=0
    gives f32 dots on the card too, where the JAX package reads it
    (vqcpcb_tpu/ops/pallas_attention.py:_dots_dtype, at each trace): the
    kernels' f32-dot instances, f32 inputs (bf16 ones are cast, exactly)."""
    if torch.device(device).type == "cpu":
        return torch.float32
    if os.environ.get("VQCPCB_PALLAS_BF16_DOTS", "1") == "1":
        return torch.bfloat16
    return torch.float32


def dict_pretty_print(d: Dict[str, Any], endstr: str = "\n") -> None:
    """Console pretty printer of a metrics dict (vqcpcb_tpu/utils.py:67)."""
    for key, value in d.items():
        if isinstance(value, (list, tuple)):
            print(f"{key.capitalize()}: [{', '.join(map(str, value))}]",
                  end=endstr)
        else:
            try:
                print(f"{key.capitalize()}: {float(value):.6}", end=endstr)
            except (TypeError, ValueError):
                print(f"{key.capitalize()}: {value}", end=endstr)


def load_config_module(config_path: str) -> Dict[str, Any]:
    """Import an executable-Python config file by path and return its
    `config` dict (vqcpcb_tpu/utils.py:80), so a config copied into a model
    directory loads from there."""
    config_path = os.path.abspath(config_path)
    module_name = ("_vqcpcb_config_"
                   + os.path.splitext(os.path.basename(config_path))[0])
    spec = importlib.util.spec_from_file_location(module_name, config_path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module.config
