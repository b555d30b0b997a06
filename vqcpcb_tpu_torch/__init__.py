"""PyTorch + CUDA port of vqcpcb_tpu for NVIDIA Hopper (H100).

Module names mirror the JAX package `vqcpcb_tpu/`, so each counterpart is
found by path. The port imports torch and numpy only: never jax, flax or
anything of `vqcpcb_tpu` (it keeps its own copies of what it needs, e.g.
`data/vocab.py`). Every Pallas TPU kernel on a ported path is a CUDA C++
kernel under `csrc/`, built with nvcc at first use (`ops/_build.py`), with a
plain PyTorch version beside it that CPU tensors take.

Ported so far: the re-harmonisation serving path (the frozen encoder's
codes through the nearest-codebook kernel, `ops/vq_kernels.py`; the
decoders' prefill through the attention kernels; the KV-cached sampler,
`models/decoder.py`, `training/decoder_trainer.py`), decoder training for
the relative and the absolute decoder, and VQ-CPC encoder training
(`models/cpc.py`, `training/encoder_trainer.py`, the quantizers of
`ops/quantizer.py`, the CPC data path of `data/`).
"""
