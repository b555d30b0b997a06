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
the relative and the absolute decoder, VQ-CPC encoder training
(`models/cpc.py`, `training/encoder_trainer.py`, the quantizers of
`ops/quantizer.py`, the CPC data path of `data/`), and the entry points:
`getters.py` (config dict -> modules), the epoch loop with its two-slot and
step checkpoints and metrics (`training/loop.py`, `checkpoints.py`,
`metrics.py`), score writing (`data/midi.py`) and the CLIs
`python -m vqcpcb_tpu_torch.main_encoder` / `main_decoder`; the student
encoder (`models/teacher.py`, `models/auxiliary_decoder.py`,
`training/student_trainer.py`, the transformer downscalers of
`models/downscalers.py`); and the code prior (`models/prior.py`, its
KV-cached sampler, `training/prior_trainer.py` and
`python -m vqcpcb_tpu_torch.main_prior`); and the (data, model) mesh over
torch.distributed ranks (`parallel/`), with the K7 shard wrappers and the
decoder and prior trainers and CLIs over it.
"""
