"""The (data, model) mesh over torch.distributed ranks (counterpart of
vqcpcb_tpu/parallel/): multi-process start-up (`distributed.py`), the mesh,
batch sharding and the tensor-parallel parameter rules (`mesh.py`), and the
Megatron collectives the modules call under a model axis
(`collectives.py`). JAX drives every local device from one process; the
port runs one process per GPU, so "the mesh spans all devices" reads "the
mesh spans all ranks"."""
