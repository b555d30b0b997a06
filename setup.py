"""Packaging (reference: setup.py — package vqcpc-bach 0.0.1)."""
from setuptools import find_packages, setup

setup(
    name="vqcpcb-tpu",
    version="0.1.0",
    description="TPU-native VQ-CPC for template-based music generation",
    packages=find_packages(include=["vqcpcb_tpu", "vqcpcb_tpu.*",
                                    "vqcpcb_tpu_torch", "vqcpcb_tpu_torch.*"]),
    package_data={"vqcpcb_tpu.native": ["*.so", "*.cpp"],
                  "vqcpcb_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
                  "vqcpcb_tpu_torch.native": ["*.cpp"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "orbax-checkpoint", "numpy",
                      "click"],
    extras_require={"scores": ["music21", "matplotlib", "seaborn"]},
)
