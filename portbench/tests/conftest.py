"""The benchmark's own tests: `python -m pytest portbench/tests -q` (CPU,
about a minute); the card's cases run where CUDA is: marked `cuda`, each
skips through the `card` fixture where there is none."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
