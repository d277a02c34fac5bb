"""The benchmark's own tests (run them with ``python -m pytest portbench/tests``).

Tests marked ``card`` need a CUDA device and skip without one; whether one
is present is decided inside the ``card`` fixture, never at import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (an H100); skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the port on the card")
    return torch.device("cuda", 0)
