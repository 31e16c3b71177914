"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from
the root of the repository (CPU), and `python -m pytest benchmark/tests
-m gpu` on a machine with a card."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs on the card")
    return torch.device("cuda", 0)
