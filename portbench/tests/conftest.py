import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    """Skip the test where no CUDA card is present (decided when the test
    runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
