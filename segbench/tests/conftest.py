"""segbench's own tests: run from the repository root with

    python -m pytest segbench/tests -q -p no:cacheprovider

They run on the CPU at small sizes; the tests marked ``chip`` need a CUDA
card and skip without one (the decision is taken inside each test).
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
