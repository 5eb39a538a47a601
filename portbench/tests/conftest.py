"""The benchmark's tests: the program's sources on the path, and the card
fixture (decided inside the fixture, never at import)."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs cover the harness on the plain kernels")
    return torch.device("cuda", 0)
