"""Settings of the benchmark's own tests: the ``cuda`` marker (tests that
need the card skip without one, decided inside a fixture)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one (run on "
        "the card with: python -m pytest -m cuda portbench/tests)")


@pytest.fixture(autouse=True)
def few_threads():
    """The benchmark's CPU tests run beside the repo's other test files on
    several workers: two threads each keep them from crowding those."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
