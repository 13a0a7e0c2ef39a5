"""The benchmark's own tests: on the CPU at small sizes, except those
marked `cuda` (skipped without a card).

    python -m pytest -q benchmark/tests
"""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
for p in (str(REPO), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture
def card():
    """Skip where no CUDA card is present (decided here, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
