"""The port's package is under src/: the bench tests import it from there,
as run.py does, whatever PYTHONPATH holds. Each bench test runs on two
intra-op threads, so that the suite's other workers keep their cores."""

import sys
from pathlib import Path

import pytest
import torch

_SRC = str(Path(__file__).resolve().parents[1] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
