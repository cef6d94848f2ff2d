"""Fixtures of the benchmark's tests (run from the repository root:
``python -m pytest portbench/tests``)."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips without one (decided here, never at
    import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.fixture
def tiny(tmp_path):
    """A tiny copy of the benchmark, with its real limits files."""
    from portbench.tests.tiny import tiny_copy
    return tiny_copy(str(tmp_path))
