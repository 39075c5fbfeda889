"""The benchmark's tests: `python -m pytest portbench/tests -q` from the
root of the repository. Those marked `cuda` run only where torch sees a
card and skip elsewhere; the rest run on the CPU at a tiny size."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DATA = os.path.join(ROOT, "portbench", "tests", "data")
BENCHMARK = os.path.join(DATA, "benchmark.json")


@pytest.fixture
def tiny():
    """load_cell for the tiny CPU cells of tests/data."""
    from portbench.harness import spec

    def load(name):
        return spec.load_cell(name, BENCHMARK, DATA)
    return load


@pytest.fixture
def card():
    """Skip without a CUDA card (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
