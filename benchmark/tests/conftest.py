"""The benchmark's own tests: CPU tests at small sizes, and tests marked
``card`` that run only where there is a CUDA device (they decide inside a
fixture, never at import).

    python -m pytest benchmark/tests -q
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the chip")


@pytest.fixture(scope="session")
def small():
    """The batch cell and its configuration cut to a CPU test's size: a
    100 kb genome, 8 slots, reads of 300-600 bases (a read whose slot the
    device ignores runs out of events within a window), 200 reads made
    before the window, every due read compared (up to 64)."""
    from benchmark.harness.core import cell_files

    cell, cfg = cell_files("ecoli_map.isolate")
    cfg["genome"]["bp"] = 100_000
    cfg["conf"]["engine"]["batch_reads"] = 8
    cell["params"]["check"].update(reads=64, workers=2)
    cell["params"]["feed_reads"] = 200
    cell["params"]["read_len_bp"] = [300, 600]
    return cell, cfg
