"""Fixtures shared by the benchmark's own tests (CPU, tiny sizes)."""

import pytest
import torch

from benchmark import harness

# sizes at which the CPU runs the program's plain path in seconds
TINY = {"num_particles": 200, "max_landmarks": 16}
FILTER_CELLS = ["filter-motion-100k", "filter-fs2-100k"]
ONLINE_CELLS = ["online-fs2-icp-100k", "online-motion-100k"]


@pytest.fixture
def tiny_cell():
    """A cell whose checked chunks or ticks fall inside a short CPU window."""
    def make(name):
        cell = harness.load_cell(name)
        cell.traffic["check_buckets"] = [0, 1, 3] if name in FILTER_CELLS else [0, 2, 5]
        return cell
    return make


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the program's kernels have no CPU mode)")
    return torch.device("cuda", 0)
