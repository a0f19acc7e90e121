"""The device-decided resample's plain versions (``cuda_kernels.
resample_staircase`` and ``resample_gather`` on CPU tensors), which mirror
``csrc/resample.cu``: the staircase's binary search over the grid counts
against ``kernels.grid_staircase_indices`` (the scatter-max and prefix max
that JAX's staircase runs) bit for bit, and the in-place gather against
``kernels.resample_planes_state``."""

import dataclasses

import numpy as np
import pytest
import torch

from fastslam_tpu.config import FastSLAMConfig as JaxConfig

from fastslam_tpu_torch.core import cuda_kernels, kernels
from fastslam_tpu_torch.interop import config_from_jax_fields, planes_state_from_numpy
from tests.test_torch_filter_core import staircase_cases
from tests.test_torch_fused_update import seeded_planes

torch.set_num_threads(1)

CASES = sorted(staircase_cases(np.random.default_rng(0), 8))
# 4097 and 10,000: ragged against the kernel's scan tile
SIZES = [8, 100, cuda_kernels.RESAMPLE_SCAN_TILE + 1, 10_000]


def u0_values(n):
    return (0.0, 1e-7 / n, 0.3 / n, (n - 1) / (n * n))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_staircase_plain_version_equals_grid_staircase(case, n):
    w = torch.from_numpy(staircase_cases(np.random.default_rng(n), n)[case].astype(np.float32))
    due = torch.tensor(True)
    for u0 in u0_values(n):
        u = torch.tensor(u0, dtype=torch.float32)
        want = kernels.grid_staircase_indices(kernels.fixed_order_cumsum(w), u, n)
        got = cuda_kernels.resample_staircase(w, u, due)
        assert got.dtype == torch.int64
        assert torch.equal(got, want), f"{case} n={n} u0={u0}"
        # what the kernel's search relies on: the counts do not decrease
        s = kernels.grid_counts(kernels.fixed_order_cumsum(w), u, n)
        assert bool(torch.all(s[1:] >= s[:-1]))


def planes_state(parity, p=300, l=8):
    cfg = config_from_jax_fields(dataclasses.asdict(
        JaxConfig(num_particles=p, max_landmarks=l, parity_mode=parity)))
    st = seeded_planes(p, l, seed=21, fill=6, parity=parity)
    return cfg, planes_state_from_numpy(st, "cpu")


def gather_args(state, parity):
    planes = [t for t in (state.lm_mx, state.lm_my, state.lm_ca, state.lm_cb, state.lm_cc,
                          state.lm_cd) if t is not None]
    rows = [state.poses, state.lm_count] + ([state.log_weights] if parity else [])
    return planes, rows


@pytest.mark.parametrize("due", [True, False], ids=["due", "not-due"])
@pytest.mark.parametrize("parity", [False, True])
def test_gather_plain_version_equals_resample_planes_state(parity, due):
    cfg, state = planes_state(parity)
    p = state.num_particles
    w = torch.from_numpy(staircase_cases(np.random.default_rng(3), p)["dirichlet"]
                         .astype(np.float32))
    idx = cuda_kernels.resample_staircase(w, torch.tensor(0.4 / p), torch.tensor(True))
    before = state.clone()
    want = kernels.resample_planes_state(before, idx, cfg) if due else before
    planes, rows = gather_args(state, parity)
    pointers = [t.data_ptr() for t in planes + rows]
    cuda_kernels.resample_gather(planes, rows, idx, torch.tensor(due))
    assert [t.data_ptr() for t in planes + rows] == pointers
    for k, v in vars(state).items():
        if v is None:
            assert getattr(want, k) is None
        elif k != "log_weights" or parity:
            assert torch.equal(v, getattr(want, k)), k
