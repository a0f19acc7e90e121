"""The comparison fails what it must: the bfloat16 control, and a run with
the timed path broken underneath (the state returned unchanged, half of
the particles left out, an estimate altered where it is produced)."""

import pytest
import torch

from benchmark import control, harness
from harness_fixtures import FILTER_CELLS, ONLINE_CELLS, TINY, tiny_cell  # noqa: F401

CELLS = FILTER_CELLS + ONLINE_CELLS


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_fails(name, tiny_cell):
    cell = tiny_cell(name)
    r = control.read_seed(cell, 2**32 + 3, 2.0, "cpu", overrides=TINY)
    assert r["checked"] >= 1
    assert max(r["program"]) == 0.0
    names = (("est_gap", "particles_apart") if name in FILTER_CELLS
             else ("out_gap", "estimator_gap", "particles_apart"))
    limits = [cell.limits.get(k, float("inf")) for k in names]
    assert any(c > lim for c, lim in zip(r["control"], limits)), r


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, tiny_cell):
    cell = tiny_cell(name)
    with control.planted(fault):
        out = harness.driver_module(cell).run(cell, 2**31 + 5, 2.0, False, "cpu",
                                              overrides=TINY)
    line = harness.result_line(cell, torch.device("cpu"), out, False)
    assert not line["correct"], line["checks"]


def test_planted_restores_the_program():
    from fastslam_tpu_torch.core import kernels

    before = kernels.fastslam_step_planes
    with control.planted("half"):
        assert kernels.fastslam_step_planes is not before
    assert kernels.fastslam_step_planes is before
