"""At a tiny size on the CPU the plain reference agrees with the program's
CPU path bit for bit: chunk by chunk from the same state and draws, and
through a whole run of the harness."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.drivers import filter as driver
from benchmark.reference import filter as ref
from benchmark.drivers import online
from harness_fixtures import FILTER_CELLS, ONLINE_CELLS, TINY, tiny_cell  # noqa: F401


@pytest.mark.parametrize("name", ["filter-motion-100k", "filter-fs2-100k"])
def test_reference_equals_program_chunks(name, tiny_cell):
    fr = driver.FilterRun(tiny_cell(name), 2**33 + 1, "cpu", overrides=TINY)
    for _ in range(4):
        before = driver.clone(driver.state_dict(fr.state))
        fr.fill()
        draws = driver.clone(fr.draws)
        fr.launch()
        est, state, _ = fr.reference_chunk(before, draws)
        assert torch.equal(est, fr.est)
        for k in ref.FIELDS:
            assert torch.equal(state[k], getattr(fr.state, k)), k
    assert int(fr.state.lm_count.sum()) > 0


@pytest.mark.parametrize("name", FILTER_CELLS + ONLINE_CELLS)
def test_harness_run_correct_on_cpu(name, tiny_cell):
    cell = tiny_cell(name)
    out = harness.driver_module(cell).run(cell, 2**31 + 99, 2.0, False, "cpu", overrides=TINY)
    line = harness.result_line(cell, torch.device("cpu"), out, False)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 2 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name", ONLINE_CELLS)
def test_online_reference_equals_program_ticks(name, tiny_cell):
    """Tick by tick from the program's state: the reference's out row,
    pose, state and estimator windows equal the program's, and the drive
    gives the frontend corners to measure."""
    orun = online.OnlineRun(tiny_cell(name), 2**33 + 5, "cpu", overrides=TINY)
    orun.setup(0.01)
    seen = 0.0
    for _ in range(6):
        i = orun.t
        before = orun.program_state(orun.device_copies())
        _, pose = orun.tick()
        snap = {"before": before, "after": orun.program_state(orun.device_copies()),
                "draws": {k: v for k, v in orun.runner._fused._draws._asdict().items()},
                "out": orun.runner._last_out.copy(), "pose": pose}
        assert orun.compare(orun.program_result(snap), orun.reference_tick(i, snap)) == (
            0.0, 0.0, 0.0)
        seen += float(snap["out"][5])
    assert seen > 0, "no measurement in six ticks"


def test_online_drive_is_made_from_the_seed(tiny_cell):
    """Every seed drives the same scans; the seed draws the slip."""
    from benchmark import drive

    t = tiny_cell("online-fs2-icp-100k").traffic
    a, b, c = drive.record(t, 11, 200), drive.record(t, 11, 200), drive.record(t, 12, 200)
    assert all(np.array_equal(getattr(a, k), getattr(b, k)) for k in vars(a))
    assert np.array_equal(a.points, c.points) and not np.array_equal(a.slip_rot, c.slip_rot)
    assert a.points.shape == (200, 180, 2) and a.points.dtype == np.float32
    assert np.any(a.cmd_w != 0) and np.any(a.cmd_v != 0)
    assert np.any(a.slip_rot != 0) and not np.any(
        drive.record(tiny_cell("online-motion-100k").traffic, 11, 200).slip_rot)


def test_reference_start_state():
    s = ref.init_state(5, 3, "cpu")
    assert s["lm_mx"].shape == (3, 5) and float(s["log_weights"].exp().sum()) == pytest.approx(1.0)
