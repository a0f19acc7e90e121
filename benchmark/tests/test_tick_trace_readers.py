"""The readers of the fused tick's trace rows: silent where they find
nothing (no ctx, a filter cell, a row count other than the window's), else
the mean over the window's ticks; and a traced run of each online cell on
the CPU, whose result line holds the readers of its configuration."""

import pytest
import torch

from benchmark import harness
from benchmark.drivers import online
from fastslam_tpu_torch.utils import profiling
from harness_fixtures import ONLINE_CELLS, TINY, tiny_cell  # noqa: F401

READERS = ["host_wait_ms", "host_estimator_ms", "stage_update_ms", "stage_resample_ms",
           "icp_iters", "resample_due_pct"]
ICP_ONLY = {"host_estimator_ms", "icp_iters"}


class Recorder:
    """A stand-in for the program's recorder, holding given rows."""

    def __init__(self, rows):
        self._rows = rows

    def rows(self):
        return list(self._rows)


def synthetic_rows():
    """Three ticks: the estimator in two pieces, every stage and counter;
    the values of tick ``i`` scale with ``i + 1``."""
    rows = []
    for i in range(3):
        f = i + 1
        ms = lambda x: int(x * f * 1e6)           # milliseconds as nanoseconds
        rows.append({"key": i, "spans": [("estimator", "tick", 0, ms(0.1)),
                                         ("submit", "tick", ms(0.1), ms(0.4)),
                                         ("wait", "tick", ms(0.4), ms(1.4)),
                                         ("estimator", "tick", ms(1.4), ms(1.5)),
                                         ("tick", None, 0, ms(1.6))],
                     "stages": {"icp": 0.05 * f, "frontend": 0.2 * f, "update": 0.3 * f,
                                "resample": 1.0 * f},
                     "counters": {"icp_iters": 4.0 * f, "resample_due": float(i == 1)}})
    return rows


def expected(name):
    """The mean of the synthetic rows (the factors 1, 2, 3 average 2)."""
    per_tick = {"host_wait_ms": 1.0, "host_estimator_ms": 0.2, "stage_update_ms": 0.3,
                "stage_resample_ms": 1.0, "icp_iters": 4.0}
    return 100.0 / 3 if name == "resample_due_pct" else 2 * per_tick[name]


@pytest.mark.parametrize("name", READERS)
def test_reader_means_the_window_rows(name, monkeypatch):
    monkeypatch.setattr(profiling, "TICK_TRACE", Recorder(synthetic_rows()))
    read = harness.metric_reader(name)
    ctx = {"kind": "online", "ticks": 3, "mean_tick_s": 0.002, "p95_tick_s": 0.003}
    assert read(ctx) == pytest.approx(expected(name))
    assert read({}) is None
    assert read({"kind": "filter", "ticks": 3, "busy_s": 0.01}) is None
    assert read({**ctx, "ticks": 4}) is None                  # another count
    monkeypatch.setattr(profiling, "TICK_TRACE", Recorder([]))
    assert read(ctx) is None


@pytest.mark.parametrize("name", sorted(ICP_ONLY))
def test_icp_readers_silent_without_icp(name, monkeypatch):
    """A motion tick has no estimator or ICP iterations."""
    rows = synthetic_rows()
    for r in rows:
        r["spans"] = [s for s in r["spans"] if s[0] != "estimator"]
        del r["stages"]["icp"], r["counters"]["icp_iters"]
    monkeypatch.setattr(profiling, "TICK_TRACE", Recorder(rows))
    assert harness.metric_reader(name)({"kind": "online", "ticks": 3}) is None


def test_readers_silent_without_the_recorder(monkeypatch):
    """A program that keeps no rows (no ``TICK_TRACE``) gives nothing."""
    monkeypatch.delattr(profiling, "TICK_TRACE")
    for name in READERS:
        assert harness.metric_reader(name)({"kind": "online", "ticks": 3}) is None


@pytest.mark.parametrize("name", ONLINE_CELLS)
def test_traced_online_run_reports_its_readers(name, tiny_cell):
    """A ``--trace 1`` run of an online cell on the CPU: one row per window
    tick, and the line holds the readers of its configuration."""
    cell = tiny_cell(name)
    profiling.TICK_TRACE.clear()
    out = online.run(cell, 2**31 + 7, 2.0, True, "cpu", overrides=TINY)
    line = harness.result_line(cell, torch.device("cpu"), out, True)
    assert len(profiling.TICK_TRACE.rows()) == out.ctx["ticks"] > 0
    want = set(READERS) - (ICP_ONLY if name == "online-motion-100k" else set())
    assert set(line["metrics"]) & set(READERS) == want
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert 0 <= m["resample_due_pct"] <= 100
    assert all(m[k] > 0 for k in want - {"resample_due_pct"})
    profiling.TICK_TRACE.clear()
