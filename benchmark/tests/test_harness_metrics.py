"""The metric arithmetic: the idle share from a synthetic trace, the
roofline counts from shapes, the readers' silence where they find
nothing."""

import math

import pytest

from benchmark import harness, roofline, trace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_summarize_synthetic_trace():
    evs = [ev(trace.WINDOW, "user_annotation", 0, 1000),
           ev("bench.replay", "user_annotation", 0, 400),
           ev("bench.wait", "user_annotation", 400, 600),
           ev("k1", "kernel", 100, 200), ev("k2", "kernel", 250, 100),   # overlap: union 250
           ev("copy", "gpu_memcpy", 600, 100), ev("late", "kernel", 950, 200)]  # clipped to 50
    s = trace.summarize(evs)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx((250 + 100 + 50) * 1e-6)
    gaps = s["breakdown"]["idle_gaps"]
    assert gaps[0] == ["bench.wait", pytest.approx(250e-6)]        # 700..950
    assert sorted(g[1] for g in gaps) == pytest.approx([100e-6, 250e-6, 250e-6])
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["k1"] == pytest.approx(200e-6) and ops["late"] == pytest.approx(50e-6)
    idle = harness.metric_reader("device_idle_pct.filter")(
        {"kind": "filter", "busy_s": s["busy_s"], "window_s": s["window_s"]})
    assert idle == pytest.approx(60.0)


def test_union():
    assert trace.union([(0, 2), (1, 3), (5, 6), (5.5, 5.6)]) == 4


def test_motion_chunk_bound_from_shapes():
    p, c, m, occ = 100_000, 16, 16, 100_000 * 64
    s = roofline.chunk_bound_s(p=p, c=c, measured=m, occupied=occ, written=0,
                               resampled=False, fs2=False)
    ops = c * m * (20 * occ + 120 * p)
    assert s == pytest.approx(ops / 67e12)
    assert s / c == pytest.approx(3.344e-5, rel=1e-3)          # ms per tick: 0.0334


def test_fs2_bound_and_bytes_side():
    p, c = 100_000, 16
    s = roofline.chunk_bound_s(p=p, c=c, measured=16, occupied=p * 64, written=p * 16,
                               resampled=True, fs2=True)
    assert s / c == pytest.approx((16 * (2 * 20 * p * 64 + 220 * p) + 80 * p) / 67e12, rel=1e-9)
    # no measurements: only bytes remain
    b = roofline.chunk_bound_s(p=p, c=1, measured=0, occupied=0, written=0,
                               resampled=False, fs2=False)
    assert b == pytest.approx(((9 + 2 + 4 + 2) * p * 4) / 3.35e12)


def test_roofline_reader():
    read = harness.metric_reader("filter_roofline")
    assert read({"kind": "filter", "ticks": 100, "busy_s": 0.02,
                 "bound_s_per_tick": 5e-5}) == pytest.approx(25.0)
    assert read({"kind": "filter", "ticks": 100, "busy_s": 0.02, "bound_s_per_tick": None}) is None
    assert read({"kind": "online"}) is None
    assert not math.isnan(read({"kind": "filter", "ticks": 1, "busy_s": 1.0,
                                "bound_s_per_tick": 0.5}))


@pytest.mark.parametrize("name", ["tick_host_ms", "tick_host_ms.icp"])
def test_online_host_readers(name):
    read = harness.metric_reader(name)
    ctx = {"kind": "online", "ticks": 400, "busy_s": 0.8, "mean_tick_s": 0.0026,
           "p95_tick_s": 0.0031}
    assert read(ctx) == pytest.approx(0.6)
    assert read({**ctx, "busy_s": None}) is None
    assert read({**ctx, "kind": "filter"}) is None


def test_online_tail_reader():
    read = harness.metric_reader("tick_p95_ms.icp")
    ctx = {"kind": "online", "ticks": 400, "busy_s": 0.8, "mean_tick_s": 0.0026,
           "p95_tick_s": 0.0031}
    assert read(ctx) == pytest.approx(3.1)
    assert read({**ctx, "ticks": 0}) is None
    assert read({**ctx, "kind": "filter"}) is None
