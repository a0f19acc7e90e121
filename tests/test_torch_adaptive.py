"""The port's copy of ``proposal/adaptive.py`` against the JAX package's
module: the same numpy inputs give the same arrays, bit for bit, in the
clean, translation-slip, rotation-slip and outlier scenarios of
``tests/test_adaptive.py``."""

import dataclasses

import numpy as np
import pytest

from fastslam_tpu.proposal import adaptive as jax_adaptive
from tests.test_adaptive import make_config, synth

from fastslam_tpu_torch.interop import config_from_jax_fields
from fastslam_tpu_torch.proposal import adaptive

JCFG = make_config()
CFG = config_from_jax_fields(dataclasses.asdict(JCFG))


def outlier():
    streams = list(synth())
    streams[1][150] = 0.25   # one catastrophic match failure
    return tuple(streams)


SCENARIOS = {
    "clean": lambda: synth(),
    "translation_slip": lambda: synth(slip_xy=0.02),
    "rotation_slip": lambda: synth(slip_th=0.02),
    "outlier": outlier,
}


def assert_same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_same(got[k], want[k])
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_floor_schedule_bit_for_bit(scenario):
    streams = SCENARIOS[scenario]()
    got = adaptive.floor_schedule(*streams, CFG)
    want = jax_adaptive.floor_schedule(*streams, JCFG)
    assert got._fields == want._fields
    assert_same(tuple(got), tuple(want))


def test_residuals_and_discrepancy_bit_for_bit():
    rng = np.random.default_rng(7)
    t = 40
    rots = np.where(rng.random(t) < 0.3, rng.normal(0, 0.05, t), 0.0).astype(np.float32)
    trans = np.where(rots == 0, 0.03 + rng.normal(0, 0.002, t), 0.0).astype(np.float32)
    angs = (-rots[1:] + rng.normal(0, 0.003, t - 1)).astype(np.float32)
    tvecs = np.stack([-trans[1:], np.zeros(t - 1)], -1).astype(np.float32) \
        + rng.normal(0, 0.001, (t - 1, 2)).astype(np.float32)
    dir_ang = (angs[:-1] + angs[1:] + rng.normal(0, 0.002, t - 2)).astype(np.float32)
    dir_t = (tvecs[:-1] + tvecs[1:]).astype(np.float32)
    assert_same(adaptive.se2_residuals(angs, tvecs, rots, trans),
                jax_adaptive.se2_residuals(angs, tvecs, rots, trans))
    assert_same(adaptive.consistency_discrepancy(angs, tvecs, dir_ang, dir_t),
                jax_adaptive.consistency_discrepancy(angs, tvecs, dir_ang, dir_t))


@pytest.mark.parametrize("scenario", ["clean", "rotation_slip"])
def test_online_estimator_push_read_sequence(scenario):
    """Read before push, per tick type, as both online paths do; the
    estimator reads both types after every push."""
    sr_th, sr_al, lat, d_ang, d_t2, v_active = SCENARIOS[scenario]()
    got_est = adaptive.OnlineFloorEstimator(CFG)
    want_est = jax_adaptive.OnlineFloorEstimator(JCFG)
    for t in range(120):
        k = int(v_active[t])
        kw = {}
        if t > 0:
            kw.update(sr_th=sr_th[t], sr_al=sr_al[t], lat=lat[t])
        if t >= 2:
            kw.update(d_ang=d_ang[t - 2], d_t2=d_t2[t - 2])
        assert_same(got_est.read(k), want_est.read(k))
        got_est.push(k, **kw)
        want_est.push(k, **kw)
        for kk in (0, 1):
            assert_same(got_est.read(kk), want_est.read(kk))


def test_module_constants_and_helpers_are_the_same():
    assert adaptive._CHI2_MED == jax_adaptive._CHI2_MED
    assert adaptive._CHI2_2_MED_HALF == jax_adaptive._CHI2_2_MED_HALF
    window = [0.1, 0.4, 0.2, 0.9]
    assert adaptive._var(window) == jax_adaptive._var(window)
    assert adaptive._var2(window) == jax_adaptive._var2(window)
    assert adaptive._var([]) == 0.0 and adaptive._var2([]) == 0.0
    got, want = adaptive._TypedWindows(3), jax_adaptive._TypedWindows(3)
    for i in range(5):
        got.push(i % 2, i)
        want.push(i % 2, i)
    assert got.w == want.w and got.get(0) == want.get(0)
    assert adaptive._TypedWindows(2).get(1) == []
