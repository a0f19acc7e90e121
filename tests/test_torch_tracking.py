"""Corner tracking: the port's ``frontend/tracking.py`` against the JAX
package's on the same seeded numpy inputs, tick by tick.

Integer outputs (hits, misses, track ids, ``next_id``) must match exactly,
positions to 1e-6.  The scenarios cover a table that fills, kills at
``max_misses``, opens that run out of free slots, recycled slots with new
ids and both ego-motion types; the random stream keeps every candidate
distance at least 1e-3 away from the gate, so no match sits on a tie.
The tracked split online loop is held against JAX's
``fuse_online_tick=False`` loop with ``track_corners=True``, noise-free, at
P=128, L=16, to 1e-4 as ``test_torch_online.py`` holds the untracked one.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.app.runner import run_driver as jax_run_driver
from fastslam_tpu.config import FastSLAMConfig as JaxConfig
from fastslam_tpu.drivers.replay import ReplayDriver as JaxReplayDriver
from fastslam_tpu.frontend import tracking as jax_tracking

from fastslam_tpu_torch.app.runner import run_driver
from fastslam_tpu_torch.drivers.replay import ReplayDriver, record_log
from fastslam_tpu_torch.drivers.sim_world import SimWorld
from fastslam_tpu_torch.frontend import tracking
from fastslam_tpu_torch.interop import config_from_jax_fields

torch.set_num_threads(1)


def pad(corners, cap=8):
    arr = np.zeros((cap, 2), np.float32)
    v = np.zeros(cap, bool)
    arr[:len(corners)] = corners
    v[:len(corners)] = True
    return arr, v


def assert_same(got, want, msg=""):
    for name in ("hits", "misses", "track_id", "next_id"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=f"{msg} {name}")
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos), rtol=0, atol=1e-6,
                               err_msg=f"{msg} pos")


def run_both(capacity, steps, min_hits=2):
    """Feed ``steps`` of ``(corners, valid, rotation, translation, kw)`` to
    both trackers, holding them equal after every tick; returns the last
    ``stable_corners`` of each."""
    jt = jax_tracking.init_tracks(capacity)
    pt = tracking.init_tracks(capacity, "cpu")
    for t, (c, v, rot, tr, kw) in enumerate(steps):
        jt = jax_tracking.update_tracks(jt, jnp.asarray(c), jnp.asarray(v), jnp.float32(rot),
                                        jnp.float32(tr), **kw)
        pt = tracking.update_tracks(pt, torch.from_numpy(c), torch.from_numpy(v),
                                    torch.tensor(np.float32(rot)),
                                    torch.tensor(np.float32(tr)), **kw)
        assert_same(pt, jt, f"tick {t}")
    got = tracking.stable_corners(pt, min_hits=min_hits)
    want = jax_tracking.stable_corners(jt, min_hits=min_hits)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    return got, pt


def random_stream(seed, ticks, c, gate=0.4):
    """A seeded stream of detections: three persistent corners with jitter,
    random clutter, ticks without detections, rotations and translations;
    redrawn until no candidate distance is within 1e-3 of the gate."""
    rng = np.random.default_rng(seed)
    steps = []
    world = np.array([[1.0, 1.0], [2.0, -1.0], [-1.0, 2.0]], np.float32)
    for t in range(ticks):
        n = int(rng.integers(0, c + 1))
        cor = rng.uniform(-3, 3, (c, 2)).astype(np.float32)
        if t % 3:
            cor[:3] = world + rng.normal(0, 0.05, (3, 2)).astype(np.float32)
        v = np.zeros(c, bool)
        v[:n] = True
        rot = float(rng.choice([0.0, 0.05]))
        steps.append((cor, v, rot, 0.0 if rot else 0.02,
                      dict(gate=gate, max_misses=2)))
    return steps


def gate_margin(capacity, steps):
    """The least |distance - gate| over every live track and valid corner."""
    jt = jax_tracking.init_tracks(capacity)
    margin = np.inf
    for c, v, rot, tr, kw in steps:
        alive = np.asarray(jt.track_id) >= 0
        pred = np.asarray(jax_tracking._ego_compensate(jt.pos, jnp.float32(rot),
                                                       jnp.float32(tr)))
        d = np.linalg.norm(pred[:, None] - c[None], axis=-1)[alive][:, v]
        if d.size:
            margin = min(margin, np.abs(d - kw["gate"]).min())
        jt = jax_tracking.update_tracks(jt, jnp.asarray(c), jnp.asarray(v), jnp.float32(rot),
                                        jnp.float32(tr), **kw)
    return margin


@pytest.mark.parametrize("seed,capacity", [(0, 8), (1, 4), (2, 16)])
def test_random_stream_matches_jax(seed, capacity):
    steps = random_stream(seed, 40, 6)
    assert gate_margin(capacity, steps) > 1e-3
    _, pt = run_both(capacity, steps)
    ids = pt.track_id.numpy()
    assert int(pt.next_id) > capacity    # slots were recycled with new ids
    assert (ids >= 0).sum() > 0


def test_persistent_corner_confirms_and_keeps_id():
    c, v = pad([[2.0, 1.0], [3.0, -0.5]])
    (pos, ids, ok), _ = run_both(16, [(c, v, 0.0, 0.0, {})] * 3)
    assert sorted(ids.numpy()[ok.numpy()]) == [0, 1]


def test_one_frame_flicker_never_emitted():
    steady, sv = pad([[2.0, 1.0]])
    flicker, fv = pad([[2.0, 1.0], [-1.0, 4.0]])
    (pos, ids, ok), _ = run_both(16, [(steady, sv, 0.0, 0.0, {}), (flicker, fv, 0.0, 0.0, {}),
                                      (steady, sv, 0.0, 0.0, {})])
    got = pos.numpy()[ok.numpy()]
    assert got.shape[0] == 1
    np.testing.assert_allclose(got[0], [2.0, 1.0], atol=1e-5)


def test_ego_motion_compensation_translation_and_rotation():
    steps = [(*pad([[3.0 - 0.5 * i, 1.0]]), 0.0, 0.5 if i else 0.0, dict(gate=0.3))
             for i in range(4)]
    (pos, ids, ok), _ = run_both(16, steps, min_hits=3)
    assert ids.numpy()[ok.numpy()].tolist() == [0]
    np.testing.assert_allclose(pos.numpy()[ok.numpy()][0], [1.5, 1.0], atol=1e-5)
    th, p0 = 0.3, np.array([2.0, 0.5])
    steps = []
    for i in range(4):
        c_, s_ = np.cos(-th * i), np.sin(-th * i)
        p = [c_ * p0[0] - s_ * p0[1], s_ * p0[0] + c_ * p0[1]]
        steps.append((*pad([p]), th if i else 0.0, 0.0, dict(gate=0.3)))
    (pos, ids, ok), _ = run_both(16, steps, min_hits=3)
    assert ids.numpy()[ok.numpy()].tolist() == [0]


def test_missed_tracks_die_and_slots_recycle():
    c, v = pad([[2.0, 1.0]], cap=4)
    empty = (np.zeros((4, 2), np.float32), np.zeros(4, bool))
    c2, v2 = pad([[0.5, 0.5]], cap=4)
    steps = ([(c, v, 0.0, 0.0, {})] * 2 + [(*empty, 0.0, 0.0, {})] * 5
             + [(c2, v2, 0.0, 0.0, {})] * 2)
    (pos, ids, ok), pt = run_both(4, steps)
    got = ids.numpy()[ok.numpy()]
    assert len(got) == 1 and got[0] > 0
    assert int(pt.next_id) == 2


def test_full_table_drops_the_excess_opens():
    c, v = pad([[1.0, 0.0], [2.0, 0.0], [3.0, 0.0]], cap=4)
    c2, v2 = pad([[1.0, 0.0], [2.0, 0.0], [3.0, 0.0], [-2.0, 1.0]], cap=4)
    _, pt = run_both(2, [(c, v, 0.0, 0.0, {}), (c2, v2, 0.0, 0.0, {})])
    assert (pt.track_id.numpy() >= 0).sum() == 2 and int(pt.next_id) == 2


def test_tracked_split_online_loop_matches_jax():
    log = record_log(SimWorld(seed=3), num_ticks=32)
    jcfg = JaxConfig(num_particles=128, max_landmarks=16, use_pallas=True,
                     pallas_interpret=True, fuse_online_tick=False, parity_mode=False,
                     warmup_iterations=8, rotation_noise=0.0, translation_noise=0.0,
                     track_corners=True)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    want = jax_run_driver(JaxReplayDriver(log), jcfg, rng=0)
    got = run_driver(ReplayDriver(log), cfg, rng=0, device="cpu")
    np.testing.assert_allclose(np.asarray(got.est_poses), np.asarray(want.est_poses),
                               rtol=1e-4, atol=1e-4)
    assert got.num_measurements == want.num_measurements
    assert max(got.num_measurements) > 0
    assert set(got.stage_seconds) == {"icp_refine", "tick"}
