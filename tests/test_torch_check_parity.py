"""The card-against-CPU parity check (``probes/check_parity.py``): its CPU
side against the JAX package's step, its comparisons, and its bars against
``scripts/check_pallas_parity.py``.

The CPU side of the motion check is the port's blocks step on the CPU; from
JAX's ``init_state(cfg, rng=0)`` (carried across by ``interop``) with JAX's
own draws (``jax.random.split(state.rng, 4)``) its three ticks equal JAX's
``fastslam_step`` with ``use_pallas=False`` within 1e-5, the landmark
counts exactly.  The fs2 check's CPU side likewise, within the fs2 bar of
``tests/test_torch_blocks.py`` (1e-4), with the resample off: at the
script's fs2 setup the second tick's weights lie 1.6e-8 from a resample grid
position in JAX's own cumulative sums, which XLA and the port may round to
either side (11 of 1,024 particles take another ancestor).
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.config import FastSLAMConfig as JaxConfig
from fastslam_tpu.core import kernels as jax_kernels
from fastslam_tpu.core.state import init_state as jax_init_state
from fastslam_tpu.core.state import pad_measurements as jax_pad_measurements

from fastslam_tpu_torch.core import kernels
from fastslam_tpu_torch.interop import config_from_jax_fields, filter_state_from_numpy
from fastslam_tpu_torch.probes import check_parity
from tests.test_torch_blocks import jax_draws

torch.set_num_threads(1)

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts", "check_pallas_parity.py")
BLOCKS = ("poses", "log_weights", "lm_mean", "lm_cov", "lm_count")


@pytest.mark.parametrize("check", ["motion", "fs2"])
def test_cpu_side_is_jax_fastslam_step(check):
    p = check_parity.MOTION_PARTICLES if check == "motion" else check_parity.FS2_PARTICLES
    kw = dict(num_particles=p, max_landmarks=64, max_measurements=16, use_pallas=False)
    if check == "fs2":
        # the second tick's weights lie 1.6e-8 from a resample grid position
        # in JAX's own sums: hold the ticks with the resample off
        kw.update(parity_mode=False, proposal_mode="fastslam2", resample_threshold_frac=0.0)
    jcfg = JaxConfig(**kw)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    assert cfg == check_parity.config(check, p).replace(
        resample_threshold_frac=cfg.resample_threshold_frac)
    fs2 = kernels.uses_fs2(cfg)
    js = jax_init_state(jcfg, rng=0)
    state = filter_state_from_numpy({k: np.asarray(getattr(js, k)) for k in BLOCKS}, "cpu")
    jms = jax_pad_measurements(jcfg, check_parity.MEASUREMENTS)
    step = jax.jit(lambda s, r, t, m: jax_kernels.fastslam_step(s, r, t, m, jcfg))
    draws = []
    for _ in range(check_parity.STEPS):
        draws.append(jax_draws(js, fs2))
        js, want_pose = step(js, jnp.float32(0.0), jnp.float32(0.4), jms)
    got = check_parity.run_steps(cfg, draws, "cpu", state=state)
    tol = 1e-4 if fs2 else 1e-5
    np.testing.assert_array_equal(got["cnt"], np.asarray(js.lm_count))
    assert got["cnt"].max() > 0
    for key, field in (("poses", "poses"), ("logw", "log_weights"), ("mean", "lm_mean"),
                       ("cov", "lm_cov")):
        np.testing.assert_allclose(got[key], np.asarray(getattr(js, field)), rtol=tol,
                                   atol=tol, err_msg=key)
    np.testing.assert_allclose(got["pose"], np.asarray(want_pose), rtol=tol, atol=tol)
    if fs2:   # the weights vary, so a resample would have been due
        assert np.ptp(got["logw"]) > 1.0


def test_motion_check_never_resamples():
    """In the motion check the weights' total falls under parity mode's
    weight floor every tick, which resets them to uniform: no tick resamples,
    so no resample grid position can part the card from the CPU at any
    width."""
    cfg = check_parity.config("motion", 256)
    got = check_parity.run_steps(cfg, check_parity.make_draws(cfg), "cpu")
    assert np.all(got["logw"] == got["logw"][0]) and got["cnt"].min() > 0


def snapshot(p, seed=0):
    rng = np.random.default_rng(seed)
    return {"poses": rng.normal(size=(p, 3)).astype(np.float32),
            "logw": rng.normal(size=p).astype(np.float32),
            "mean": rng.normal(size=(p, 64, 2)).astype(np.float32),
            "cov": rng.normal(size=(p, 64, 4)).astype(np.float32),
            "cnt": rng.integers(0, 64, p).astype(np.int32),
            "pose": rng.normal(size=3).astype(np.float32)}


def test_comparisons_pass_on_equal_inputs_and_fail_past_a_bar():
    a = snapshot(1000)
    b = {k: v.copy() for k, v in a.items()}
    assert check_parity.compare_max(a, b)["ok"]
    assert check_parity.compare_flips(a, b)["ok"]
    # a 2e-5 pose error breaks the motion bar (1e-5)
    b["poses"][3, 0] += 2e-5
    assert not check_parity.compare_max(a, b)["ok"]
    # the same error on 2 % of the particles breaks the fs2 bar (5e-5 on
    # poses under 1 % past it) only when it passes 5e-5
    b["poses"][:20, 1] += 6e-5
    fs2 = check_parity.compare_flips(a, b)
    assert not fs2["ok"] and fs2["diffs"]["poses"]["over"] == pytest.approx(0.02)
    # a 2 % landmark-count flip breaks both
    c = {k: v.copy() for k, v in a.items()}
    c["cnt"][:20] += 1
    assert not check_parity.compare_max(a, c)["ok"]
    flips = check_parity.compare_flips(a, c)
    assert not flips["ok"] and flips["flip_frac"] == pytest.approx(0.02)
    # flips under 1 % pass, the flipped particles left out of the rest
    c["cnt"][9:20] -= 1
    c["poses"][:9] += 1.0
    assert check_parity.compare_flips(a, c)["ok"]


def test_estimates_are_held_where_the_pick_is_the_same_and_tied_elsewhere():
    rng = np.random.default_rng(1)
    tlogw = rng.normal(size=(4, 50)).astype(np.float32)
    tlogw[0] = -3.0                      # tick 0: every weight tied
    a = {"tlogw": tlogw, "pose": rng.normal(size=(4, 3)).astype(np.float32)}
    b = {"tlogw": tlogw.copy(), "pose": a["pose"].copy()}
    b["tlogw"][0, 7] += 1e-6             # the CPU picks particle 7, the card 0
    b["pose"][0] += 0.1
    out = check_parity.compare_estimates(a, b)
    assert out["ok"] and (out["same_pick"], out["ties"]) == (3, 1)
    b["pose"][2] += 2e-5                 # the same pick, 2e-5 apart
    assert not check_parity.compare_estimates(a, b)["ok"]
    b["pose"][2] -= 2e-5
    b["tlogw"][1, 3] = b["tlogw"][1].max() + 1.0     # another pick, no tie
    out = check_parity.compare_estimates(a, b)
    assert not out["ok"] and out["tick"] == 1


def script_bars():
    """The (field, bar) lists and the flip bar of the script's ``main``."""
    tree = ast.parse(open(SCRIPT).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    lists = [ast.literal_eval(n.iter) for n in ast.walk(main)
             if isinstance(n, ast.For) and isinstance(n.iter, ast.List)]
    flips = [ast.literal_eval(n.comparators[0]) for n in ast.walk(main)
             if isinstance(n, ast.Compare) and isinstance(n.left, ast.Name)
             and n.left.id in ("flip_frac", "big")]
    return lists, flips


def test_bars_are_the_scripts():
    (motion, fs2), flips = script_bars()
    assert dict(motion) == check_parity.MOTION_BARS
    assert dict(fs2) == check_parity.FS2_BARS
    assert flips == [check_parity.FLIP_BAR, check_parity.OVER_BAR]
    assert check_parity.MEASUREMENTS == [(2.0 + 0.3 * i, -2.5 + 0.35 * i) for i in range(16)]
    assert (check_parity.MOTION_PARTICLES, check_parity.FS2_PARTICLES) == (800, 1024)


def test_every_check_runs_on_the_cpu_and_counts_no_launch(capsys):
    todo = [("motion", 64, "steps"), ("fs2", 64, "steps"), ("motion", 96, "ticks"),
            ("fs2", 96, "ticks"), ("motion_chunked", 64, "chunk"), ("fs2_chunked", 64, "chunk")]
    results = check_parity.run("cpu", todo=todo)
    assert [r["ok"] for r in results] == [True] * 6
    assert all(r["launches"] == {} and r["device"] == "cpu" for r in results)
    assert len(results[2]["per_tick"]) == check_parity.STEPS
    assert len(capsys.readouterr().out.splitlines()) == 6
    assert [(c, f) for c, _, f in check_parity.checks()] == [
        ("motion", "steps"), ("fs2", "steps"), ("motion", "steps"), ("fs2", "ticks"),
        ("motion_chunked", "chunk"), ("fs2_chunked", "chunk")]
