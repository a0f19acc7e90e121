"""The benchmark command (``fastslam_tpu_torch.bench``) on the CPU at a
small size (P=256, L=16, M=8, C=4): its JSON line against ``bench.py``'s
keys, the update count, its chunked loop against K calls of the port's
chunked step and of JAX's (JAX's draws replayed, Pallas in interpret mode),
its end-to-end loop against K calls of the frontend and the per-tick step,
its oracle calls against ``bench.py``'s on ``tests/oracle/numpy_oracle.py``,
and the stale-pin warning."""

import ast
import dataclasses
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastslam_tpu.config import FastSLAMConfig as JaxConfig
from fastslam_tpu.core import kernels as jax_kernels
from fastslam_tpu.core import state as jax_state_mod

from fastslam_tpu_torch import bench
from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import kernels
from fastslam_tpu_torch.core.state import Measurements, init_planes_state, pad_measurements
from fastslam_tpu_torch.eval import oracle as port_oracle
from fastslam_tpu_torch.interop import planes_state_from_numpy, planes_state_to_numpy
from fastslam_tpu_torch.probes import step as step_probe
from tests.test_torch_step import assert_away_from_grid, assert_states_match, jax_draws

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# at L=8, M=4 no measurement of bench.py's set ever matches a landmark, so
# the weights stay uniform; at L=16, M=8 they part and the boundary resamples
P, L, M, C = 256, 16, 8, 4
SMALL = dict(num_particles=P, num_landmarks=L, num_measurements=M, device="cpu")
# bench.py is a script, not a package module
_spec = importlib.util.spec_from_file_location("_bench_script", os.path.join(REPO, "bench.py"))
BENCH_SCRIPT = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(BENCH_SCRIPT)


def bench_py_keys():
    """The keys of the dict ``bench.py:main`` hands to ``json.dumps``."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    call = next(n for n in ast.walk(main) if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute) and n.func.attr == "dumps")
    return {k.value for k in call.args[0].keys}


def run_main(capsys, monkeypatch):
    assert bench.main(["--device", "cpu"], num_particles=P, num_landmarks=L,
                      num_measurements=M, chunk=C, num_steps=2 * C, e2e_steps=4,
                      oracle_particles=20) == 0
    return capsys.readouterr()


def test_json_line_has_bench_py_keys(capsys, monkeypatch):
    out = run_main(capsys, monkeypatch)
    lines = out.out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    want = bench_py_keys() | {"device", "power_limit_w", "launches"}
    assert len(bench_py_keys()) == 13
    assert want <= set(rec), want - set(rec)
    assert rec["metric"] == "particle updates/s/chip at 100k particles"
    assert rec["unit"] == "updates/s" and rec["device"] == "cpu"
    assert rec["baseline_updates_per_s"] == bench.ORACLE_BASELINE_UPDATES_PER_S > 0
    assert len(rec["windows"]) == 3 and len(rec["fs2_windows"]) == 2
    assert rec["step_seconds"] == min(rec["windows"])
    assert rec["fs2_step_seconds"] == min(rec["fs2_windows"])
    for key in ("value", "vs_baseline", "fs2_updates_per_s", "e2e_frames_per_s",
                "baseline_updates_per_s_measured"):
        assert np.isfinite(rec[key]) and rec[key] > 0, key
    assert rec["launches"] == {}      # the plain versions launch no kernel


@pytest.mark.parametrize("measured,stale", [(499, True), (500, False), (2000, False),
                                            (2001, True)])
def test_stale_pin_warns_and_prints_one_line(capsys, monkeypatch, measured, stale):
    """A live oracle rate outside x0.5-x2 of the pin (here 1000) sets
    ``baseline_pin_stale`` and warns on stderr; stdout holds one line
    either way.  The windows' results are fixed: only the pin is tested."""
    monkeypatch.setattr(bench, "ORACLE_BASELINE_UPDATES_PER_S", 1000)
    monkeypatch.setattr(bench, "bench_chunked", lambda *a, **k: (1e6, 1e-3))
    monkeypatch.setattr(bench, "bench_e2e", lambda *a, **k: 100.0)
    monkeypatch.setattr(bench, "bench_oracle_baseline", lambda **k: float(measured))
    out = run_main(capsys, monkeypatch)
    lines = out.out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["baseline_pin_stale"] is stale
    assert rec["baseline_updates_per_s_measured"] == measured
    assert rec["vs_baseline"] == 1000.0
    assert ("WARNING: measured oracle baseline" in out.err) is stale
    if stale:
        assert f"{measured} updates/s deviates >2x from the pinned 1000" in out.err


@pytest.mark.parametrize("num_steps,chunk,ticks", [(13, 4, 12), (16, 4, 16), (7, 4, 4),
                                                  (768, 16, 768), (770, 16, 768)])
def test_steps_rounded_to_whole_chunks(monkeypatch, num_steps, chunk, ticks):
    monkeypatch.setattr(bench, "time_window",
                        lambda loop, device, reps, budget_s: bench.Window(2.0, None, None))
    loop, n = bench.chunked_loop(num_steps, chunk, "motion", **SMALL)
    assert n == ticks and loop.k == ticks // chunk and loop.ticks_per_step == chunk
    ups, step_s = bench.bench_chunked(num_steps, chunk, "motion", 1, 1.0, **SMALL)
    assert ups == P * M * ticks / 2.0
    assert step_s == 2.0 / ticks


def test_chunked_loop_refuses_less_than_a_chunk():
    with pytest.raises(ValueError, match="less than one chunk"):
        bench.chunked_loop(3, 4, "motion", **SMALL)
    with pytest.raises(ValueError, match="proposal"):
        bench.chunked_loop(8, 4, "icp", **SMALL)


def config(fs2=False):
    return FastSLAMConfig(num_particles=P, max_landmarks=L, max_measurements=M,
                          parity_mode=False, proposal_mode="fastslam2" if fs2 else "motion")


def same(got, want):
    for name, v in vars(want).items():
        g = getattr(got, name)
        assert (v is None) == (g is None), name
        if v is not None:
            assert torch.equal(g, v), name


@pytest.mark.parametrize("proposal", ["motion", "fastslam2"])
def test_chunked_window_equals_k_calls(proposal):
    """The window's reference and its two repetitions, each going on from
    the last with new draws, equal 3 x K calls of the chunked step."""
    k, fs2 = 3, proposal == "fastslam2"
    loop, _ = bench.chunked_loop(k * C, C, proposal, **SMALL)
    win = bench.time_window(loop, "cpu", reps=2, budget_s=60.0)

    cfg = config(fs2)
    ms = pad_measurements(cfg, step_probe.bench_measurements(M), "cpu")
    zc = Measurements(ms.range_bearing[None].repeat(C, 1, 1), ms.valid[None].repeat(C, 1))
    draws = step_probe.static_draws(k, P, "cpu", chunk=C, fs2=fs2)
    holder = step_probe.Loop(None, None, k, P, draws)
    gen = torch.Generator().manual_seed(step_probe.SEED)
    state = init_planes_state(cfg, "cpu")
    for seed in (step_probe.SEED, step_probe.SEED + 1, None):   # reference, rep 1, rep 2
        if seed is not None:
            gen.manual_seed(seed)
        step_probe.fill_draws(holder, gen)
        for i in range(k):
            state, est = kernels.fastslam_steps_planes_chunked(
                state, torch.zeros(C), torch.full((C,), 0.4), zc, cfg,
                step_probe.tick_draws(draws, i))
    same(win.state, state)
    assert torch.equal(win.out, est[-1])
    assert state.log_weights.std() > 0.1       # the weights parted in the last chunk


def test_chunked_motion_equals_jax():
    """K chunks of the bench's motion loop with JAX's draws replayed equal
    K calls of JAX's ``fastslam_steps_planes_chunked`` (Pallas in interpret
    mode): integers exact, floats within 1e-5."""
    k = 3
    jcfg = JaxConfig(num_particles=P, max_landmarks=L, max_measurements=M, parity_mode=False,
                     use_pallas=True, pallas_interpret=True)
    loop, _ = bench.chunked_loop(k * C, C, "motion", **SMALL)
    js = jax_state_mod.init_planes_state(jcfg, rng=0)
    np_init = planes_state_to_numpy(loop.state)
    for name, v in np_init.items():       # the same initial state
        if v is not None:
            np.testing.assert_array_equal(v, np.asarray(getattr(js, name)), err_msg=name)
    jms = jax_state_mod.pad_measurements(jcfg, step_probe.bench_measurements(M))
    jmc = jax_state_mod.Measurements(jnp.tile(jms.range_bearing[None], (C, 1, 1)),
                                     jnp.tile(jms.valid[None], (C, 1)))
    rots, trans = jnp.zeros(C, jnp.float32), jnp.full(C, 0.4, jnp.float32)
    resamples = 0
    for i in range(k):
        d = jax_draws(js, (C, P))
        loop.draws.rot[i], loop.draws.trans[i], loop.draws.u0[i] = d.rot, d.trans, d.u0
        pre, _ = jax_kernels.fastslam_steps_planes_chunked(
            js, rots, trans, jmc, jcfg.replace(resample_threshold_frac=0.0))
        js, jest = jax_kernels.fastslam_steps_planes_chunked(js, rots, trans, jmc, jcfg)
        if np.allclose(np.asarray(js.log_weights), -np.log(P)):   # this boundary resampled
            assert_away_from_grid(pre.log_weights, d.u0)
            resamples += 1
    assert resamples >= 1
    state, out = step_probe.run_steps(loop, loop.state.clone())
    assert_states_match(state, js, tol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jest[-1]), rtol=1e-5, atol=1e-5)
    # the initial state the JAX comparison started from is the bench's own
    same(loop.state, planes_state_from_numpy(np_init, "cpu"))


def test_e2e_window_equals_k_calls():
    """The e2e window (reference, then one repetition with new draws)
    equals 2 x K ticks of ``scan_to_measurements`` + ``fastslam_step_planes``
    in production."""
    from fastslam_tpu_torch.frontend.pipeline import scan_to_measurements

    k = 4
    win = bench.time_window(bench.e2e_loop(k, P, "cpu"), "cpu", reps=1, budget_s=60.0)
    cfg = FastSLAMConfig(num_particles=P, max_landmarks=64, max_measurements=16,
                         parity_mode=False)
    pts, vld, rots, trs = step_probe.make_scan_inputs(k, cfg)
    draws = step_probe.static_draws(k, P, "cpu")
    holder = step_probe.Loop(None, None, k, P, draws)
    gen = torch.Generator().manual_seed(step_probe.SEED)
    state = init_planes_state(cfg, "cpu")
    for seed in (step_probe.SEED, step_probe.SEED + 1):
        gen.manual_seed(seed)
        step_probe.fill_draws(holder, gen)
        for i in range(k):
            state, pose = kernels.fastslam_step_planes(
                state, rots[i], trs[i], scan_to_measurements(pts[i], vld[i], cfg), cfg,
                step_probe.tick_draws(draws, i))
    same(win.state, state)
    assert torch.equal(win.out, pose)


def particles_equal(a, b):
    assert len(a) == len(b)
    for pa, pb in zip(a, b):
        assert (pa.x, pa.y, pa.yaw, pa.weight) == (pb.x, pb.y, pb.yaw, pb.weight)
        assert len(pa.landmarks) == len(pb.landmarks)
        for la, lb in zip(pa.landmarks, pb.landmarks):
            assert (la.x, la.y) == (lb.x, lb.y)
            np.testing.assert_array_equal(la.cov, lb.cov)


def test_oracle_calls_equal_bench_py(monkeypatch):
    """``bench.py:bench_oracle_baseline``'s calls on
    ``tests/oracle/numpy_oracle.py`` and the port's on ``eval/oracle.py``
    leave the same particles, bit for bit."""
    from oracle import numpy_oracle

    made = []
    make = numpy_oracle.make_particles
    monkeypatch.setattr(numpy_oracle, "make_particles", lambda n: made.append(make(n)) or made[-1])
    assert BENCH_SCRIPT.bench_oracle_baseline(num_ticks=2, num_particles=30) > 0
    got, rate = bench.oracle_run(port_oracle, num_ticks=2, num_particles=30)
    assert rate > 0 and len(made) == 1
    particles_equal(got, made[0])
    assert any(p.landmarks for p in got)


def test_dataclass_fields_of_the_oracles_match():
    from oracle import numpy_oracle

    for name in ("OracleParticle", "OracleLandmark"):
        assert ([f.name for f in dataclasses.fields(getattr(port_oracle, name))]
                == [f.name for f in dataclasses.fields(getattr(numpy_oracle, name))])


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([], num_particles=P, num_landmarks=L,
                   num_measurements=M, chunk=C, num_steps=C, e2e_steps=2)
