"""The port's accuracy matrix against the JAX package's scripts.

``fastslam_tpu_torch/eval/oracle.py`` against ``tests/oracle/numpy_oracle.py``
(bit for bit, each public function and 30 seeded iterations), the port's
``make_log`` against ``scripts/eval_suite.make_log`` (array for array), its
``run_oracle`` against ``scripts/oracle_ate.run_oracle`` (within 1e-4, and
bit for bit on JAX's measurements), its ``run_mode`` against JAX's without
motion noise (per tick and chunked, ATE within 1e-4), and the sections'
row names, ``save`` and ``render`` against the JAX suite's results.

``warmup_iterations=8`` in the ``run_oracle`` and ``run_mode`` comparisons
(both suites use 150, which over 40-60 ticks would leave nothing but dead
reckoning): ``run_mode`` builds its config inside, so both packages'
``FastSLAMConfig`` are wrapped to force it.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import eval_suite as jax_suite  # noqa: E402
import oracle_ate as jax_oracle_ate  # noqa: E402
from oracle import numpy_oracle as jax_oracle  # noqa: E402

import fastslam_tpu.config as jax_config_module  # noqa: E402
from fastslam_tpu.app.runner import run_driver as jax_run_driver  # noqa: E402
from fastslam_tpu.drivers.replay import ReplayDriver as JaxReplayDriver  # noqa: E402
from fastslam_tpu.config import FastSLAMConfig as JaxConfig  # noqa: E402
from fastslam_tpu.frontend.pipeline import scan_to_measurements as jax_frontend  # noqa: E402

from fastslam_tpu_torch.config import FastSLAMConfig  # noqa: E402
from fastslam_tpu_torch.core import kernels  # noqa: E402
from fastslam_tpu_torch.core.state import Measurements  # noqa: E402
from fastslam_tpu_torch.eval.metrics import ate_rmse  # noqa: E402
from fastslam_tpu_torch.eval import oracle, oracle_ate, suite  # noqa: E402

torch.set_num_threads(1)

N = 16


def dump(particles):
    """Every number of a particle list, for exact comparison."""
    return [(p.x, p.y, p.yaw, p.weight,
             [(lm.x, lm.y, lm.cov.tolist()) for lm in p.landmarks]) for p in particles]


def seeded_particles(mod, seed, n=N, landmarks=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = mod.OracleParticle(*rng.normal(0, 0.3, 3), rng.uniform(0.01, 0.2))
        for _ in range(landmarks):
            a = rng.uniform(0.02, 0.2)
            p.landmarks.append(mod.OracleLandmark(*rng.uniform(-3, 3, 2),
                                                  np.array([[a, 0.01], [0.01, a]])))
        out.append(p)
    return out


def both(fn):
    """``fn(module)`` for the JAX package's oracle and the port's."""
    return fn(jax_oracle), fn(oracle)


def _move(mod):
    ps = seeded_particles(mod, 1)
    for i, p in enumerate(ps):
        mod.move_particle(p, 0.1 * (i % 2), 0.05, 0.003 * i, -0.002 * i)
    return dump(ps)


def _associate(mod):
    ps = seeded_particles(mod, 2, landmarks=5)
    rng = np.random.default_rng(3)
    obs = rng.uniform(-3, 3, (N, 2))
    return [mod.associate_first_match(o, p.landmarks, gate) for p, o in zip(ps, obs)
            for gate in (0.5, 8.0, 100.0)]


def _update(mod):
    ps = seeded_particles(mod, 4)
    rng = np.random.default_rng(5)
    for p in ps:
        lm = p.landmarks[1]   # a measurement of landmark 1, and one far from all
        dx, dy = lm.x - p.x, lm.y - p.y
        mod.update_particle(p, np.hypot(dx, dy) + rng.normal(0, 0.02),
                            np.arctan2(dy, dx) - p.yaw + rng.normal(0, 0.02))
        mod.update_particle(p, 40.0, 2.0)
    return dump(ps)


def _normalize(mod):
    out = []
    for scale in (1.0, 1e-7):
        ps = seeded_particles(mod, 6)
        for i, p in enumerate(ps):
            p.weight *= scale * (1e-6 if i % 5 == 0 else 1.0)
        mod.normalize_weights(ps)
        out.append(dump(ps))
    return out


def _neff(mod):
    ps = seeded_particles(mod, 7)
    mod.normalize_weights(ps)
    flat = seeded_particles(mod, 7)
    for p in flat:
        p.weight = 0.5 / N
    return mod.effective_particles(ps), mod.effective_particles(flat)


def _resample(mod):
    ps = seeded_particles(mod, 8)
    mod.normalize_weights(ps)
    return [mod.systematic_resample(ps, u0) for u0 in (0.0, 0.013, 1.0 / N - 1e-9)]


PUBLIC = {
    "make_particles": lambda mod: dump(mod.make_particles(N)),
    "wrap": lambda mod: [mod.wrap(a) for a in np.random.default_rng(0).uniform(-20, 20, 64)],
    "move_particle": _move,
    "mahalanobis": lambda mod: [mod.mahalanobis(np.array([0.3, -1.0]), b, np.array(
        [[0.2, 0.03], [0.03, 0.1]])) for b in np.random.default_rng(1).normal(0, 2, (16, 2))],
    "associate_first_match": _associate,
    "update_particle": _update,
    "normalize_weights": _normalize,
    "effective_particles": _neff,
    "systematic_resample": _resample,
    "estimate_pose": lambda mod: mod.estimate_pose(seeded_particles(mod, 9)),
}


@pytest.mark.parametrize("name", sorted(PUBLIC))
def test_oracle_function_equals_numpy_oracle(name):
    want, got = both(PUBLIC[name])
    assert got == want


def test_oracle_iterations_equal_numpy_oracle():
    """30 seeded iterations at N = 16: corners seen with noise, rotation and
    translation ticks, the resample taken on some."""
    rng = np.random.default_rng(11)
    corners = [(2.0, 0.3), (3.0, -0.8), (1.5, 1.2), (4.0, 0.0), (2.5, -1.4)]
    jax_ps, ps = both(lambda mod: mod.make_particles(N))
    resampled = 0
    for t in range(30):
        rotation, translation = (0.08, 0.0) if t % 6 == 5 else (0.0, 0.04)
        ms = [(d - 0.04 * t + rng.normal(0, 0.01), b + rng.normal(0, 0.01))
              for d, b in corners if rng.uniform() < 0.8]
        rot_noise = rng.normal(0, 0.001, N)
        trans_noise = rng.normal(0, 0.0055, N)
        u0 = float(rng.uniform(0, 1.0 / N))
        before = [id(p) for p in ps]
        want = jax_oracle.iterate(jax_ps, rotation, translation, ms, rot_noise, trans_noise, u0)
        got = oracle.iterate(ps, rotation, translation, ms, rot_noise, trans_noise, u0)
        resampled += before != [id(p) for p in ps]
        assert got == want
        assert dump(ps) == dump(jax_ps)
    assert resampled > 0


LOG_FIELDS = ("scans", "timestamps", "cmd_v", "cmd_w", "bumper_state", "bumper_id",
              "gt_poses")


@pytest.mark.parametrize("range_noise", [0.0, 0.01])
@pytest.mark.parametrize("seed", [3, 7, 21])
def test_make_log_equals_jax(seed, range_noise):
    want, want_gt = jax_suite.make_log(seed, 40, range_noise_std=range_noise)
    got, gt = suite.make_log(seed, 40, range_noise_std=range_noise)
    for name in LOG_FIELDS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (got.min_range, got.max_range) == (want.min_range, want.max_range)
    np.testing.assert_array_equal(gt, want_gt)


@pytest.fixture(scope="module")
def oracle_log():
    return suite.make_log(3, 40)


def oracle_configs():
    return (JaxConfig(num_particles=N, max_landmarks=64, warmup_iterations=20),
            FastSLAMConfig(num_particles=N, max_landmarks=64, warmup_iterations=20))


@pytest.mark.parametrize("slip", [(0.0, 0.0), (0.02, 0.02)])
def test_run_oracle_matches_jax(oracle_log, slip):
    log, gt = oracle_log
    jcfg, cfg = oracle_configs()
    want = jax_oracle_ate.run_oracle(log, jcfg, seed=0, odometry_noise=slip)
    got = oracle_ate.run_oracle(log, cfg, seed=0, odometry_noise=slip, device="cpu")
    assert got.shape == (40, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.abs(got[20:] - got[19]).max() > 0   # the filter's estimates after warmup


def test_run_oracle_bit_for_bit_on_jax_measurements(oracle_log, monkeypatch):
    """With the port's frontend call replaced by JAX's jitted frontend, the
    two replays are the same arithmetic: equal bit for bit."""
    log, _ = oracle_log
    jcfg, cfg = oracle_configs()
    frontend = jax.jit(lambda p, v: jax_frontend(p, v, jcfg))

    def jax_measurements(points, valid, config):
        ms = frontend(jnp.asarray(points.numpy()), jnp.asarray(valid.numpy()))
        return Measurements(range_bearing=torch.from_numpy(np.array(ms.range_bearing)),
                            valid=torch.from_numpy(np.array(ms.valid)))

    want = jax_oracle_ate.run_oracle(log, jcfg, seed=0)
    monkeypatch.setattr(oracle_ate, "scan_to_measurements", jax_measurements)
    got = oracle_ate.run_oracle(log, cfg, seed=0, device="cpu")
    np.testing.assert_array_equal(got, want)


def warmup_8(config_cls, monkeypatch, module, name="FastSLAMConfig"):
    def make(**kw):
        return config_cls(**{**kw, "warmup_iterations": 8})
    monkeypatch.setattr(module, name, make)


@pytest.mark.parametrize("chunked,parity", [(False, False), (False, True), (True, False)])
def test_run_mode_matches_jax_noise_free(monkeypatch, chunked, parity):
    """N = 64 over 60 ticks without motion noise: every particle stays the
    same, so the draws do not matter and both ATEs agree within 1e-4."""
    log, gt = suite.make_log(3, 60)
    warmup_8(JaxConfig, monkeypatch, jax_config_module)
    warmup_8(FastSLAMConfig, monkeypatch, suite)
    ov = dict(num_particles=64, parity_mode=parity, rotation_noise=0.0,
              translation_noise=0.0)
    jax_ov = dict(ov, use_pallas=True, pallas_interpret=True) if chunked else ov
    want = jax_suite.run_mode(log, gt, jax_ov, chunked=chunked)
    got = suite.run_mode(log, gt, ov, chunked=chunked, device="cpu")
    assert 0.0 < got < 0.3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_parity_row_is_jax_given_jax_draws(monkeypatch):
    """F6 (ROADMAP §3): the base section's ``parity (N=100)`` row at seed 3,
    300 ticks, with the port's draws replaced by JAX's (rng 0's key chain,
    ``jax.random.split(state.rng, 4)`` per tick as
    ``fastslam_tpu/core/kernels.py:758`` takes it): the port's estimates
    equal JAX's at every tick within 1e-6 and the ATE is EVAL.md's 0.120.
    The row's distance from JAX's mean on the card is the draws."""
    jax_log, _ = jax_suite.make_log(3, 300)
    want = np.asarray(jax_run_driver(
        JaxReplayDriver(jax_log), JaxConfig(num_particles=100, max_landmarks=64,
                                            warmup_iterations=150), rng=0).est_poses)
    key = [jax.random.key(0)]

    def jax_draw(generator, num_particles, num_ticks=None, *, fs2=False):
        assert num_ticks is None and not fs2
        key[0], k_rot, k_trans, k_u = jax.random.split(key[0], 4)
        normal = lambda k: torch.from_numpy(np.array(
            jax.random.normal(k, (num_particles,), jnp.float32)))
        return kernels.Draws(rot=normal(k_rot), trans=normal(k_trans), u0=torch.tensor(
            float(jax.random.uniform(k_u, (), jnp.float32, maxval=1.0 / num_particles))))

    monkeypatch.setattr(kernels, "draw", jax_draw)
    log, gt = suite.make_log(3, 300)
    got = suite.run_estimates(log, dict(num_particles=100), device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert round(ate_rmse(gt[:, :2], got[:, :2]), 3) == 0.120


def test_cuda_without_a_card_raises(monkeypatch, oracle_log):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        suite.parse_args(["--device", "cuda", "--sections", "base"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        oracle_ate.run_oracle(oracle_log[0], oracle_configs()[1], device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        suite.main(["--sections", "scale"])


def jax_rows(section):
    with open(os.path.join(REPO, "eval_results", f"{section}.json")) as f:
        return json.load(f)


def fake_section(section, device, monkeypatch):
    """Run ``section`` with its runners stubbed: each row's value says which
    row, seed and rng it came from."""
    calls = []

    def fake_mode(log, gt, overrides, *, rng=0, **kw):
        calls.append((overrides, kw))
        return 0.01 * (len(calls) % 7) + 0.001 * rng

    monkeypatch.setattr(suite, "run_mode", fake_mode)
    monkeypatch.setattr(suite, "run_oracle_row", lambda *a, **k: 0.15)
    monkeypatch.setattr(suite, "make_log", lambda seed, ticks, **kw: (None, None))
    args = suite.build_parser().parse_args(["--rngs", "0", "1"])
    args.device = torch.device(device)
    return suite.SECTIONS[section](args), calls


@pytest.mark.parametrize("section,device,stored", [
    ("base", "cuda", "base"), ("slip", "cuda", "slip"), ("noise", "cuda", "noise"),
    ("scale", "cuda", "scale"), ("jderobot", "cuda", "jderobot"),
    ("scale", "cpu", "scale_cpu"), ("jderobot", "cpu", "jderobot_cpu")])
def test_section_rows_are_jax_rows(section, device, stored, monkeypatch):
    """Each section names JAX's rows, "TPU" read as "H100", and asks for no
    retired field; no chunked row runs in parity mode (the port's chunked
    replay refuses it)."""
    (seeds, table), calls = fake_section(section, device, monkeypatch)
    want = jax_rows(stored)
    assert [n.replace("H100", "TPU") for n in table.rows] == list(want["rows"])
    assert all("TPU" not in n for n in table.rows)
    if section != "jderobot":
        n_seeds = len(seeds) if section != "scale" else 3
        assert all(len(v) == n_seeds for v in table.rows.values())
    else:
        assert seeds == ["corridor_seed3_300", "start_seed7_300"]
    for overrides, kw in calls:
        FastSLAMConfig(**overrides)   # every field exists in the port
        assert not (kw.get("chunked") and overrides.get("parity_mode", True))
    # every non-oracle row ran once per rng
    assert all(len(r) == 2 for name, v in table.rows.items() for r in v
               if not name.startswith("reference"))


def test_render_keeps_the_hand_written_findings(tmp_path):
    table = suite.Table(["reference equations (NumPy oracle, N=50)"])
    table.rows["reference equations (NumPy oracle, N=50)"] = [[0.15]]
    suite.save("base", [3], table, rngs=[0], device_tag="card", results_dir=str(tmp_path))
    out = tmp_path / "EVAL_TORCH.md"
    suite.render(str(out), results_dir=str(tmp_path))
    findings = f"{suite.KEPT}\n\n### F6 (b)\n\n| tick | err |\n|---|---|\n| 0-24 | 0.023 |\n"
    out.write_text(out.read_text() + "\n" + findings)
    for _ in range(2):
        suite.render(str(out), results_dir=str(tmp_path))
        text = out.read_text()
        assert text.endswith(findings) and text.count(suite.KEPT) == 1
        assert "| reference equations (NumPy oracle, N=50) |" in text


def test_save_and_render(tmp_path):
    """The JAX suite's JSON layout, the per-seed means over rngs, and JAX's
    mean beside each row of the rendered table."""
    table = suite.Table(["reference equations (NumPy oracle, N=50)",
                         "production (N=10k, H100 planes)",
                         "production chunked C=16 (N=100k, H100)"])
    table.rows["reference equations (NumPy oracle, N=50)"] = [[0.15], [0.13], [0.14]]
    table.rows["production (N=10k, H100 planes)"] = [[0.02, 0.04], [0.01, 0.01], [0.0, 0.3]]
    table.rows["production chunked C=16 (N=100k, H100)"] = [[0.01, 0.02]] * 3
    table.launches["production chunked C=16 (N=100k, H100)"] = {"fused_update_planes_multi": 114}
    path = suite.save("scale", [3, 7, 21], table, rngs=[0, 1], device_tag="card, 700.00 W",
                      results_dir=str(tmp_path))
    blob = json.load(open(path))
    jax_blob = jax_rows("scale")
    assert set(jax_blob) <= set(blob)
    assert blob["seeds"] == [3, 7, 21] and blob["rngs"] == [0, 1]
    assert blob["rows"]["production (N=10k, H100 planes)"] == pytest.approx([0.03, 0.01, 0.15])
    assert blob["runs"] == table.rows and blob["device"] == "card, 700.00 W"

    out = tmp_path / "EVAL_TORCH.md"
    suite.render(str(out), results_dir=str(tmp_path))
    text = out.read_text()
    assert "card, 700.00 W" in text and "rngs 0 1" in text
    for name, vals in table.rows.items():
        line = next(ln for ln in text.splitlines() if ln.startswith(f"| {name} |"))
        want = np.mean(jax_blob["rows"][name.replace("H100", "TPU")])
        assert f"| {want:.3f} |" in line
    planes = next(ln for ln in text.splitlines() if "N=10k, H100 planes" in ln)
    # rng means over seeds: rng 0 (0.02+0.01+0.0)/3 = 0.010, rng 1 0.117
    assert "| **0.063** | 0.010–0.117 |" in planes and "| yes |" in planes
    chunked = next(ln for ln in text.splitlines() if "C=16" in ln)
    assert "fused_update_planes_multi 114" in chunked


def test_row_checks_and_margin():
    rows = {"reference equations (NumPy oracle, N=50)": [0.1, 0.2],
            "parity (N=100)": [0.5, 0.5],
            "production (N=100)": [0.1, 0.1],
            "production+fs2 (N=100)": [0.3, 0.3],
            "reference equations (NumPy oracle, N=50, wheel slip)": [0.4],
            "production (N=100, wheel slip)": [0.3]}
    assert suite.row_checks(rows) == {
        "reference equations (NumPy oracle, N=50)": None, "parity (N=100)": None,
        "production (N=100)": True, "production+fs2 (N=100)": False,
        "reference equations (NumPy oracle, N=50, wheel slip)": None,
        "production (N=100, wheel slip)": True}
    assert suite.margin_fault(0.05, [0.04, 0.06], 0.02)
    assert not suite.margin_fault(0.05, [0.01, 0.06], 0.02)   # an rng reaches JAX
    assert not suite.margin_fault(0.025, [0.025], 0.02)        # within 0.01 m
    assert not suite.margin_fault(0.05, [0.05], None)
    assert suite.rng_means([[0.1, 0.3], [0.2]]) == pytest.approx([0.15, 0.25])


def test_scale_section_on_the_cpu(tmp_path):
    """``main`` end to end on the CPU at a small size: the scale section's one
    sanity row, stored as ``scale_cpu`` and rendered."""
    out = tmp_path / "EVAL_TORCH.md"
    assert suite.main(["--device", "cpu", "--sections", "scale", "--seeds", "3",
                       "--ticks", "24", "--results-dir", str(tmp_path),
                       "--out", str(out)]) == 0
    blob = json.load(open(tmp_path / "scale_cpu.json"))
    (vals,) = blob["rows"].values()
    assert blob["seeds"] == [3] and np.isfinite(vals).all()
    assert blob["device"].startswith("cpu")
    assert "North-star scale (CPU sanity)" in out.read_text()
