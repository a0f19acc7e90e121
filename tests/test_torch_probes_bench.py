"""The measurement commands on the CPU at small sizes: ``probes.step``
(every path's keys and name, its state against K calls of the step),
``probes.e2e_attribution`` (``make_scan_inputs`` against the script's bit
for bit; the record's keys), ``probes.compare`` (the composed plain step
against ``kernels.fastslam_step`` bit for bit; the record) and
``probes.scaling`` (the rows and keys ``scripts/bench_scaling.py --virtual
4`` prints at the same arguments)."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import kernels
from fastslam_tpu_torch.core.state import (
    Measurements, init_planes_state, init_state, pad_measurements,
)
from fastslam_tpu_torch.probes import compare, e2e_attribution, scaling, step

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--particles", "256", "--landmarks", "8", "--measurements", "4", "--k", "3",
         "--device", "cpu"]
# the script's keys (scripts/bench_step.py:239-259; compile_s renamed) and the port's
STEP_KEYS = {"path", "step_ms", "particles", "updates_per_s", "valid_measurements",
             "build_and_capture_s", "final_pose_x", "eager_step_ms", "draws", "device",
             "power_limit_w"}
PATHS = {   # flags -> the script's path name
    (): "scan",
    ("--planes",): "planes",
    ("--fused-only",): "planes+fusedonly",
    ("--chunk", "4"): "chunked4+prod",
    ("--chunk", "4", "--fs2"): "chunked4+fs2+prod",
    ("--planes", "--with-frontend"): "planes+frontend",
    ("--with-frontend",): "scan+frontend",
    ("--fs2",): "scan+fs2+prod",
    ("--planes", "--fs2"): "planes+fs2+prod",
    ("--planes", "--production", "--no-resample"): "planes+prod+nores",
}


@pytest.mark.parametrize("flags", list(PATHS), ids=list(PATHS.values()))
def test_step_paths_print_the_scripts_keys(flags, capsys):
    assert step.main(SMALL + list(flags)) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = STEP_KEYS | ({"frames_per_s"} if "--with-frontend" in flags else set())
    assert want <= set(rec), want - set(rec)
    assert rec["path"] == PATHS[flags]
    assert rec["device"] == "cpu" and rec["draws"] == "eager" and rec["graph"] is False
    assert rec["particles"] == 256 and rec["valid_measurements"] == 4
    assert np.isfinite(rec["step_ms"]) and rec["step_ms"] > 0
    assert rec["eager_step_ms"] == rec["step_ms"]


def test_step_refuses_mislabelled_combinations():
    for flags in (["--with-frontend", "--chunk", "4"], ["--with-frontend", "--fused-only"],
                  ["--fused-only", "--fs2"], ["--fused-only", "--chunk", "4"]):
        with pytest.raises(SystemExit):
            step.parse(SMALL + flags)


def k_calls(args):
    """K calls of the step the path names, from its initial state with the
    probe's draws (seed ``step.SEED``), composed from the public functions."""
    cfg = step.config_of(args)
    k = args.k
    ms = pad_measurements(cfg, step.bench_measurements(args.measurements), "cpu")
    loop = step.build_loop(args, "cpu")
    step.fill_draws(loop, torch.Generator().manual_seed(step.SEED))
    d = lambda i: step.tick_draws(loop.draws, i)
    if args.with_frontend:
        from fastslam_tpu_torch.frontend.pipeline import scan_to_measurements

        pts, vld, rots, trs = e2e_attribution.make_scan_inputs(k, cfg)
        state = init_planes_state(cfg, "cpu")
        for i in range(k):
            state, pose = kernels.fastslam_step_planes(
                state, rots[i], trs[i], scan_to_measurements(pts[i], vld[i], cfg), cfg, d(i))
        return state, pose
    if args.chunk:
        c = args.chunk
        state = init_planes_state(cfg, "cpu")
        zc = Measurements(ms.range_bearing[None].repeat(c, 1, 1), ms.valid[None].repeat(c, 1))
        for i in range(k):
            state, est = kernels.fastslam_steps_planes_chunked(
                state, torch.zeros(c), torch.full((c,), 0.4), zc, cfg, d(i))
        return state, est[-1]
    if args.planes:
        state = init_planes_state(cfg, "cpu")
        for i in range(k):
            state, pose = kernels.fastslam_step_planes(state, 0.0, 0.4, ms, cfg, d(i))
        return state, pose
    state = init_state(cfg, "cpu")
    for i in range(k):
        state, pose = kernels.fastslam_step(state, 0.0, 0.4, ms, cfg, d(i))
    return state, pose


@pytest.mark.parametrize("flags", [(), ("--planes",), ("--chunk", "4"),
                                   ("--chunk", "4", "--fs2"), ("--planes", "--fs2"),
                                   ("--planes", "--with-frontend")],
                         ids=["scan", "planes", "chunked", "chunked+fs2", "planes+fs2",
                              "planes+frontend"])
def test_step_state_equals_k_calls(flags):
    args = step.parse(SMALL + list(flags))
    res = step.run(args)["_"]
    want_state, want_pose = k_calls(args)
    for name, v in vars(want_state).items():
        got = getattr(res["state"], name)
        assert (v is None) == (got is None), name
        if v is not None:
            assert torch.equal(got, v), name
    assert torch.equal(res["out"], want_pose)


def script_module(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_scan_inputs_equals_the_scripts():
    from fastslam_tpu.config import FastSLAMConfig as JaxConfig

    want = script_module("bench_e2e_attribution").make_scan_inputs(16, JaxConfig())
    got = e2e_attribution.make_scan_inputs(16, FastSLAMConfig())
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.numpy().shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


def test_e2e_attribution_record(tmp_path):
    out = tmp_path / "e2e.json"
    rec = e2e_attribution.run("cpu", particles=256, ks=(2, 4), out_path=str(out))
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    for key in ("e2e_ms_per_tick_by_k", "per_tick_ms_asymptotic", "per_dispatch_overhead_ms",
                "frontend_ms_per_tick", "filter_ms_per_tick", "note", "fused_tick",
                "device", "power_limit_w"):
        assert key in rec, key
    assert set(rec["e2e_ms_per_tick_by_k"]) == {2, 4}
    tick = rec["fused_tick"]
    assert tick["ticks"] == 4 and tick["graph_replays"] == 0
    assert tick["device_ms_per_replay"] is None and rec["device"] == "cpu"
    assert tick["wall_ms_p90"] >= tick["wall_ms_median"] > 0


@pytest.mark.parametrize("mode", ["parity", "production", "fs2"])
def test_compare_plain_step_equals_fastslam_step(mode):
    cfg = FastSLAMConfig(num_particles=128, max_landmarks=8, max_measurements=4,
                         parity_mode=mode == "parity",
                         proposal_mode="fastslam2" if mode == "fs2" else "motion")
    ms = pad_measurements(cfg, step.bench_measurements(4), "cpu")
    gen = torch.Generator().manual_seed(3)
    a = b = init_state(cfg, "cpu")
    for _ in range(3):
        draws = kernels.draw(gen, 128, fs2=mode == "fs2")
        a, pa = compare.plain_step(a, 0.0, 0.4, ms, cfg, draws)
        b, pb = kernels.fastslam_step(b, 0.0, 0.4, ms, cfg, draws)
        for name, v in vars(b).items():
            assert torch.equal(getattr(a, name), v), name
        assert torch.equal(pa, pb)


def test_compare_record(capsys):
    assert compare.main(["--device", "cpu", "--particles", "128", "--landmarks", "8",
                         "--measurements", "4", "--steps", "1", "--plain-steps", "1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec["blocks_step"]) == {"kernel", "plain"}
    for r in rec["blocks_step"].values():
        assert {"step_ms", "updates_per_s", "pose", "lm_count0"} <= set(r)
    # on the CPU both sides of a pair are the plain version
    assert rec["blocks_step"]["kernel"]["pose"] == rec["blocks_step"]["plain"]["pose"]
    assert [r["row"] for r in rec["planes_kernels"]] == [1, 2, 3, 4]
    assert all(r["max_abs_diff"] == 0.0 for r in rec["planes_kernels"])
    resample = rec["resample"]
    assert resample["max_abs_diff"] == 0.0
    assert set(resample["ms"]) == set(resample["bound_ms"]) == {"due", "not_due"}
    assert resample["bound_ms"]["not_due"] == 0.0
    assert rec["device"] == "cpu" and rec["power_limit_w"] is None


def json_lines(text):
    return [json.loads(line) for line in text.strip().splitlines() if line.startswith("{")]


def test_scaling_rows_match_the_scripts(capsys):
    script = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "bench_scaling.py"), "--virtual", "4",
         "--per-device", "256", "--steps", "2"],
        cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True, text=True,
        timeout=600, check=True)
    want = json_lines(script.stdout)
    assert scaling.main(["--device", "cpu", "--shards", "4", "--per-device", "256",
                         "--steps", "2", "--chunk", "4"]) == 0
    got = json_lines(capsys.readouterr().out)
    want_rows, got_rows = want[:-1], [r for r in got[:-1] if r["step"] == "blocks"]
    assert [(r["devices"], r["particles"]) for r in got_rows] == \
        [(r["devices"], r["particles"]) for r in want_rows] == [(1, 256), (2, 512), (4, 1024)]
    for g, w in zip(got_rows, want_rows):
        assert set(w) <= set(g), set(w) - set(g)
        assert g["equal_to_one_shard"] and g["label"] == scaling.LABEL
    assert set(want[-1]) <= set(got[-1]) and len(got[-1]["scaling"]) == len(want[-1]["scaling"])
    chunked = got[-1]["scaling_chunked"]
    assert [r["step"] for r in chunked] == ["chunked4"] * 3
    assert chunked[0]["weak_scaling_efficiency"] == 1.0


def test_shard_counts():
    assert scaling.shard_counts(8) == [1, 2, 4, 8]
    assert scaling.shard_counts(6) == [1, 2, 4]
    assert scaling.shard_counts(1) == [1]
