"""The online loop's production hooks (``app/runner.py:ProductionHooks``) on
the CPU: inside ``run_driver`` against a pinned copy of the loop with the
hooks written out inline (the same estimates, files and records bit for
bit); each checkpoint and snapshot against the benchmark's plain reference
of the hooks' files; the hooks' rows and counters only under a profiler
session; ``run`` and ``sim`` with the hook flags equal to ``run_driver``."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import hooks as rh
from fastslam_tpu_torch.app import cli
from fastslam_tpu_torch.app.runner import ProductionHooks, SLAMRunner, run_driver
from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.drivers.replay import ReplayDriver, record_log
from fastslam_tpu_torch.drivers.sim_world import SimWorld
from fastslam_tpu_torch.eval.metrics import evaluate_tick
from fastslam_tpu_torch.frontend.global_map import cluster_known_landmarks
from fastslam_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from fastslam_tpu_torch.io.serializer import serialize_tick
from fastslam_tpu_torch.utils import profiling
from fastslam_tpu_torch.utils.health import HealthMonitor
from fastslam_tpu_torch.utils.logging_utils import MetricsLog

torch.set_num_threads(1)

TICKS = 24
FS2 = dict(proposal_mode="fastslam2", use_icp_proposal=True, adaptive_proposal_floors=True,
           icp_blend=0.0)


def config(p=64, **kw):
    return FastSLAMConfig(num_particles=p, max_landmarks=16, parity_mode=False,
                          warmup_iterations=6, **{**FS2, **kw})


@pytest.fixture(scope="module")
def drive():
    return record_log(SimWorld(seed=9), num_ticks=TICKS)


def files(tmp_path, tag):
    d = tmp_path / tag
    return dict(serialize_path=str(d / "fast_slam.json"), metrics_path=str(d / "metrics.jsonl"),
                checkpoint_path=str(d / "ck.npz"))


def pinned_run(log, cfg, *, serialize_path, metrics_path, checkpoint_path, serialize_every,
               checkpoint_every, rng=0):
    """The online loop with its hooks inline, as ``run_driver`` ran them
    before they moved into ``ProductionHooks`` (fused tick, a replay driver
    starting at the origin): health with recovery, the ``tick`` record, the
    snapshot, the checkpoint."""
    runner = SLAMRunner(cfg, rng, device="cpu")
    driver = ReplayDriver(log)
    monitor, metrics = HealthMonitor(cfg), MetricsLog(metrics_path)
    p0 = driver.get_pose()
    off = np.array([p0.x, p0.y, p0.yaw])
    c0, s0 = np.cos(-off[2]), np.sin(-off[2])
    prev_cmd, ests, ticks, running = (0.0, 0.0), [], 0, True
    while running:
        scan = driver.get_laser()
        points, valid = scan.to_points()
        cur_cmd = driver.commanded_velocity()
        v, w = prev_cmd
        prev_cmd = cur_cmd
        rotation, translation = runner.odometry(v, w, scan.timestamp)
        est = runner.tick_fused(points, valid, rotation, translation, v)
        gp = driver.get_pose()
        dx, dy = gp.x - off[0], gp.y - off[1]
        gt = np.array([c0 * dx - s0 * dy, s0 * dx + c0 * dy,
                       (gp.yaw - off[2] + np.pi) % (2 * np.pi) - np.pi])
        ests.append(est)
        ev = evaluate_tick(gt, est)
        rep = monitor.check(runner.state, est)
        if not rep.ok:
            metrics.write("health", tick=ticks, issues=rep.issues)
            if "nan_or_inf_state" in rep.issues:
                state, generator = monitor.recover(runner.state, est,
                                                   checkpoint_path=checkpoint_path)
                runner.set_state_blocks(state)
                if generator is not None:
                    runner.set_generator(generator)
        metrics.write("tick", tick=ticks, distance=ev.distance,
                      num_measurements=runner._last_num_measurements)
        if ticks % serialize_every == 0:
            cents, ok = cluster_known_landmarks(runner.state_blocks(), cfg)
            cents, ok = cents.cpu().numpy(), ok.cpu().numpy()
            serialize_tick(est, gt, runner.state.poses.cpu().numpy(),
                           [tuple(map(float, c)) for c in cents[ok]], ev.to_dict(),
                           path=serialize_path)
        if ticks and ticks % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, runner.state_blocks(), iteration=ticks,
                            robot_pose=runner.robot, generator=runner._generator)
        running = driver.step()
        ticks += 1
    metrics.close()
    return ests


def records(path):
    out = [json.loads(line) for line in open(path)]
    for r in out:
        r.pop("t")
    return out


def snapshot(path):
    data = json.load(open(path))
    data["results"].pop("timestamp")
    return data


def same_files(a: dict, b: dict):
    """The snapshots, the metrics records (but their clocks) and the
    checkpoints' arrays are equal."""
    assert snapshot(a["serialize_path"]) == snapshot(b["serialize_path"])
    assert records(a["metrics_path"]) == records(b["metrics_path"])
    za, zb = rh.read_npz(a["checkpoint_path"]), rh.read_npz(b["checkpoint_path"])
    assert za.keys() == zb.keys()
    for k in za:
        assert np.array_equal(za[k], zb[k]), k


def test_run_driver_hooks_equal_the_pinned_inline_hooks(drive, tmp_path):
    cfg = config()
    every = dict(serialize_every=3, checkpoint_every=10)
    want = pinned_run(drive, cfg, **files(tmp_path, "pinned"), **every)
    hist = run_driver(ReplayDriver(drive), cfg, rng=0, device="cpu", health=True,
                      **files(tmp_path, "hooks"), **every)
    assert np.array_equal(np.asarray(hist.est_poses), np.asarray(want))
    same_files(files(tmp_path, "pinned"), files(tmp_path, "hooks"))
    assert set(hist.stage_seconds) == {"tick", "health", "metrics", "serialize", "checkpoint"}
    assert len(records(files(tmp_path, "hooks")["metrics_path"])) == TICKS


def hooked_ticks(log, cfg, hooks, ticks):
    """``tick_fused`` then ``hooks.after_tick`` over the drive; after each
    tick whose hooks wrote a checkpoint or a snapshot, that file's bytes
    beside a copy of the state (planes), the estimate, the ground truth
    (the drive starts at the origin) and the generator."""
    runner = SLAMRunner(cfg, rng=3, device="cpu")
    driver, prev_cmd, written = ReplayDriver(log), (0.0, 0.0), []
    for t in range(ticks):
        scan = driver.get_laser()
        points, valid = scan.to_points()
        v, w = prev_cmd
        prev_cmd = driver.commanded_velocity()
        rot, tr = runner.odometry(v, w, scan.timestamp)
        est = runner.tick_fused(points, valid, rot, tr, v)
        gp = driver.get_pose()
        gt = np.array([gp.x, gp.y, gp.yaw])
        hooks.after_tick(runner, t, est, gt, evaluate_tick(gt, est))
        state = {k: v.clone() for k, v in runner.state.__dict__.items() if v is not None}
        for kind, path, last in (("checkpoint", hooks.checkpoint_path, hooks.last_checkpoint_tick),
                                 ("snapshot", hooks.serialize_path, hooks.last_snapshot_tick)):
            if last == t:
                written.append(dict(kind=kind, tick=t, bytes=open(path, "rb").read(),
                                    state=rh.host(state), est=est, gt=gt,
                                    robot=runner.robot.copy(),
                                    generator=runner._generator.get_state().numpy()))
        driver.step()
    return written


def test_checkpoints_and_snapshots_equal_the_plain_reference(drive, tmp_path):
    """At P = 256, a checkpoint every 4 ticks and a snapshot every 2: each
    checkpoint read back by the plain reference is the state of its tick bit
    for bit, and each snapshot's map is the plain DBSCAN's."""
    cfg = config(256)
    hooks = ProductionHooks(cfg, serialize_every=2, checkpoint_every=4,
                            serialize_path=str(tmp_path / "fast_slam.json"),
                            checkpoint_path=str(tmp_path / "ck.npz"))
    written = hooked_ticks(drive, cfg, hooks, 20)
    assert [w["tick"] for w in written if w["kind"] == "checkpoint"] == [4, 8, 12, 16]
    assert [w["tick"] for w in written if w["kind"] == "snapshot"] == list(range(0, 20, 2))
    landmarks = 0
    for w in written:
        path = tmp_path / f"{w['kind']}-{w['tick']}"
        path.write_bytes(w["bytes"])
        if w["kind"] == "checkpoint":
            assert rh.checkpoint_gap(str(path), w["state"], w["tick"], w["robot"],
                                     w["generator"]) == 0.0
            assert rh.checkpoint_gap(str(path), w["state"], w["tick"] + 1, w["robot"],
                                     w["generator"]) == np.inf
        else:
            map_gap, pose_gap = rh.snapshot_gaps(str(path), w["state"], w["est"], w["gt"],
                                                 cfg.viz_cluster_eps, cfg.viz_min_samples_frac)
            assert map_gap <= 1e-5 and pose_gap == 0.0
            got = json.loads(w["bytes"])["landmarks"]
            want = rh.global_map(w["state"]["lm_mx"], w["state"]["lm_my"],
                                 w["state"]["lm_count"], cfg.viz_cluster_eps,
                                 cfg.viz_min_samples_frac)
            assert len(got) == len(want)
            landmarks += len(got)
    assert landmarks > 0, "no snapshot held a landmark"
    state, meta = load_checkpoint(str(tmp_path / "ck.npz"), "cpu")
    assert meta["iteration"] == 16 and hooks.checkpoint_bytes > 0


def test_plain_dbscan_equals_the_program_on_random_maps():
    """The reference's DBSCAN against ``cluster_known_landmarks`` on maps
    with dense clusters, border points and noise."""
    from fastslam_tpu_torch.core.state import init_state

    cfg = config(100)
    for seed in range(4):
        g = torch.Generator().manual_seed(seed)
        st = init_state(cfg, "cpu")
        centres = torch.rand((6, 2), generator=g) * 8 - 4
        pick = torch.randint(0, 6, (100, 16), generator=g)
        mean = centres[pick] + 0.3 * torch.randn((100, 16, 2), generator=g)
        st = st.replace(lm_mean=mean, lm_count=torch.randint(0, 17, (100,), generator=g,
                                                             dtype=torch.int32))
        cents, ok = cluster_known_landmarks(st, cfg)
        got = cents[ok].numpy().astype(np.float64)
        want = rh.global_map(mean[..., 0].T.numpy(), mean[..., 1].T.numpy(),
                             st.lm_count.numpy(), cfg.viz_cluster_eps, cfg.viz_min_samples_frac)
        assert got.shape == want.shape and len(want) > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_hook_rows_and_counters_only_under_a_profiler(drive, tmp_path):
    cfg = config()
    profiling.HOOK_TRACE.clear()
    hooks = ProductionHooks(cfg, health=True, serialize_every=2, checkpoint_every=3,
                            **files(tmp_path, "rows"))
    runner = SLAMRunner(cfg, rng=0, device="cpu")
    est, gt = np.zeros(3), np.zeros(3)
    ev = evaluate_tick(gt, est)
    for t in range(3):
        hooks.after_tick(runner, t, est, gt, ev)
    assert profiling.HOOK_TRACE.rows() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for t in range(3, 5):
            hooks.after_tick(runner, t, est, gt, ev)
    hooks.close()
    rows = profiling.HOOK_TRACE.rows()
    profiling.HOOK_TRACE.clear()
    assert [r["key"] for r in rows] == [3, 4]
    names = lambda r: {n: parent for n, parent, _, _ in r["spans"]}
    assert names(rows[0]) == {"hook": None, "health": "hook", "metrics": "hook",
                              "checkpoint": "hook"}
    assert names(rows[1]) == {"hook": None, "health": "hook", "metrics": "hook",
                              "serialize": "hook"}
    assert rows[0]["counters"]["checkpoint_bytes"] == hooks.checkpoint_bytes > 0
    assert "snapshot_landmarks" in rows[1]["counters"] and "checkpoint_bytes" not in rows[1][
        "counters"]
    assert rows[1]["counters"]["last_checkpoint_tick"] == 3
    assert rows[1]["counters"]["last_snapshot_tick"] == 4
    assert rows[1]["counters"]["health_failed"] == hooks.health_failed
    keys = {e.key for e in prof.key_averages()}
    assert {"fastslam.hook", "fastslam.hook.health", "fastslam.hook.checkpoint",
            "fastslam.hook.serialize"} <= keys
    assert hooks.health_checks == 5 and hooks.last_checkpoint_tick == 3


def test_hooks_off_do_nothing(tmp_path):
    cfg = config()
    hooks = ProductionHooks(cfg)
    profiling.HOOK_TRACE.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        hooks.after_tick(SLAMRunner(cfg, device="cpu"), 0, np.zeros(3), np.zeros(3),
                         evaluate_tick(np.zeros(3), np.zeros(3)))
    assert hooks.seconds == {} and profiling.HOOK_TRACE.rows() == []


@pytest.mark.parametrize("command", ["sim", "run"])
def test_cli_hook_flags_are_run_driver_hooks(command, tmp_path, capsys):
    """``sim --production`` and ``run --production`` with the hook flags
    equal ``run_driver`` with the same hooks: metrics, files, records."""
    log_path = str(tmp_path / "log.npz")
    record_log(SimWorld(seed=2), num_ticks=12).save(log_path)
    from fastslam_tpu_torch.drivers.replay import LaserLog

    cfg = FastSLAMConfig(num_particles=32, max_landmarks=16, parity_mode=False,
                         warmup_iterations=4)
    ours = files(tmp_path, "cli")
    flags = ["--health", "--metrics", ours["metrics_path"], "--serialize",
             ours["serialize_path"], "--serialize-every", "3", "--checkpoint",
             ours["checkpoint_path"], "--checkpoint-every", "5"]
    small = ["--particles", "32", "--landmarks", "16", "--warmup", "4", "--seed", "2",
             "--device", "cpu", "--production"]
    argv = (["sim", "--ticks", "12"] if command == "sim" else ["run", "--log", log_path])
    capsys.readouterr()
    assert cli.main(argv + small + flags) == 0
    out = json.loads(capsys.readouterr().out)
    assert out.pop("device") == "cpu"
    driver = SimWorld(seed=2) if command == "sim" else ReplayDriver(LaserLog.load(log_path))
    hist = run_driver(driver, cfg, max_ticks=12, rng=2, device="cpu", health=True,
                      serialize_every=3, checkpoint_every=5, **files(tmp_path, "direct"))
    assert out == hist.metrics()
    same_files(ours, files(tmp_path, "direct"))


def test_cli_refuses_hooks_with_the_chunked_replay(tmp_path):
    log_path = str(tmp_path / "log.npz")
    record_log(SimWorld(seed=2), num_ticks=4).save(log_path)
    with pytest.raises(SystemExit, match="online loop"):
        cli.main(["run", "--log", log_path, "--chunk", "2", "--device", "cpu",
                  "--checkpoint", str(tmp_path / "ck.npz")])


def test_launcher_passes_the_hooks(tmp_path):
    """``deploy/launch_torch.sh`` with ``CHECKPOINT`` and ``SERIALIZE`` set
    runs the online loop with every hook on."""
    import os
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, SKIP_INSTALL="1", DEVICE="cpu", TICKS="201", PARTICLES="64",
               OUT=str(tmp_path), OMP_NUM_THREADS="1", CHECKPOINT=str(tmp_path / "ck.npz"),
               SERIALIZE=str(tmp_path / "fast_slam.json"))
    out = subprocess.run([os.path.join(repo, "deploy", "launch_torch.sh")], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=420)
    assert out.returncode == 0, out.stderr[-2000:]
    assert load_checkpoint(str(tmp_path / "ck.npz"), "cpu")[1]["iteration"] == 200
    assert len(records(tmp_path / "metrics.jsonl")) == 201
    assert snapshot(tmp_path / "fast_slam.json")["landmarks"] is not None
