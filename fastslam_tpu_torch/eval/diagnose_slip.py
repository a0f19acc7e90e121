"""Per-tick forensics of the wheel-slip rows (the counterpart of
``scripts/diagnose_slip.py``).

The online form replays one (seed, slip) cell of ``make_log``'s drive
through the fs2 + ICP + adaptive online loop (``SLAMRunner``, the fused tick
in production) with the adaptive stack's internals recorded every tick:
floors, dial, blends, the ICP-vs-command residuals, the true command error
derived from ground truth, and the pose error.  It writes
``eval_results/torch/slip_diag_seed<seed>_<tag>.json`` and prints a table
by windows of 25 ticks::

    python -m fastslam_tpu_torch.eval.diagnose_slip --seed 3 [--seed 7] \\
        [--particles 100] [--ticks 300] [--clean] [--range-noise 0.005] \\
        [--device cuda]

The trace form (``--trace``) instruments the accuracy matrix's row
``production chunked C=8 (N=100k, H100, JdeRobot, wheel slip)``: the
motion-proposal chunked replay of a JdeRobot trace (``replay_chunked``,
N=100,000, C=8, slip (0.02, 0.02)) and its slip oracle
(``eval/oracle_ate.run_oracle``, N=50), each on the row's own code path
(``eval/suite.py``).  Per tick it records the corrupted odometry each one
received, its slip draw, its error against the true motion and its
position error; the table compares them by windows of 25 ticks.  It writes
``eval_results/torch/slip_diag_<trace>_rng<rng>.json``::

    python -m fastslam_tpu_torch.eval.diagnose_slip \\
        --trace data/jderobot/corridor_seed3_300.jsonl --rngs 0 1 2

Both forms print one JSON line of results last, with the device's name and
power limit (``probes.device_fields``).  ``--device`` defaults to ``cuda``
and refuses to run without a card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from fastslam_tpu_torch.eval.oracle_ate import check_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RESULTS = os.path.join(REPO, "eval_results", "torch")

SLIP = (0.02, 0.02)
WINDOW = 25
# the accuracy matrix's JdeRobot slip row (eval/suite.py:section_jderobot)
TRACE_PARTICLES, TRACE_CHUNK, ORACLE_PARTICLES = 100_000, 8, 50

ONLINE_KEYS = (
    "tick", "type", "cmd_rot", "cmd_trans", "true_rot", "true_trans",
    "cmd_err_rot", "cmd_err_trans", "icp_ang", "icp_tx", "icp_ty",
    "sr_th", "sr_al", "lat", "floor_xy", "floor_th", "blend_xy",
    "blend_th", "bias_th", "dial", "est_err", "n_meas")


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def true_motion(gt: np.ndarray):
    """The true motion over (t-1, t] of start-frame ground truth ``[T, 3]``
    in the reference's rotation-XOR-translation terms: ``(rotation [T],
    translation [T])``, zero at tick 0."""
    rot = np.zeros(len(gt))
    trans = np.zeros(len(gt))
    rot[1:] = _wrap(np.diff(gt[:, 2]))
    trans[1:] = np.hypot(*np.diff(gt[:, :2], axis=0).T)
    return rot, trans


def run_instrumented(seed, particles=100, ticks=300, rng=0, odometry_noise=SLIP,
                     overrides=None, range_noise_std=0.005, device="cuda"):
    """``run_driver``'s replay loop with per-tick adaptive internals recorded
    (``scripts/diagnose_slip.py:run_instrumented``): the same record keys,
    plus ``ate``."""
    from fastslam_tpu_torch.app.runner import SLAMRunner
    from fastslam_tpu_torch.config import FastSLAMConfig
    from fastslam_tpu_torch.drivers.replay import ReplayDriver
    from fastslam_tpu_torch.eval.metrics import ate_rmse
    from fastslam_tpu_torch.eval.suite import make_log

    device = check_device(device)
    log, _ = make_log(seed, ticks, range_noise_std=range_noise_std)
    config = FastSLAMConfig(
        num_particles=particles, max_landmarks=64, warmup_iterations=150,
        parity_mode=False, proposal_mode="fastslam2", use_icp_proposal=True,
        adaptive_proposal_floors=True, **(overrides or {}),
    )
    driver = ReplayDriver(log)
    runner = SLAMRunner(config, rng, device=device)
    odo_rng = np.random.default_rng(123)

    p0 = driver.get_pose()
    off = np.array([p0.x, p0.y, p0.yaw])
    c0, s0 = np.cos(-off[2]), np.sin(-off[2])

    rec = {k: [] for k in ONLINE_KEYS}
    prev_gt = None
    prev_cmd = (0.0, 0.0)
    t = 0
    running = True
    est_poses, gts = [], []
    while running and t < ticks:
        scan = driver.get_laser()
        points, valid = scan.to_points()
        cur_cmd = driver.commanded_velocity()
        v, w = prev_cmd
        prev_cmd = cur_cmd
        rotation, translation = runner.odometry(v, w, scan.timestamp)
        if odometry_noise != (0.0, 0.0):
            if rotation != 0.0:
                rotation += odo_rng.normal(0.0, odometry_noise[0])
            if translation != 0.0:
                translation += odo_rng.normal(0.0, odometry_noise[1])

        if runner._fused is not None:
            est = runner.tick_fused(points, valid, rotation, translation, v)
        else:
            rot_u, trans_u = runner.icp_refine(points, valid, rotation, translation, v)
            est = runner.tick(points, valid, rot_u, trans_u)

        gp = driver.get_pose()
        dxy = np.array([gp.x, gp.y]) - off[:2]
        g = np.array([c0 * dxy[0] - s0 * dxy[1], s0 * dxy[0] + c0 * dxy[1],
                      _wrap(gp.yaw - off[2])])
        # the true motion over (t-1, t] in the reference's rotation-XOR-
        # translation convention (robot frame)
        if prev_gt is not None:
            true_rot = _wrap(g[2] - prev_gt[2])
            true_trans = float(np.hypot(*(g[:2] - prev_gt[:2])))
        else:
            true_rot, true_trans = 0.0, 0.0
        prev_gt = g

        se2 = runner._prev_se2
        rec["tick"].append(t)
        rec["type"].append(int(v != 0))
        rec["cmd_rot"].append(float(rotation))
        rec["cmd_trans"].append(float(translation))
        rec["true_rot"].append(float(true_rot))
        rec["true_trans"].append(float(true_trans))
        rec["cmd_err_rot"].append(float(rotation - true_rot))
        rec["cmd_err_trans"].append(float(translation - true_trans)
                                    if translation != 0.0 else 0.0)
        rec["icp_ang"].append(float(se2[0]))
        rec["icp_tx"].append(float(se2[1]))
        rec["icp_ty"].append(float(se2[2]))
        # the signed residuals the estimator saw this tick
        # (adaptive.se2_residuals' convention)
        rec["sr_th"].append(float(_wrap(-se2[0] - rotation)))
        rec["sr_al"].append(float(-(se2[1] + translation)))
        rec["lat"].append(float(se2[2]))
        rec["floor_xy"].append(float(runner._floor_xy))
        rec["floor_th"].append(float(runner._floor_th))
        rec["blend_xy"].append(float(runner._blend_xy))
        rec["blend_th"].append(float(runner._blend_th))
        rec["bias_th"].append(float(runner._bias_th))
        rec["dial"].append(float(runner._dial))
        rec["est_err"].append(float(np.hypot(*(np.asarray(est[:2]) - g[:2]))))
        rec["n_meas"].append(int(runner._last_num_measurements))
        est_poses.append(np.asarray(est, float).copy())
        gts.append(g.copy())

        running = driver.step()
        t += 1

    rec["ate"] = ate_rmse(np.asarray(gts)[:, :2], np.asarray(est_poses)[:, :2])
    return rec


def run_trace(path, rng=0, *, particles=TRACE_PARTICLES, chunk_size=TRACE_CHUNK,
              oracle_particles=ORACLE_PARTICLES, odometry_noise=SLIP, oracle=True,
              device="cuda"):
    """The JdeRobot slip row on the trace at ``path``, engine and oracle,
    tick by tick.

    The engine is ``replay_chunked`` (motion proposal, production) as
    ``eval/suite.py`` runs the row; the oracle ``run_oracle`` as the row's
    slip oracle (numpy seed 0 whatever ``rng``; ``oracle=False`` leaves it
    out).  Each one's odometry comes from the function its run calls
    (``app/runner.slipped_odometry``, ``eval/oracle_ate.oracle_odometry``),
    with and without the slip, so ``*_slip_*`` is the draw each tick got.

    Returns a dict of ``[T]`` lists (``tick``; ``true_rot``/``true_trans``;
    per side ``engine_``/``oracle_``: ``rot``, ``trans``, the slip draws
    ``slip_rot``/``slip_trans``, the errors against the true motion
    ``err_rot``/``err_trans``, the position error ``err`` and that of dead
    reckoning its odometry ``dr_err``), the engine's measurements per tick
    ``engine_n_meas``, and the scalars ``engine_ate``/``oracle_ate``."""
    from fastslam_tpu_torch.app.runner import replay_chunked, slipped_odometry
    from fastslam_tpu_torch.config import FastSLAMConfig
    from fastslam_tpu_torch.eval.metrics import ate_rmse
    from fastslam_tpu_torch.eval.oracle_ate import oracle_odometry, run_oracle, start_frame
    from fastslam_tpu_torch.io.jderobot_trace import load_hal_trace

    device = check_device(device)
    log = load_hal_trace(path)
    gt = start_frame(log.gt_poses)
    true_rot, true_trans = true_motion(gt)
    rec = {"tick": list(range(len(log))), "true_rot": true_rot.tolist(),
           "true_trans": true_trans.tolist()}
    sides = {"engine": (FastSLAMConfig(num_particles=particles, max_landmarks=64,
                                       warmup_iterations=150, parity_mode=False),
                        slipped_odometry)}
    if oracle:
        sides["oracle"] = (FastSLAMConfig(num_particles=oracle_particles, max_landmarks=64,
                                          warmup_iterations=150), oracle_odometry)
    for side, (cfg, odometry) in sides.items():
        rots, trans = (np.asarray(a, np.float64) for a in odometry(log, cfg, odometry_noise))
        clean_r, clean_t = (np.asarray(a, np.float64) for a in odometry(log, cfg))
        if side == "engine":   # eval/suite.py:run_estimates, chunked
            hist = replay_chunked(log, cfg, chunk_size=chunk_size, rng=rng, device=device,
                                  odometry_noise=odometry_noise)
            est = np.asarray(hist.est_poses)
            rec["engine_n_meas"] = list(hist.num_measurements)
        else:
            est = run_oracle(log, cfg, seed=0, odometry_noise=odometry_noise, device=device)
        rec.update({f"{side}_rot": rots.tolist(), f"{side}_trans": trans.tolist(),
                    f"{side}_slip_rot": (rots - clean_r).tolist(),
                    f"{side}_slip_trans": (trans - clean_t).tolist(),
                    f"{side}_err_rot": _wrap(rots - true_rot).tolist(),
                    f"{side}_err_trans": (trans - true_trans).tolist(),
                    f"{side}_err": np.hypot(*(est[:, :2] - gt[:, :2]).T).tolist(),
                    f"{side}_dr_err": np.hypot(*(dead_reckoning(rots, trans)[:, :2]
                                                 - gt[:, :2]).T).tolist(),
                    f"{side}_ate": ate_rmse(gt[:, :2], est[:, :2])})
    return rec


def summarize(rec, label, window=WINDOW):
    """The online form's table: where the error builds up, and what the
    estimator's knobs did there (``scripts/diagnose_slip.py:summarize``)."""
    e = np.asarray(rec["est_err"])
    ticks = np.asarray(rec["tick"])
    lines = [f"=== {label}: ATE {rec['ate']:.4f} ===",
             f"{'tick':>9} {'err':>7} {'floorXY':>8} {'floorTH':>8} "
             f"{'blend':>6} {'dial':>5} {'|cmdErrT|':>9} {'|cmdErrR|':>9} "
             f"{'|sr_al|':>8} {'rotTicks':>8}"]
    for lo in range(0, len(e), window):
        hi = min(lo + window, len(e))
        ktype = np.asarray(rec["type"][lo:hi])
        lines.append(f"{ticks[lo]:>4}-{ticks[hi - 1]:<4} "
                     f"{e[lo:hi].mean():7.3f} "
                     f"{np.mean(rec['floor_xy'][lo:hi]):8.4f} "
                     f"{np.mean(rec['floor_th'][lo:hi]):8.4f} "
                     f"{np.mean(rec['blend_xy'][lo:hi]):6.2f} "
                     f"{np.mean(rec['dial'][lo:hi]):5.2f} "
                     f"{np.mean(np.abs(rec['cmd_err_trans'][lo:hi])):9.4f} "
                     f"{np.mean(np.abs(rec['cmd_err_rot'][lo:hi])):9.4f} "
                     f"{np.mean(np.abs(rec['sr_al'][lo:hi])):8.4f} "
                     f"{int((ktype == 0).sum()):>8}")
    print("\n".join(lines))


def dead_reckoning(rots, trans) -> np.ndarray:
    """The ``[T, 3]`` poses of integrating rotation-XOR-translation
    odometry from the origin (the warmup's dead reckoning)."""
    pose, out = np.zeros(3), []
    for rot, tr in zip(rots, trans):
        pose[2] = _wrap(pose[2] + rot)
        pose[0] += tr * np.cos(pose[2])
        pose[1] += tr * np.sin(pose[2])
        out.append(pose.copy())
    return np.asarray(out)


def parting_ticks(rec, atol=1e-6):
    """The ticks where engine and oracle odometry differ by more than
    ``atol`` (the engine's odometry is float32, the oracle's float64),
    split by rule: ``pairing`` where the slip-free odometry differs (the
    engine pairs the scan of tick t with the command of t-1, the oracle with
    the command of t), ``draws`` where the slip draws differ."""
    part = lambda a, b: np.abs(np.asarray(a) - np.asarray(b)) > atol
    differ = (part(rec["engine_rot"], rec["oracle_rot"])
              | part(rec["engine_trans"], rec["oracle_trans"]))
    clean = lambda side, k: np.asarray(rec[f"{side}_{k}"]) - rec[f"{side}_slip_{k}"]
    pairing = (part(clean("engine", "rot"), clean("oracle", "rot"))
               | part(clean("engine", "trans"), clean("oracle", "trans")))
    # the draw each tick got, whichever component it landed on
    draw = lambda side: (np.asarray(rec[f"{side}_slip_rot"])
                         + np.asarray(rec[f"{side}_slip_trans"]))
    draws = part(draw("engine"), draw("oracle"))
    return {"differ": np.flatnonzero(differ).tolist(),
            "pairing": np.flatnonzero(pairing).tolist(),
            "draws": np.flatnonzero(draws).tolist()}


def trace_windows(rec, window=WINDOW):
    """The trace form's per-window rows: mean position error of each side
    and of dead reckoning its odometry, mean |odometry error| against the
    true motion (translation, rotation), the engine's mean measurements per
    tick, the ticks whose odometry parts, and the rotation ticks."""
    n = len(rec["tick"])
    parts = set(parting_ticks(rec)["differ"]) if "oracle_err" in rec else set()
    rows = []
    for lo in range(0, n, window):
        hi = min(lo + window, n)
        row = {"ticks": f"{lo}-{hi - 1}",
               "rot_ticks": int(np.sum(np.abs(rec["true_rot"][lo:hi]) > 1e-3))}
        for side in ("engine", "oracle"):
            if f"{side}_err" not in rec:
                continue
            row[f"{side}_err"] = float(np.mean(rec[f"{side}_err"][lo:hi]))
            row[f"{side}_dr_err"] = float(np.mean(rec[f"{side}_dr_err"][lo:hi]))
            row[f"{side}_odo_err_trans"] = float(np.mean(np.abs(rec[f"{side}_err_trans"][lo:hi])))
            row[f"{side}_odo_err_rot"] = float(np.mean(np.abs(rec[f"{side}_err_rot"][lo:hi])))
        row["engine_n_meas"] = float(np.mean(rec["engine_n_meas"][lo:hi]))
        row["parted"] = sum(lo <= t < hi for t in parts)
        rows.append(row)
    return rows


def print_trace_table(rows, label):
    """Print :func:`trace_windows`' rows."""
    sides = [side for side in ("engine", "oracle") if f"{side}_err" in rows[0]]
    head = f"{'tick':>9}" + "".join(
        f" {side[:3] + 'Err':>7} {side[:3] + 'DR':>7} {'|' + side[:3] + 'OdoT|':>9}"
        f" {'|' + side[:3] + 'OdoR|':>9}" for side in sides)
    lines = [f"=== {label} ===", head + f" {'nMeas':>5} {'parted':>6} {'rotTicks':>8}"]
    for r in rows:
        lines.append(f"{r['ticks']:>9}" + "".join(
            f" {r[side + '_err']:7.3f} {r[side + '_dr_err']:7.3f}"
            f" {r[side + '_odo_err_trans']:9.4f} {r[side + '_odo_err_rot']:9.4f}"
            for side in sides)
            + f" {r['engine_n_meas']:5.2f} {r['parted']:>6} {r['rot_ticks']:>8}")
    print("\n".join(lines))


def _jsonable(rec):
    """A record's values as JSON numbers: scalars as they are, the integer
    keys as ints, every other list as floats."""
    ints = ("type", "tick", "n_meas", "engine_n_meas")
    return {k: v if np.isscalar(v) else [int(x) if k in ints else float(x) for x in v]
            for k, v in rec.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fastslam_tpu_torch.eval.diagnose_slip")
    ap.add_argument("--seed", type=int, action="append", default=None)
    ap.add_argument("--particles", type=int, default=None,
                    help="the engine's particles (default 100; with --trace the "
                    "row's 100,000)")
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--clean", action="store_true", help="no slip (baseline internals)")
    ap.add_argument("--range-noise", type=float, default=0.005,
                    help="laser range noise std (the noise-table rows use 0.01/0.03)")
    ap.add_argument("--trace", default=None,
                    help="a JdeRobot trace (data/jderobot/*.jsonl): instrument the "
                    "chunked N=100k slip row and its oracle instead")
    ap.add_argument("--rngs", type=int, nargs="+", default=[0],
                    help="torch generator seeds of the engine (default 0)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--results-dir", default=RESULTS)
    args = ap.parse_args(argv)

    from fastslam_tpu_torch.probes import device_fields

    device = check_device(args.device)
    noise = (0.0, 0.0) if args.clean else SLIP
    os.makedirs(args.results_dir, exist_ok=True)
    summary = {"files": [], **device_fields(device)}
    if args.trace:
        name = os.path.basename(args.trace).replace(".jsonl", "")
        summary.update(trace=name, engine_ate={}, oracle_ate=None, parting=None)
        oracle_rec = None
        for rng in args.rngs:
            rec = run_trace(args.trace, rng, particles=args.particles or TRACE_PARTICLES,
                            odometry_noise=noise, device=device, oracle=oracle_rec is None)
            if oracle_rec is None:       # the oracle draws nothing from rng
                oracle_rec = {k: v for k, v in rec.items() if k.startswith("oracle_")}
                summary["oracle_ate"] = rec["oracle_ate"]
                summary["parting"] = parting_ticks(rec)
            rec.update(oracle_rec)
            rows = trace_windows(rec)
            print_trace_table(rows, f"{name} rng {rng}: engine ATE {rec['engine_ate']:.4f}, "
                                    f"oracle ATE {rec['oracle_ate']:.4f}")
            tag = "_clean" if args.clean else ""
            path = os.path.join(args.results_dir, f"slip_diag_{name}{tag}_rng{rng}.json")
            with open(path, "w") as f:
                json.dump(_jsonable(rec) | {"windows": rows}, f)
            summary["engine_ate"][rng] = rec["engine_ate"]
            summary["files"].append(os.path.relpath(path, REPO))
    else:
        summary["ate"] = {}
        for seed in args.seed or [3, 7]:
            for rng in args.rngs:
                rec = run_instrumented(seed, particles=args.particles or 100, ticks=args.ticks,
                                       rng=rng, odometry_noise=noise,
                                       range_noise_std=args.range_noise, device=device)
                tag = "clean" if args.clean else "slip"
                if args.range_noise != 0.005:
                    tag += f"_rn{args.range_noise}"
                if len(args.rngs) > 1 or rng != 0:
                    tag += f"_rng{rng}"
                path = os.path.join(args.results_dir, f"slip_diag_seed{seed}_{tag}.json")
                with open(path, "w") as f:
                    json.dump(_jsonable(rec), f)
                summarize(rec, f"seed {seed} {tag} N={args.particles or 100}")
                summary["ate"][f"seed{seed}_{tag}"] = rec["ate"]
                summary["files"].append(os.path.relpath(path, REPO))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
