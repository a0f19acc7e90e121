"""The accuracy matrix of the port -> ``EVAL_TORCH.md``.

The counterpart of ``scripts/eval_suite.py``: the same worlds (seeds, start
poses, range noise), particle counts and modes (reference oracle, parity,
production, production + fs2, + ICP, + adaptive floors, chunked), run on the
port's engines, with each row's mean beside the JAX package's mean of the
same row (``eval_results/<section>.json``).  The standing bound is EVAL.md's
"match reference ATE": every production row's mean sits at or below the
oracle mean of its table.

Sections (each saves ``eval_results/torch/<section>.json``; ``EVAL_TORCH.md``
is rendered from every JSON present there):

  base      oracle + parity + production modes at N=100/1000
  slip      wheel-slip rows, with the oracle under the same slip
  noise     sensor-noise rows at range noise 0.01 and 0.03
  scale     N=10k / N=100k on the card's kernels: per tick, chunked C=8 and
            C=16, motion, fs2 and fs2 + ICP + adaptive, clean and under slip;
            with --device cpu only the one N=10k sanity row (``scale_cpu``)
  jderobot  both traces of data/jderobot/ at N=1k, and at N=100k chunked on
            the card, clean and under slip (with --device cpu: N=1k only,
            ``jderobot_cpu``)

Rows run on ``--device`` (default cuda; without a card that raises) and
draw from torch generators seeded by each value of ``--rngs`` (default 0):
with several values each row runs once per rng, and the table gives the
per-seed means over the rngs, the mean, and the min-max over the rngs of
the mean over seeds.  The oracle rows draw from numpy seed 0 whatever the
rng, as the JAX suite's do.  JAX draws with threefry and torch with Philox,
so rng 0 here is not JAX's rng 0.

    python -m fastslam_tpu_torch.eval.suite --sections base,slip,noise,jderobot
    python -m fastslam_tpu_torch.eval.suite --sections scale --rngs 0 1 2
    python -m fastslam_tpu_torch.eval.suite --render      # EVAL_TORCH.md only
    python -m fastslam_tpu_torch.eval.suite --device cpu --sections base --seeds 3
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import shutil
import subprocess
from datetime import date

import numpy as np
import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import cuda_kernels
from fastslam_tpu_torch.eval.metrics import ate_rmse
from fastslam_tpu_torch.eval.oracle_ate import check_device, run_oracle, start_frame

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RESULTS_DIR = os.path.join(REPO, "eval_results", "torch")
JAX_RESULTS_DIR = os.path.join(REPO, "eval_results")   # the JAX suite's, read only
TRACES = os.path.join(REPO, "data", "jderobot")

# wheel-slip corruption of the odometry the filter sees (rotation std,
# translation std per tick; ground truth unaffected)
SLIP = (0.02, 0.02)
ADAPTIVE = dict(proposal_mode="fastslam2", use_icp_proposal=True,
                adaptive_proposal_floors=True)


def make_log(seed, ticks, *, range_noise_std=0.005, starts=None):
    """The synthetic-world log of ``seed`` and its ground truth in the start
    frame (``scripts/eval_suite.py:make_log``)."""
    from fastslam_tpu_torch.drivers.replay import record_log
    from fastslam_tpu_torch.drivers.sim_world import SimWorld

    # the sim world is deterministic; runs vary by start pose + range noise
    if starts is None:
        starts = {3: (-0.35, 0.0, 0.0), 7: (0.0, -0.3, 0.4),
                  21: (0.35, -0.6, 0.8)}
    x0, y0, yaw0 = starts.get(seed, (0.0, 0.0, 0.0))
    log = record_log(
        SimWorld(seed=seed, x=x0, y=y0, yaw=yaw0, range_noise_std=range_noise_std),
        num_ticks=ticks,
    )
    return log, start_frame(log.gt_poses)


def run_estimates(log, overrides, *, odometry_noise=(0.0, 0.0), chunked=False,
                  chunk_size=8, rng=0, device="cuda") -> np.ndarray:
    """The ``[T, 3]`` estimates of one engine configuration on ``log``:
    ``replay_chunked`` when ``chunked``, else the online ``run_driver``."""
    from fastslam_tpu_torch.app.runner import replay_chunked, run_driver
    from fastslam_tpu_torch.drivers.replay import ReplayDriver

    cfg = FastSLAMConfig(max_landmarks=64, warmup_iterations=150, **overrides)
    if chunked:
        hist = replay_chunked(log, cfg, chunk_size=chunk_size, rng=rng, device=device,
                              odometry_noise=odometry_noise)
    else:
        hist = run_driver(ReplayDriver(log), cfg, rng=rng, device=device,
                          odometry_noise=odometry_noise)
    return np.asarray(hist.est_poses)


def run_mode(log, gt, overrides, *, odometry_noise=(0.0, 0.0), chunked=False,
             chunk_size=8, rng=0, device="cuda") -> float:
    """ATE of one engine configuration (``scripts/eval_suite.py:run_mode``)."""
    est = run_estimates(log, overrides, odometry_noise=odometry_noise, chunked=chunked,
                        chunk_size=chunk_size, rng=rng, device=device)
    return ate_rmse(gt[:, :2], est[:, :2])


def run_oracle_row(log, gt, particles, *, odometry_noise=(0.0, 0.0),
                   device="cuda") -> float:
    """ATE of the reference equations (``scripts/eval_suite.py:run_oracle_row``)."""
    cfg = FastSLAMConfig(num_particles=particles, max_landmarks=64,
                         warmup_iterations=150)
    est = run_oracle(log, cfg, seed=0, odometry_noise=odometry_noise, device=device)
    return ate_rmse(gt[:, :2], est[:, :2])


class Table:
    """A section's rows: for each name, one list per seed of the values of
    each rng (one value for a row that draws from no torch generator), and
    the kernel launches of all its runs."""

    def __init__(self, names):
        self.rows = {name: [] for name in names}
        self.launches = {name: collections.Counter() for name in names}

    def run(self, name, args, fn):
        """Append ``[fn(rng) for rng in args.rngs]`` to row ``name``."""
        with cuda_kernels.counted() as launches:
            self.rows[name].append([fn(rng) for rng in args.rngs])
        self.launches[name].update(launches)

    def oracle(self, name, log, gt, args, *, odometry_noise=(0.0, 0.0)):
        self.rows[name].append([run_oracle_row(log, gt, args.oracle_particles,
                                               odometry_noise=odometry_noise,
                                               device=args.device)])

    def mode(self, name, log, gt, overrides, args, **kw):
        self.run(name, args, lambda rng: run_mode(log, gt, overrides, rng=rng,
                                                  device=args.device, **kw))


def save(section, seeds, table, *, rngs=(0,), device_tag="", results_dir=RESULTS_DIR):
    """Write ``<results_dir>/<section>.json``: the JAX suite's layout
    (``seeds``, ``rows`` with one value per seed, ``date``), each value the
    mean over the rngs, plus ``runs`` (each rng's value), ``rngs``,
    ``launches`` and ``device``."""
    os.makedirs(results_dir, exist_ok=True)
    path = os.path.join(results_dir, f"{section}.json")
    blob = {"seeds": seeds,
            "rows": {k: [float(np.mean(v)) for v in runs] for k, runs in table.rows.items()},
            "date": date.today().isoformat(),
            "rngs": list(rngs), "runs": table.rows, "launches": table.launches,
            "device": device_tag}
    with open(path, "w") as f:
        json.dump(blob, f, indent=1)
    return path


# ---------------------------------------------------------------- sections

def section_base(args):
    modes = {
        "parity (N=100)": dict(num_particles=100),
        "parity (N=1000)": dict(num_particles=1000),
        "production (N=100)": dict(num_particles=100, parity_mode=False),
        "production+fs2 (N=100)": dict(
            num_particles=100, parity_mode=False, proposal_mode="fastslam2"),
        "production+icp (N=100)": dict(
            num_particles=100, parity_mode=False, use_icp_proposal=True),
        # the OnlineFloorEstimator drives the floors and the translation-only
        # command-vs-ICP blend (icp_blend is unused in adaptive mode)
        "production+fs2+adaptive (N=100)": dict(
            num_particles=100, parity_mode=False, **ADAPTIVE),
        "production (N=1000)": dict(num_particles=1000, parity_mode=False),
        "production+fs2+adaptive (N=1000)": dict(
            num_particles=1000, parity_mode=False, **ADAPTIVE),
    }
    oracle_name = f"reference equations (NumPy oracle, N={args.oracle_particles})"
    chunked_name = "production chunked C=8 (N=100)"
    table = Table([oracle_name, *modes, chunked_name])
    for seed in args.seeds:
        log, gt = make_log(seed, args.ticks)
        table.oracle(oracle_name, log, gt, args)
        for name, ov in modes.items():
            table.mode(name, log, gt, ov, args)
        # the chunked batch-replay engine: resampling at chunk boundaries
        table.mode(chunked_name, log, gt, dict(num_particles=100, parity_mode=False),
                   args, chunked=True)
    return args.seeds, table


def section_slip(args):
    # the ICP scan-match proposal earns its keep only under slip; the oracle
    # row replays the reference equations under the same corrupted odometry
    # (same noise stream, seed 123), so the slip table has the same bound
    modes = {
        "production (N=100, wheel slip)": dict(num_particles=100, parity_mode=False),
        "production+icp (N=100, wheel slip)": dict(
            num_particles=100, parity_mode=False, use_icp_proposal=True),
        "production+fs2+adaptive (N=100, wheel slip)": dict(
            num_particles=100, parity_mode=False, **ADAPTIVE),
        "production (N=1000, wheel slip)": dict(num_particles=1000, parity_mode=False),
        "production+fs2+adaptive (N=1000, wheel slip)": dict(
            num_particles=1000, parity_mode=False, **ADAPTIVE),
    }
    oracle_name = (f"reference equations (NumPy oracle, "
                   f"N={args.oracle_particles}, wheel slip)")
    table = Table([oracle_name, *modes])
    for seed in args.seeds:
        log, gt = make_log(seed, args.ticks)
        table.oracle(oracle_name, log, gt, args, odometry_noise=SLIP)
        for name, ov in modes.items():
            table.mode(name, log, gt, ov, args, odometry_noise=SLIP)
    return args.seeds, table


def section_noise(args):
    # the base logs carry range noise 0.005; these rows stress the frontend
    # with 2x and 6x that, each level bounded by its own oracle row
    levels = {}
    for std in (0.01, 0.03):
        oracle_name = (f"reference equations (NumPy oracle, "
                       f"N={args.oracle_particles}, range noise {std})")
        levels[std] = (oracle_name, {
            f"production (N=100, range noise {std})": dict(
                num_particles=100, parity_mode=False),
            f"production+fs2+adaptive (N=100, range noise {std})": dict(
                num_particles=100, parity_mode=False, **ADAPTIVE),
        })
    table = Table([n for oracle_name, names in levels.values()
                   for n in (oracle_name, *names)])
    for std, (oracle_name, names) in levels.items():
        for seed in args.seeds:
            log, gt = make_log(seed, args.ticks, range_noise_std=std)
            table.oracle(oracle_name, log, gt, args)
            for name, ov in names.items():
                table.mode(name, log, gt, ov, args)
    return args.seeds, table


def section_scale(args):
    """ATE at N=10k and N=100k on the engines the card runs: the per-tick
    fused loop, the chunked replay at C=8 and C=16, with the motion, fs2 and
    fs2 + ICP + adaptive proposals, clean and under slip.  On the CPU only
    the N=10k sanity row."""
    seeds = args.seeds[: args.scale_seeds]
    if args.device.type == "cpu":
        name = "production (N=10k, CPU blocks sanity)"
        table = Table([name])
        for seed in seeds:
            log, gt = make_log(seed, args.ticks)
            table.mode(name, log, gt, dict(num_particles=10_000, parity_mode=False), args)
        return seeds, table

    motion = dict(parity_mode=False)
    modes = {
        "production (N=10k, H100 planes)": dict(num_particles=10_000, **motion),
        "production (N=100k, H100 planes)": dict(num_particles=100_000, **motion),
    }
    chunked_modes = {   # name: (overrides, chunk)
        "production chunked C=8 (N=10k, H100)": (dict(num_particles=10_000, **motion), 8),
        "production chunked C=8 (N=100k, H100)": (dict(num_particles=100_000, **motion), 8),
        # the headline bench's chunk
        "production chunked C=16 (N=100k, H100)": (dict(num_particles=100_000, **motion), 16),
        "production+fs2 chunked C=8 (N=100k, H100)": (
            dict(num_particles=100_000, proposal_mode="fastslam2", **motion), 8),
        "production+fs2 chunked C=16 (N=100k, H100)": (
            dict(num_particles=100_000, proposal_mode="fastslam2", **motion), 16),
        "production+fs2+adaptive chunked C=8 (N=10k, H100)": (
            dict(num_particles=10_000, **motion, **ADAPTIVE), 8),
        "production+fs2+adaptive chunked C=8 (N=100k, H100)": (
            dict(num_particles=100_000, **motion, **ADAPTIVE), 8),
    }
    # under slip the fs2 + adaptive stack must beat motion-only
    slip_modes = {
        "production chunked C=8 (N=100k, H100, wheel slip)": dict(
            num_particles=100_000, **motion),
        "production+fs2+adaptive chunked C=8 (N=100k, H100, wheel slip)": dict(
            num_particles=100_000, **motion, **ADAPTIVE),
    }
    oracle_name = f"reference equations (NumPy oracle, N={args.oracle_particles})"
    slip_oracle_name = (f"reference equations (NumPy oracle, "
                        f"N={args.oracle_particles}, wheel slip)")
    table = Table([oracle_name, *modes, *chunked_modes, slip_oracle_name, *slip_modes])
    for seed in seeds:
        log, gt = make_log(seed, args.ticks)
        table.oracle(oracle_name, log, gt, args)
        for name, ov in modes.items():
            table.mode(name, log, gt, ov, args)
        for name, (ov, cs) in chunked_modes.items():
            table.mode(name, log, gt, ov, args, chunked=True, chunk_size=cs)
        table.oracle(slip_oracle_name, log, gt, args, odometry_noise=SLIP)
        for name, ov in slip_modes.items():
            table.mode(name, log, gt, ov, args, chunked=True, odometry_noise=SLIP)
    return seeds, table


def section_jderobot(args):
    """Every canned JdeRobot HAL trace of ``data/jderobot/`` at N=1k per tick
    and, on the card, at N=100k on the chunked engine, clean and under slip,
    each bounded by the oracle on the same trace."""
    from fastslam_tpu_torch.io.jderobot_trace import load_hal_trace

    seeds, logs = [], []
    for path in sorted(glob.glob(os.path.join(TRACES, "*.jsonl"))):
        log = load_hal_trace(path)
        seeds.append(os.path.basename(path).replace(".jsonl", ""))
        logs.append((log, start_frame(log.gt_poses)))

    oracle_name = (f"reference equations (NumPy oracle, "
                   f"N={args.oracle_particles}, JdeRobot trace)")
    per_tick = "production (N=1k, JdeRobot trace)"
    card = args.device.type != "cpu"
    chunked = "production chunked C=8 (N=100k, H100, JdeRobot trace)"
    slip_oracle = (f"reference equations (NumPy oracle, "
                   f"N={args.oracle_particles}, JdeRobot trace, wheel slip)")
    slip = "production chunked C=8 (N=100k, H100, JdeRobot, wheel slip)"
    slip_fs2 = "production+fs2+adaptive chunked C=8 (N=100k, H100, JdeRobot, wheel slip)"
    table = Table([oracle_name, per_tick] + ([chunked, slip_oracle, slip, slip_fs2]
                                             if card else []))
    big = dict(num_particles=100_000, parity_mode=False)
    for log, gt in logs:
        table.oracle(oracle_name, log, gt, args)
        table.mode(per_tick, log, gt, dict(num_particles=1000, parity_mode=False), args)
        if card:
            table.mode(chunked, log, gt, big, args, chunked=True)
    if card:
        for log, gt in logs:
            table.oracle(slip_oracle, log, gt, args, odometry_noise=SLIP)
            table.mode(slip, log, gt, big, args, chunked=True, odometry_noise=SLIP)
            table.mode(slip_fs2, log, gt, dict(big, **ADAPTIVE), args, chunked=True,
                       odometry_noise=SLIP)
    return seeds, table


SECTIONS = {
    "base": section_base,
    "slip": section_slip,
    "noise": section_noise,
    "scale": section_scale,
    "jderobot": section_jderobot,
}

SECTION_TITLES = {
    "base": "Reference parity and production modes",
    "slip": "Wheel slip (odometry corrupted by 0.02/tick; ground truth clean)",
    "noise": "Sensor noise (laser range noise above the 0.005 base)",
    "scale": "North-star scale (N=10k / N=100k on the H100 engines)",
    "scale_cpu": "North-star scale (CPU sanity)",
    "jderobot": "JdeRobot native-format trace (data/jderobot/)",
    "jderobot_cpu": "JdeRobot native-format trace (CPU, N=1k)",
}
ORDER = ["base", "slip", "noise", "scale", "scale_cpu", "jderobot", "jderobot_cpu"]

# EVAL_TORCH.md from this heading on is written by hand (findings such as
# eval/diagnose_slip.py's); --render keeps it
KEPT = "## Findings"
NOTES = """
The bound is EVAL.md's "match reference ATE": every production row's mean
sits at or below the mean of the oracle row above it in its table (clean,
slip, noise and trace tables each carry their own oracle).  Parity rows
reproduce the reference's algorithm with its quirks and are not held to
it.  "JAX mean" is the mean of the same row in `eval_results/<section>.json`
(the JAX suite's results, "TPU" in its names where these read "H100"); JAX
draws with threefry and the port with Philox, so the two agree only
statistically.  "rng spread" is the min-max over the rngs of the mean over
seeds; the oracle rows draw from numpy seed 0 whatever the rng.  "Launches"
counts the port's kernel launches over all the row's runs (a graph replay
counts its kernels).  A production row above its oracle, or a row more
than 1.5x and 0.01 m above JAX's mean with no rng reaching it ("past JAX's
margin"), is a fault of ROADMAP.md §3 until its cause is found.
"""


def row_checks(rows):
    """``{name: True, False or None}``: whether each production row's mean
    sits at or below the nearest oracle row above it (None for the rest)."""
    out, bound = {}, None
    for name, vals in rows.items():
        out[name] = None
        if name.startswith("reference equations"):
            bound = float(np.mean(vals))
        elif name.startswith("production") and bound is not None:
            out[name] = float(np.mean(vals)) <= bound
    return out


def rng_means(runs):
    """The mean over seeds for each rng (a one-value seed list counts for
    every rng)."""
    n = max(len(v) for v in runs)
    return [float(np.mean([v[r] if len(v) > 1 else v[0] for v in runs])) for r in range(n)]


def jax_mean(jax_rows, name):
    vals = jax_rows.get(name.replace("H100", "TPU"))
    return None if vals is None else float(np.mean(vals))


def margin_fault(mean, spread, want):
    """The margin beyond which a row is a fault: its mean more than 1.5x
    JAX's and more than 0.01 m above it, with no rng reaching JAX's mean."""
    return (want is not None and mean > 1.5 * want and mean > want + 0.01
            and min(spread) > want)


def load_sections(results_dir):
    present = {}
    for name in ORDER:
        path = os.path.join(results_dir, f"{name}.json")
        if os.path.exists(path):
            with open(path) as f:
                present[name] = json.load(f)
    return present


def render(out, *, results_dir=RESULTS_DIR, jax_dir=JAX_RESULTS_DIR):
    """Render ``out`` from every section JSON in ``results_dir``, each row
    beside the JAX suite's mean of the same row in ``jax_dir``; the part of
    an existing ``out`` from the heading ``KEPT`` on stays as it is."""
    lines = [
        "# EVAL_TORCH: accuracy matrix of the PyTorch/CUDA port",
        "",
        "Generated by `python -m fastslam_tpu_torch.eval.suite` (300-tick "
        "synthetic-world logs of `make_log`, warmup 150; ATE RMSE in metres "
        "over the full trajectory; per-section results in "
        "`eval_results/torch/*.json`).  The counterpart of `EVAL.md`.",
    ]
    for name, blob in load_sections(results_dir).items():
        jax_rows = {}
        jax_path = os.path.join(jax_dir, f"{name}.json")
        if os.path.exists(jax_path):
            with open(jax_path) as f:
                jax_rows = json.load(f)["rows"]
        seeds, rows, runs = blob["seeds"], blob["rows"], blob.get("runs", {})
        checks = row_checks(rows)
        lines += [
            "",
            f"## {SECTION_TITLES[name]}",
            "",
            f"Device: {blob.get('device') or 'not recorded'}; rngs "
            f"{' '.join(map(str, blob.get('rngs', [0])))}; {blob['date']}.",
            "",
            "| pipeline | " + " | ".join(f"seed {s}" for s in seeds)
            + " | mean | rng spread | JAX mean | at or below oracle | launches |",
            "|---|" + "---|" * (len(seeds) + 5),
        ]
        for rname, vals in rows.items():
            mean = float(np.mean(vals))
            spread = rng_means(runs[rname]) if rname in runs else [mean]
            want = jax_mean(jax_rows, rname)
            ok = checks[rname]
            verdict = "—" if ok is None else ("yes" if ok else "**no**")
            if margin_fault(mean, spread, want):
                verdict += " (**past JAX's margin**)"
            launches = blob.get("launches", {}).get(rname, {})
            cells = " | ".join(f"{v:.3f}" for v in vals)
            lines.append(
                f"| {rname} | {cells} | **{mean:.3f}** | "
                f"{min(spread):.3f}–{max(spread):.3f} | "
                f"{'—' if want is None else f'{want:.3f}'} | {verdict} | "
                f"{', '.join(f'{k} {v}' for k, v in launches.items()) or '—'} |")
    lines.append(NOTES)
    if os.path.exists(out):
        with open(out) as f:
            old = f.read().splitlines()
        if KEPT in old:
            lines += [""] + old[old.index(KEPT):]
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")


def device_tag(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or the
    CPU's platform."""
    if device.type == "cpu":
        import platform

        return f"cpu ({platform.processor() or platform.machine()})"
    smi = shutil.which("nvidia-smi")
    if smi:
        out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[device.index or 0]
    return f"{torch.cuda.get_device_name(device)} (power limit not read)"


def build_parser():
    ap = argparse.ArgumentParser(prog="python -m fastslam_tpu_torch.eval.suite")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--out", default=os.path.join(REPO, "EVAL_TORCH.md"))
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--seeds", type=int, nargs="+", default=[3, 7, 21])
    ap.add_argument("--scale-seeds", type=int, default=3,
                    help="how many of --seeds the scale section uses")
    ap.add_argument("--rngs", type=int, nargs="+", default=[0],
                    help="seeds of the filter's torch generator; each row runs once per rng")
    ap.add_argument("--oracle-particles", type=int, default=50)
    ap.add_argument("--sections", default=None,
                    help=f"comma-separated subset of {sorted(SECTIONS)} "
                         "(default: base,slip,noise)")
    ap.add_argument("--results-dir", default=RESULTS_DIR,
                    help="where the section JSONs are written and rendered from")
    ap.add_argument("--render", action="store_true",
                    help="only re-render the report from --results-dir")
    return ap


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    if not args.render:
        args.device = check_device(args.device)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.render:
        tag = device_tag(args.device)
        wanted = args.sections.split(",") if args.sections else ["base", "slip", "noise"]
        summary = {}
        for section in wanted:
            seeds, table = SECTIONS[section](args)
            stored = section
            if section in ("scale", "jderobot") and args.device.type == "cpu":
                stored = section + "_cpu"
            save(stored, seeds, table, rngs=args.rngs, device_tag=tag,
                 results_dir=args.results_dir)
            summary[stored] = {k: round(float(np.mean(v)), 4)
                               for k, v in table.rows.items()}
            print(json.dumps({stored: summary[stored]}), flush=True)
        print(json.dumps({"device": tag, "rngs": args.rngs, "summary": summary}))
    render(args.out, results_dir=args.results_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
