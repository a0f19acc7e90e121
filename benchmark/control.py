"""The readings that a cell's limits are set from.

    python3 -m benchmark.control --workload NAME --seeds 1,2,3 --seconds 2 [--faults]

For each seed, in one process: a short window of the cell at its own size,
then for every checked chunk or tick the numbers compared for

* ``program``: the program's own output (the sound run);
* ``control``: the reference put in the program's place with its filter
  (and, online, its ICP) computed in bfloat16, the nearest precision below
  the configuration's float32 (neither has matrix products, so TF32 does
  not apply);
* with ``--faults``, the program with a fault planted under the timed path
  (:data:`FAULTS`, through :func:`planted`), each in a window of its own.

Prints one JSON line per seed and reading.  The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch

from benchmark import harness

STEPS = ("fastslam_steps_planes_chunked", "fastslam_step_planes")


def _chunked(rotation) -> bool:
    return torch.is_tensor(rotation) and rotation.dim() == 1


def _best_pose(state, rotation):
    pose = state.poses.index_select(0, torch.argmax(state.log_weights).reshape(1))
    return pose.expand(rotation.shape[0], 3) if _chunked(rotation) else pose[0]


def step_unchanged(base):
    """A step that returns its state unchanged (estimates from it)."""
    def step(state, rotation, translation, ms, cfg, draws, **kw):
        return state, _best_pose(state, rotation)
    return step


def step_half(base):
    """Half of the particles left out: the step runs on the first half,
    normalizing over it, and the rest keeps its state."""
    def step(state, rotation, translation, ms, cfg, draws, **kw):
        from fastslam_tpu_torch.core.kernels import Draws

        h = state.num_particles // 2
        axis = {"poses": 0, "log_weights": 0, "lm_count": 0}
        cut = lambda name, t: t.narrow(axis.get(name, 1), 0, h).clone()
        fields = ("poses", "log_weights", "lm_mx", "lm_my", "lm_ca", "lm_cb", "lm_cd",
                  "lm_count")
        part = state.replace(**{k: cut(k, getattr(state, k)) for k in fields})
        # per-particle draws: the last axis of a chunk's, the first of a tick's
        pdim = -1 if _chunked(rotation) else 0
        d = Draws(*(None if t is None or t.dim() == 0 else t.narrow(pdim, 0, h).contiguous()
                    for t in draws))
        d = d._replace(u0=draws.u0)
        new, est = base(part, rotation, translation, ms, cfg, d, **kw)
        join = lambda k: torch.cat([getattr(new, k), getattr(state, k).narrow(
            axis.get(k, 1), h, state.num_particles - h)], axis.get(k, 1))
        return state.replace(**{k: join(k) for k in fields}), est
    return step


def step_altered(base):
    """The real step with its first estimate moved by 0.1 m where it is
    produced."""
    def step(*args, **kw):
        state, est = base(*args, **kw)
        first = torch.arange(est.numel(), device=est.device).reshape(est.shape) == 0
        return state, est + 0.1 * first.to(est.dtype)
    return step


FAULTS = {"unchanged": step_unchanged, "half": step_half, "altered": step_altered}


@contextlib.contextmanager
def planted(fault: str | None):
    """The program's filter steps replaced by ``fault``'s broken form for
    the block (nothing for ``None``)."""
    from fastslam_tpu_torch.core import kernels

    saved = {name: getattr(kernels, name) for name in STEPS}
    try:
        if fault is not None:
            for name, fn in saved.items():
                setattr(kernels, name, FAULTS[fault](fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


def filter_readings(cell, seed, seconds, device, control, overrides):
    from benchmark.drivers import filter as driver

    fr = driver.FilterRun(cell, seed, device, overrides=overrides)
    fr.setup()
    done = fr.window(seconds, False)["chunks"]
    fr.free()
    out = {"program": [0.0, 0.0], "checked": 0}
    if control:
        out["control"] = [0.0, 0.0]
    for i in fr.samples:
        if i >= done:
            continue
        snap = fr.snaps[i]
        ref_est, ref_state, _ = fr.reference_chunk(snap["in"], snap["draws"])
        reading = fr.compare(snap["est"], snap["out"], ref_est, ref_state)
        out["program"] = [max(a, b) for a, b in zip(out["program"], reading)]
        if control:
            c_est, c_state, _ = fr.reference_chunk(snap["in"], snap["draws"], torch.bfloat16)
            reading = fr.compare(c_est, c_state, ref_est, ref_state)
            out["control"] = [max(a, b) for a, b in zip(out["control"], reading)]
        out["checked"] += 1
    return out


def online_readings(cell, seed, seconds, device, control, overrides):
    from benchmark.drivers import online as driver

    orun = driver.OnlineRun(cell, seed, device, overrides=overrides)
    orun.setup(seconds)
    orun.window(seconds, False)
    orun.free()
    out = {"program": [0.0, 0.0, 0.0], "checked": 0}
    if control:
        out["control"] = [0.0, 0.0, 0.0]
    for i in orun.samples:
        if i >= orun.t:
            continue
        snap = orun.snaps[i]
        want = orun.reference_tick(i, snap)
        reading = orun.compare(orun.program_result(snap), want)
        out["program"] = [max(a, b) for a, b in zip(out["program"], reading)]
        if control:
            reading = orun.compare(orun.reference_tick(i, snap, torch.bfloat16), want)
            out["control"] = [max(a, b) for a, b in zip(out["control"], reading)]
        out["checked"] += 1
    return out


def read_seed(cell, seed, seconds, device, *, fault=None, overrides=None) -> dict:
    """One seed's readings, with ``fault`` planted under the timed path."""
    read = filter_readings if cell.traffic["driver"] == "filter" else online_readings
    with planted(fault):
        out = read(cell, seed, seconds, device, fault is None, overrides)
    return {"seed": seed, "fault": fault, **out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = harness.cuda_device(cell.chips)
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds:
        print(json.dumps(read_seed(cell, seed, args.seconds, device)), flush=True)
    if args.faults:
        for fault in FAULTS:
            for seed in seeds[:3]:
                print(json.dumps(read_seed(cell, seed, args.seconds, device, fault=fault)),
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
