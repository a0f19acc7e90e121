"""The card's filter kernels against the port's CPU plain path, at the
reference's bars (the counterpart of ``scripts/check_pallas_parity.py``).

Each check runs the same ticks from the same state and the same draws
twice: on the card, where the step launches its kernel, and on the CPU,
where it runs the plain PyTorch path.  The draws are made once on a CPU
generator (seed 0) and copied to both sides.

* ``motion`` (§2 row 1): 3 ticks of the blocks step
  ``core/kernels.fastslam_step`` in parity mode (the per-tick motion kernel
  on the card, the measurement loop on the CPU) at P=800, L=64, M=16, the
  measurements ``(2.0 + 0.3 i, -2.5 + 0.35 i)``, rotation 0, translation
  0.4 (``scripts/check_pallas_parity.py:31-38``).  Bars (``:94-99``): the
  landmark counts equal; max |diff| of poses 1e-5, landmark means 5e-4,
  covariances 5e-4, log-weights 5e-3, the returned pose 1e-5.
* ``fs2`` (row 3): 3 production fs2 ticks at P=1,024, the card's planes step
  ``fastslam_step_planes`` against the CPU's blocks step (``:64-77``).  Bars
  (``:104-129``, the criterion for production's packed-argmin
  association): under 1 % of particles with another landmark count; on the
  particles that agree, the 99th percentile of each particle's largest
  difference under poses 5e-5, means 5e-4, covariances 5e-4, log-weights
  5e-2, and under 1 % of them past a bar.
* both again at the bench geometry, P=100,000: ``motion`` as the script
  runs it (parity mode's weights never resample in its 3 ticks), ``fs2``
  tick by tick (``form="ticks"``): each tick both sides start from the
  CPU's state, and the states are held before the resample; the CPU's
  tick, resample included, carries on.  At this width the systematic
  resample's grid (spacing 1/P) turns any difference in the weights into
  other ancestors for many particles: the script's 3 whole fs2 steps part
  94 % of them between an H100 and the CPU, and the CPU's own planes and
  blocks steps part 79 %.
* ``motion_chunked`` and ``fs2_chunked`` (rows 2 and 4): one chunk of C=16
  ticks of ``fastslam_steps_planes_chunked`` at P=800 and 1,024.  The
  chunked kernels run in production only, so both are held by the
  production criterion; the motion chunk's per-tick estimates are also
  held to the pose bar where both sides pick the same particle, and
  otherwise each side's pick must be tied, within the log-weight bar, with
  the other side's.

Prints one JSON line per check (each difference beside its bar, the flip
fraction, the kernel's launches, the card's name and power limit) and exits
1 if any bar breaks::

    python -m fastslam_tpu_torch.probes.check_parity [--full 100000] [--device cuda]

``--device cpu`` holds the CPU against itself (the wiring, not the card).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import cuda_kernels, kernels
from fastslam_tpu_torch.core.state import (
    Measurements, from_planes, init_planes_state, init_state, pad_measurements,
)

MEASUREMENTS = [(2.0 + 0.3 * i, -2.5 + 0.35 * i) for i in range(16)]
ROTATION, TRANSLATION = 0.0, 0.4
STEPS, CHUNK = 3, 16
MOTION_PARTICLES, FS2_PARTICLES, FULL_PARTICLES = 800, 1024, 100_000
# scripts/check_pallas_parity.py:95, :114, :121-129
MOTION_BARS = {"poses": 1e-5, "mean": 5e-4, "cov": 5e-4, "logw": 5e-3, "pose": 1e-5}
FS2_BARS = {"poses": 5e-5, "mean": 5e-4, "cov": 5e-4, "logw": 5e-2}
FLIP_BAR = 0.01      # fraction of particles with another landmark count (fs2)
OVER_BAR = 0.01      # fraction of agreeing particles past a bar (fs2)
KERNEL = {"motion": "fused_update_planes", "fs2": "fused_fs2_planes",
          "motion_chunked": "fused_update_planes_multi",
          "fs2_chunked": "fused_fs2_planes_multi"}
ROW = {"motion": 1, "motion_chunked": 2, "fs2": 3, "fs2_chunked": 4}


def config(check: str, particles: int) -> FastSLAMConfig:
    """The check's config: parity mode for ``motion`` (the script's default
    config), production for the chunked motion check, production fs2 for
    the fs2 checks."""
    kw = dict(num_particles=particles, max_landmarks=64, max_measurements=16)
    if check.startswith("fs2"):
        kw.update(parity_mode=False, proposal_mode="fastslam2")
    elif check == "motion_chunked":
        kw.update(parity_mode=False)
    return FastSLAMConfig(**kw)


def make_draws(cfg: FastSLAMConfig, *, chunked: bool = False, seed: int = 0):
    """The draws of the check, on a CPU generator: ``STEPS`` per-tick draws,
    or one chunk of ``CHUNK`` ticks."""
    gen = torch.Generator().manual_seed(seed)
    fs2 = kernels.uses_fs2(cfg)
    if chunked:
        return [kernels.draw(gen, cfg.num_particles, CHUNK, fs2=fs2)]
    return [kernels.draw(gen, cfg.num_particles, fs2=fs2) for _ in range(STEPS)]


def _to(draws: kernels.Draws, device) -> kernels.Draws:
    return kernels.Draws(*(None if x is None else x.to(device) for x in draws))


def snapshot(state, pose) -> dict:
    """A blocks-layout state and the last returned pose as numpy arrays
    under the script's names."""
    return {"poses": state.poses.cpu().numpy(), "logw": state.log_weights.cpu().numpy(),
            "mean": state.lm_mean.cpu().numpy(), "cov": state.lm_cov.cpu().numpy(),
            "cnt": state.lm_count.cpu().numpy(), "pose": pose.cpu().numpy()}


def run_steps(cfg: FastSLAMConfig, draws, device, *, planes: bool = False, state=None):
    """``len(draws)`` ticks at the check's odometry and measurements on
    ``device``: the blocks step ``fastslam_step`` from ``state`` (default a
    fresh one), or with ``planes`` the planes step ``fastslam_step_planes``
    from a fresh planes state.  Returns :func:`snapshot` of the end."""
    device = torch.device(device)
    ms = pad_measurements(cfg, MEASUREMENTS, device)
    if planes:
        st = init_planes_state(cfg, device)
        step = kernels.fastslam_step_planes
    else:
        st = init_state(cfg, device) if state is None else state
        step = kernels.fastslam_step
    for d in draws:
        st, pose = step(st, ROTATION, TRANSLATION, ms, cfg, _to(d, device))
    return snapshot(from_planes(st) if planes else st, pose)


def run_ticks(check: str, cfg: FastSLAMConfig, draws, device, compare) -> dict:
    """The per-tick form of a check, for widths where the resample would
    amplify any difference: every tick both sides start from the same state
    (the CPU's), the card runs the tick's kernel (``propose_and_update`` on
    the blocks layout for ``motion``, ``planes_update`` for ``fs2``), the CPU
    its plain path (``propose_and_update``), and ``compare`` holds the two
    states before the resample; then the CPU's tick, resample included,
    carries on.  Returns the worst tick's comparison with every tick's."""
    from fastslam_tpu_torch.core.state import to_planes

    device = torch.device(device)
    ms = {d: pad_measurements(cfg, MEASUREMENTS, d) for d in (device, "cpu")}
    state = init_state(cfg, "cpu")
    ticks = []
    for d in draws:
        card_in = state.replace(**{k: v.to(device, copy=True)
                                    for k, v in state.__dict__.items()})
        if check == "fs2":
            card = from_planes(kernels.planes_update(
                to_planes(card_in, cfg), ROTATION, TRANSLATION, ms[device], cfg,
                _to(d, device)))
        else:
            card = kernels.propose_and_update(card_in, ROTATION, TRANSLATION, ms[device],
                                              cfg, _to(d, device))
        cpu = kernels.propose_and_update(state, ROTATION, TRANSLATION, ms["cpu"], cfg, d)
        ticks.append(compare(snapshot(card, kernels.estimate_pose(card)),
                             snapshot(cpu, kernels.estimate_pose(cpu))))
        state = kernels._normalize_and_resample(cpu, d.u0, cfg, kernels.resample_state)
    worst = next((t for t in ticks if not t["ok"]), ticks[-1])
    return worst | {"ok": all(t["ok"] for t in ticks), "per_tick": ticks}


def run_chunk(cfg: FastSLAMConfig, draws, device) -> dict:
    """One chunk of ``CHUNK`` ticks of ``fastslam_steps_planes_chunked`` on
    ``device``: :func:`snapshot` of the end state, with ``pose`` the
    chunk's ``[C, 3]`` estimates and ``tlogw`` the ``[C, P]`` weights they
    are the argmax of (the step's three stages, kept apart to read them)."""
    device = torch.device(device)
    ms = pad_measurements(cfg, MEASUREMENTS, device)
    chunk_ms = Measurements(ms.range_bearing.expand(CHUNK, -1, -1).contiguous(),
                            ms.valid.expand(CHUNK, -1).contiguous())
    d = _to(draws[0], device)
    trajectory, st = kernels.chunk_update(
        init_planes_state(cfg, device), torch.full((CHUNK,), ROTATION, device=device),
        torch.full((CHUNK,), TRANSLATION, device=device), chunk_ms, cfg, d)
    est = kernels.chunk_estimates(trajectory)
    st = kernels._normalize_and_resample(st, d.u0, cfg)
    return snapshot(from_planes(st), est) | {"tlogw": trajectory[3].cpu().numpy()}


def compare_estimates(a: dict, b: dict, pose_bar=MOTION_BARS["pose"],
                      logw_bar=MOTION_BARS["logw"]) -> dict:
    """The chunk's per-tick estimates, each the pose of the particle of
    largest weight: where both sides pick the same particle, under the pose
    bar; where they pick two, each side's pick within the log-weight bar of
    the other side's largest weight (a tie, which either side may break)."""
    same = ties = 0
    worst = 0.0
    for t in range(a["pose"].shape[0]):
        ia, ib = int(np.argmax(a["tlogw"][t])), int(np.argmax(b["tlogw"][t]))
        if ia == ib:
            same += 1
            worst = max(worst, float(np.max(np.abs(a["pose"][t] - b["pose"][t]))))
        elif (b["tlogw"][t].max() - b["tlogw"][t][ia] < logw_bar
              and a["tlogw"][t].max() - a["tlogw"][t][ib] < logw_bar):
            ties += 1
        else:
            return {"ok": False, "tick": t, "picks": [ia, ib]}
    return {"ok": worst < pose_bar, "max": worst, "bar": pose_bar, "same_pick": same,
            "ties": ties}


def compare_max(a: dict, b: dict, bars=MOTION_BARS) -> dict:
    """The motion bars: landmark counts equal, every max |diff| under its
    bar."""
    diffs = {k: {"max": float(np.max(np.abs(a[k] - b[k]))), "bar": bar}
             for k, bar in bars.items()}
    cnt_equal = bool(np.array_equal(a["cnt"], b["cnt"]))
    ok = cnt_equal and all(d["max"] < d["bar"] for d in diffs.values())
    return {"cnt_equal": cnt_equal, "diffs": diffs, "ok": ok}


def compare_flips(a: dict, b: dict, bars=FS2_BARS, flip_bar=FLIP_BAR,
                  over_bar=OVER_BAR) -> dict:
    """The fs2 bars: under ``flip_bar`` of particles with another landmark
    count; on the others, each particle's largest difference per field, its
    99th percentile under the field's bar and under ``over_bar`` of them
    past it."""
    agree = a["cnt"] == b["cnt"]
    n = agree.size
    flip = float(1.0 - agree.mean())
    diffs = {}
    for k, bar in bars.items():
        d = np.abs(a[k] - b[k]).reshape(n, -1).max(axis=1)[agree]
        diffs[k] = {"q99": float(np.quantile(d, 0.99)) if d.size else 0.0, "bar": bar,
                    "over": float((d > bar).mean()) if d.size else 0.0, "over_bar": over_bar}
    ok = flip < flip_bar and bool(agree.any()) and all(
        d["q99"] < d["bar"] and d["over"] < d["over_bar"] for d in diffs.values())
    return {"flip_frac": flip, "flip_bar": flip_bar, "diffs": diffs, "ok": ok}


def run_check(check: str, particles: int, device, form: str = "steps") -> dict:
    """One check in one form: ``steps`` (the script's: the whole steps, the
    end states compared), ``ticks`` (:func:`run_ticks`) or ``chunk`` (one
    chunk, :func:`run_chunk`).  The card side's kernel launches are counted;
    on a card a side that launched none fails the check."""
    cfg = config(check, particles)
    draws = make_draws(cfg, chunked=form == "chunk")
    # the script holds parity mode to the max bars and production's packed
    # argmin association to the distributional ones (:104-129); the chunked
    # kernels run in production only
    compare = compare_max if cfg.parity_mode else compare_flips
    with cuda_kernels.counted() as launches:
        if form == "ticks":
            out = run_ticks(check, cfg, draws, device, compare)
        elif form == "chunk":
            card, cpu = run_chunk(cfg, draws, device), run_chunk(cfg, draws, "cpu")
            out = compare(card, cpu)
            if not kernels.uses_fs2(cfg):   # the motion bars hold the returned poses
                est = compare_estimates(card, cpu)
                out |= {"estimates": est, "ok": out["ok"] and est["ok"]}
        else:
            out = compare(run_steps(cfg, draws, device, planes=check == "fs2"),
                          run_steps(cfg, draws, "cpu"))
    if torch.device(device).type == "cuda" and not launches.get(KERNEL[check]):
        out["ok"] = False     # the card side must have run the kernel
    return {"check": check, "row": ROW[check], "kernel": KERNEL[check], "form": form,
            "particles": particles, "L": cfg.max_landmarks, "M": cfg.max_measurements,
            "ticks": CHUNK if form == "chunk" else STEPS, "launches": launches, **out}


def checks(full: int | None = FULL_PARTICLES):
    """``(check, particles, form)`` of a whole run: both per-tick checks at
    the script's sizes as the script runs them, both again at ``full``
    particles (fs2 tick by tick), both chunked checks at the script's
    sizes."""
    todo = [("motion", MOTION_PARTICLES, "steps"), ("fs2", FS2_PARTICLES, "steps")]
    if full:
        todo += [("motion", full, "steps"), ("fs2", full, "ticks")]
    return todo + [("motion_chunked", MOTION_PARTICLES, "chunk"),
                   ("fs2_chunked", FS2_PARTICLES, "chunk")]


def run(device="cuda", full: int | None = FULL_PARTICLES, print_lines: bool = True,
        todo=None):
    """Every check of ``todo`` (default :func:`checks`); returns their result
    dicts (each with the card's name and power limit)."""
    from fastslam_tpu_torch.eval.oracle_ate import check_device
    from fastslam_tpu_torch.probes import device_fields

    device = check_device(device)
    fields = device_fields(device)
    results = []
    for check, particles, form in todo or checks(full):
        r = run_check(check, particles, device, form) | fields
        if print_lines:
            print(json.dumps(r), flush=True)
        results.append(r)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fastslam_tpu_torch.probes.check_parity")
    ap.add_argument("--full", type=int, default=FULL_PARTICLES,
                    help="particles of the bench-geometry checks (0: skip them)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    results = run(args.device, args.full or None)
    broken = [f"{r['check']} P={r['particles']}" for r in results if not r["ok"]]
    if broken:
        print(f"check_parity: bars broken: {', '.join(broken)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
