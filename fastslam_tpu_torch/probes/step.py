"""K filter steps in one captured CUDA graph: the port's step timing (the
counterpart of ``scripts/bench_step.py``).

The reference times K data-dependent steps inside one
``jax.jit(lax.scan)``: one dispatch and one block, immune to asynchronous
dispatch.  Here the K steps are captured once into a
:class:`torch.cuda.CUDAGraph` and timed as one replay.  Every captured step
decides its resample on the device (``on_device=True``, JAX's ``lax.cond``
form), so it reads nothing on the host; a step that would (a ``bool``, an
``.item()``) breaks the capture, and the capture's error is raised, never
turned into the eager path.

Paths (``path``, named as the script names them, ``:239-250``):

* ``scan``: the blocks step ``core/kernels.fastslam_step`` (the per-tick
  motion kernel through ``cuda_kernels.fused_update`` on the card);
* ``planes``: ``fastslam_step_planes``;
* ``planes+fusedonly``: the per-tick motion kernel alone
  (``cuda_kernels.fused_update_planes``; no propagation, normalization,
  resample or estimate);
* ``chunked{C}``: ``fastslam_steps_planes_chunked``, C ticks per step;
* the suffixes ``+frontend`` (``scan_to_measurements`` on the scans of
  ``SimWorld(seed=2)``, tick k's scan the input of step k, then the step:
  the scans are the loop's input, so the frontend cannot be hoisted),
  ``+fs2``, ``+prod`` and ``+nores``.

Flags kept: ``--particles``, ``--landmarks``, ``--measurements``,
``--valid-measurements``, ``--k``, ``--planes``, ``--no-resample``,
``--fused-only`` (implies ``--planes``), ``--production``, ``--chunk``
(implies ``--planes --production``), ``--fs2`` (implies ``--production``)
and ``--with-frontend``.  Left out: ``--pallas`` and ``--cpu`` (``--device``
chooses: on the card the kernels run, on the CPU their plain versions);
``--no-donate`` (a graph replays into the static tensors it captured; there
is nothing to donate); ``--bf16-assoc``, ``--bf16-shadow``, ``--unroll`` and
``--skip-ekf`` (retired levers, ROADMAP "Removal").  Combinations the script
runs under another path's name are refused: ``--with-frontend`` with
``--chunk`` or ``--fused-only``, and ``--fused-only`` with ``--chunk`` or
``--fs2``.

Draws: the K steps' draws are made eagerly into static tensors (``draws``:
``"eager_static"``) from the probe's generator, inside the timed region, as
JAX's scan takes its draws inside its dispatch; the graph reads them.  The
eager form takes the same draws from the same state, so the two forms must
end in the same state bit for bit, and the probe raises if they do not.

On the card the probe prints, beside the script's keys (``compile_s`` is
``build_and_capture_s``: the kernels' build, the first eager run and the
capture), ``eager_step_ms``: the same K steps eagerly with the host
deciding each resample (``on_device=False``) and one synchronisation at the
end.  The graph form pays an identity gather of the whole state on each
tick that does not resample (``core/kernels.py:_normalize_and_resample``);
the eager form pays a host read and every launch from Python.  Times are
the best of 3 repetitions, CUDA events around the draws and the replay (the
eager steps), each repetition ending in a host read of the last pose.  On
``--device cpu`` the eager form runs the plain versions once, timed on the
host clock, and the graph keys are null::

    python -m fastslam_tpu_torch.probes.step [--planes] [--chunk 16] [--fs2]
        [--with-frontend] [--k 50] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import time
from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import cuda_kernels, kernels
from fastslam_tpu_torch.core.state import (
    Measurements, init_planes_state, init_state, pad_measurements,
)

SEED = 0
REPS = 3


def bench_measurements(n: int):
    """``bench.py``'s measurement set, its first ``n`` (range, bearing)
    pairs."""
    return [(2.0 + 0.3 * i, -2.5 + 0.35 * i) for i in range(n)]


def make_scan_inputs(num_steps: int, config: FastSLAMConfig, device="cpu"):
    """The scans of ``SimWorld(seed=2)`` as a loop's inputs
    (``scripts/bench_e2e_attribution.py:make_scan_inputs``): ``(points [K,
    B, 2], valid [K, B], rotations [K], translations [K])`` on ``device``,
    out-of-range beams zeroed and invalid, the motion a pure rotation or a
    pure translation per tick from the log's commands."""
    from fastslam_tpu_torch.drivers.replay import record_log
    from fastslam_tpu_torch.drivers.sim_world import SimWorld

    log = record_log(SimWorld(seed=2), num_ticks=num_steps)
    values = np.asarray(log.scans, np.float32)
    nb = values.shape[1]
    angles = np.radians(np.arange(nb) - nb // 2).astype(np.float32)
    valid = (values >= log.min_range) & (values <= log.max_range)
    pts = np.stack([values * np.cos(angles), values * np.sin(angles)], axis=-1)
    pts[~valid] = 0.0
    rots = np.where(np.asarray(log.cmd_v) != 0, 0.0,
                    np.asarray(log.cmd_w) * 0.05).astype(np.float32)
    trs = np.where(np.asarray(log.cmd_v) != 0,
                   np.asarray(log.cmd_v) * 0.05 * config.velocity_fudge,
                   0.0).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (pts, valid, rots, trs))


@dataclass
class Carry:
    """A loop state of one tensor (the frontend-only loop's reduction)."""

    value: torch.Tensor

    def clone(self) -> "Carry":
        return Carry(self.value.clone())

    def replace(self, **kw) -> "Carry":
        return replace(self, **kw)


@dataclass
class Loop:
    """K steps of one path: ``step(state, k, draws_k, on_device) -> (state,
    out)`` from ``state`` (never changed: each run starts from a clone),
    with tick k's slice of the static draws ``draws`` (``[K, ...]`` each;
    None for a path that draws nothing); ``out`` of the last step is the
    value read back."""

    state: object
    step: Callable
    k: int
    particles: int
    draws: Optional[kernels.Draws] = None
    ticks_per_step: int = 1


def static_draws(k: int, p: int, device, *, chunk: int = 0, fs2: bool = False
                 ) -> kernels.Draws:
    """Static tensors for K steps' draws: ``[K, P]`` motion normals (``[K,
    C, P]`` per chunk), or fs2 noise ``[K, P, 3]`` (``[K, C, 3, P]``), and
    ``u0`` ``[K]``."""
    z = lambda *shape: torch.zeros((k,) + shape, dtype=torch.float32, device=device)
    ticks = (chunk,) if chunk else ()
    if fs2:
        noise = z(chunk, 3, p) if chunk else z(p, 3)
        return kernels.Draws(None, None, z(), noise)
    return kernels.Draws(z(*ticks, p), z(*ticks, p), z(), None)


def fill_draws(loop: "Loop", generator: torch.Generator) -> None:
    """New draws into the loop's static tensors, in place: standard
    normals, and ``u0`` uniform in ``[0, 1/P)``."""
    draws = loop.draws
    if draws is None:
        return
    for t in (draws.rot, draws.trans, draws.noise):
        if t is not None:
            t.normal_(generator=generator)
    draws.u0.uniform_(0.0, 1.0 / loop.particles, generator=generator)


def tick_draws(draws: Optional[kernels.Draws], k: int) -> Optional[kernels.Draws]:
    """Step k's draws: a view of each static tensor."""
    if draws is None:
        return None
    return kernels.Draws(*(None if t is None else t[k] for t in draws))


def config_of(args) -> FastSLAMConfig:
    """The config the script builds (``:82-90``): parity mode unless
    ``--production``; no resample under ``--no-resample``."""
    return FastSLAMConfig(
        num_particles=args.particles, max_landmarks=args.landmarks,
        max_measurements=args.measurements, parity_mode=not args.production,
        proposal_mode="fastslam2" if args.fs2 else "motion",
        resample_threshold_frac=0.0 if args.no_resample else 0.5)


def path_name(args) -> str:
    """``path`` as the script builds it, retired suffixes aside."""
    return ((f"chunked{args.chunk}" if args.chunk else "planes" if args.planes else "scan")
            + ("+frontend" if args.with_frontend else "")
            + ("+fs2" if args.fs2 else "")
            + ("+prod" if args.production else "")
            + ("+nores" if args.no_resample else "")
            + ("+fusedonly" if args.fused_only else ""))


def build_loop(args, device) -> Loop:
    """The K steps of the path ``args`` names, on ``device``."""
    cfg = config_of(args)
    p, k = args.particles, args.k
    n_valid = args.valid_measurements or args.measurements
    ms = pad_measurements(cfg, bench_measurements(n_valid), device)
    fs2 = kernels.uses_fs2(cfg)
    rotation = torch.zeros((), dtype=torch.float32, device=device)
    translation = torch.full((), 0.4, dtype=torch.float32, device=device)
    planes = init_planes_state(cfg, device) if args.planes else None

    if args.with_frontend:
        from fastslam_tpu_torch.frontend.pipeline import scan_to_measurements

        pts, vld, rots, trs = make_scan_inputs(k, cfg, device)
        step_fn = kernels.fastslam_step_planes if args.planes else kernels.fastslam_step

        def step(s, i, d, on_device):
            m = scan_to_measurements(pts[i], vld[i], cfg)
            return step_fn(s, rots[i], trs[i], m, cfg, d, on_device=on_device)
        return Loop(planes if args.planes else init_state(cfg, device), step, k, p,
                    static_draws(k, p, device, fs2=fs2))

    if args.chunk:
        c = args.chunk
        rots = torch.zeros(c, dtype=torch.float32, device=device)
        trans = torch.full((c,), 0.4, dtype=torch.float32, device=device)
        ms_c = Measurements(ms.range_bearing[None].expand(c, -1, -1).contiguous(),
                            ms.valid[None].expand(c, -1).contiguous())

        def step(s, i, d, on_device):
            s, est = kernels.fastslam_steps_planes_chunked(s, rots, trans, ms_c, cfg, d,
                                                           on_device=on_device)
            return s, est[-1]
        return Loop(planes, step, k, p, static_draws(k, p, device, chunk=c, fs2=fs2),
                    ticks_per_step=c)

    if args.fused_only:
        def step(s, i, d, on_device):
            logw, mx, my, ca, cb, cc, cd, cnt = cuda_kernels.fused_update_planes(
                s.poses, s.log_weights, s.lm_mx, s.lm_my, s.lm_ca, s.lm_cb, s.lm_cc,
                s.lm_cd, s.lm_count, ms.range_bearing, ms.valid, cfg)
            s = s.replace(log_weights=logw, lm_mx=mx, lm_my=my, lm_ca=ca, lm_cb=cb,
                          lm_cc=cc, lm_cd=cd, lm_count=cnt)
            return s, s.poses[0]
        return Loop(planes, step, k, p)

    step_fn = kernels.fastslam_step_planes if args.planes else kernels.fastslam_step

    def step(s, i, d, on_device):
        return step_fn(s, rotation, translation, ms, cfg, d, on_device=on_device)
    return Loop(planes if args.planes else init_state(cfg, device), step, k, p,
                static_draws(k, p, device, fs2=fs2))


def fields(state) -> dict:
    """The tensors of a loop state, by name."""
    return {k: v for k, v in vars(state).items() if v is not None}


def same_state(a, b) -> bool:
    """Every tensor of two loop states equal, bit for bit."""
    fa, fb = fields(a), fields(b)
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]) for k in fa)


def run_steps(loop: Loop, state, on_device: bool = False):
    """The K steps, eagerly (or under a graph capture); returns ``(state,
    out)``."""
    out = None
    for i in range(loop.k):
        state, out = loop.step(state, i, tick_draws(loop.draws, i), on_device)
    return state, out


def events():
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def reference_run(loop: Loop, gen: torch.Generator):
    """The loop's K steps eagerly from its state (never changed) with new
    draws from ``gen``, the host deciding each resample: the reference a
    graph is held to, which on the card also builds the kernels.  Returns
    ``(state, out)``."""
    fill_draws(loop, gen)
    state, out = run_steps(loop, loop.state.clone())
    return state, out.clone()


def checked_capture(loop: Loop, ref_state, ref_out):
    """The K steps, deciding on the device, captured into one CUDA graph that
    reads and writes ``static``, a copy of the loop's state, and replayed
    once with the draws :func:`reference_run` left; raises unless the
    replay ends in ``ref_state`` and ``ref_out`` bit for bit.  Returns
    ``(graph, static, out, tally)``: the last step's output tensor (valid
    after a replay) and the launches of one replay (this one counted)."""
    static = loop.state.clone()
    graph = torch.cuda.CUDAGraph()
    with cuda_kernels.captured() as tally, torch.cuda.graph(graph):
        state, out = run_steps(loop, static, on_device=True)
        for name, dst in fields(static).items():
            dst.copy_(getattr(state, name))
    cuda_kernels.replay(graph, tally)
    torch.cuda.synchronize(out.device)
    if not (same_state(static, ref_state) and torch.equal(out, ref_out)):
        raise AssertionError("the graph's K steps differ from the eager K steps")
    return graph, static, out, tally


def time_loop(loop: Loop, device, reps: int = REPS, eager: bool = True) -> dict:
    """Run the loop's K steps eagerly from its state (the reference, which
    also builds the kernels), then on the card capture them into one graph,
    replay it from the same state with the same draws and hold it to the
    eager run bit for bit (raising otherwise), and time ``reps``
    repetitions of the graph form and (``eager``) of the eager form, each
    from where the last ended with new draws: the same states and draws in
    both forms, which must end equal too.

    Returns ``graph_ms`` and ``eager_ms`` (the best repetition, all K
    steps; ``graph_ms`` None off the card), ``build_and_capture_s``,
    ``state`` and ``out`` after the first K steps, ``out_last`` after the
    last repetition, ``draws`` and the graph's ``tally``."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(SEED)
    t0 = time.perf_counter()
    ref_state, ref_out = reference_run(loop, gen)
    if not cuda:
        build_s = time.perf_counter() - t0
        gen.manual_seed(SEED + 1)
        best, state = math.inf, ref_state.clone()
        for _ in range(reps):
            t1 = time.perf_counter()
            fill_draws(loop, gen)
            state, out = run_steps(loop, state)
            last = out.clone()
            best = min(best, (time.perf_counter() - t1) * 1e3)
        return {"graph_ms": None, "eager_ms": best, "build_and_capture_s": build_s,
                "state": ref_state, "out": ref_out, "out_last": last, "draws": "eager",
                "tally": {}}

    graph, static, g_out, tally = checked_capture(loop, ref_state, ref_out)
    build_s = time.perf_counter() - t0

    def timed(run):
        gen.manual_seed(SEED + 1)
        best, last = math.inf, None
        for _ in range(reps):
            start, stop = events()
            start.record()
            fill_draws(loop, gen)
            out = run()
            stop.record()
            last = out.cpu()
            best = min(best, start.elapsed_time(stop))
        return best, last

    def replayed():
        cuda_kernels.replay(graph, tally)
        return g_out

    graph_ms, g_last = timed(replayed)
    eager_ms, state = None, ref_state.clone()
    if eager:
        def eager_run():
            nonlocal state
            state, out = run_steps(loop, state)
            return out
        eager_ms, e_last = timed(eager_run)
        if not (same_state(static, state) and torch.equal(g_last, e_last)):
            raise AssertionError("the graph's timed repetitions end in another state "
                                 "than the eager ones")
    del graph
    return {"graph_ms": graph_ms, "eager_ms": eager_ms, "build_and_capture_s": build_s,
            "state": ref_state, "out": ref_out, "out_last": g_last,
            "draws": "eager_static", "tally": tally}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m fastslam_tpu_torch.probes.step")
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--landmarks", type=int, default=64)
    ap.add_argument("--measurements", type=int, default=16)
    ap.add_argument("--valid-measurements", type=int, default=None,
                    help="number of real (non-padded) measurements")
    ap.add_argument("--k", type=int, default=50, help="steps in the graph")
    ap.add_argument("--planes", action="store_true",
                    help="planes-native state (no per-step transposes)")
    ap.add_argument("--no-resample", action="store_true",
                    help="disable resampling (fixed-cost attribution)")
    ap.add_argument("--fused-only", action="store_true",
                    help="time only the per-tick motion kernel (implies --planes)")
    ap.add_argument("--production", action="store_true",
                    help="production math instead of reference-parity quirks")
    ap.add_argument("--chunk", type=int, default=0,
                    help="ticks per kernel call (chunked planes step; implies "
                         "--planes --production)")
    ap.add_argument("--fs2", action="store_true",
                    help="FastSLAM 2.0 proposal (implies --production)")
    ap.add_argument("--with-frontend", action="store_true",
                    help="scan -> measurements frontend before each step, on the "
                         "scans of SimWorld(seed=2)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return ap


def parse(argv=None) -> argparse.Namespace:
    """The flags, with the script's implications (``:67-71``), and the
    combinations it would run under another path's name refused."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.with_frontend and (args.chunk or args.fused_only):
        ap.error("--with-frontend runs the per-tick step: not with --chunk or --fused-only")
    if args.fused_only and (args.chunk or args.fs2):
        ap.error("--fused-only times the per-tick motion kernel: not with --chunk or --fs2")
    if args.chunk:
        args.planes = True
        args.production = True
    if args.fs2:
        args.production = True
    if args.fused_only:
        args.planes = True
    return args


def run(args, device=None) -> dict:
    """Time the path ``args`` names (see :func:`parse`) on ``device``
    (default ``args.device``); returns the JSON record, and under ``"_"``
    :func:`time_loop`'s result."""
    from fastslam_tpu_torch.eval.oracle_ate import check_device
    from fastslam_tpu_torch.probes import device_fields

    device = check_device(device or args.device)
    loop = build_loop(args, device)
    res = time_loop(loop, device, reps=REPS if device.type == "cuda" else 1)
    ticks = args.k * loop.ticks_per_step
    best = res["graph_ms"] if res["graph_ms"] is not None else res["eager_ms"]
    dt = best / 1e3 / ticks
    n_valid = args.valid_measurements or args.measurements
    pose = res["out_last"].reshape(-1)
    rec = {
        "path": path_name(args),
        "step_ms": round(dt * 1e3, 4),
        "particles": args.particles,
        "updates_per_s": round(args.particles * n_valid / dt),
        "valid_measurements": n_valid,
        **({"frames_per_s": round(1 / dt, 1)} if args.with_frontend else {}),
        "build_and_capture_s": round(res["build_and_capture_s"], 2),
        "final_pose_x": round(float(pose[0]), 3),
        "eager_step_ms": (None if res["eager_ms"] is None
                          else round(res["eager_ms"] / ticks, 4)),
        "k": args.k,
        "graph": res["graph_ms"] is not None,
        "draws": res["draws"],
        "launches_per_replay": res["tally"],
        **device_fields(device),
    }
    return rec | {"_": res}


def main(argv=None) -> int:
    args = parse(argv)
    rec = run(args)
    rec.pop("_")
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
