"""The filter step with and without its kernel (the counterpart of
``scripts/bench_compare.py``).

The script times ``fastslam_step`` per tick with and without the fused
Pallas kernel (``use_pallas``), 3 warm steps and then ``--steps`` steps, and
prints the step's ms, particle updates/s, the pose and ``lm_count[0]`` of
each variant.  The port chooses kernel or plain version by device, not by a
switch, so the probe composes the plain step itself from the public
functions of ``core/kernels.py`` and adds no switch to the main path:

* ``kernel``: ``kernels.fastslam_step`` on the card's tensors, whose
  measurement update is one launch of the per-tick motion kernel
  (``update_particles`` through ``cuda_kernels.fused_update``, §2 row 1 on
  the blocks layout);
* ``plain``: the same step with the measurement update as the loop of
  ``update_particles_one`` over the measurements, on the same card's
  tensors (:func:`plain_step`).

Both run the script's config (the default: parity mode, the motion
proposal) at P=100,000, L=64, M=16, ``bench.py``'s measurement set,
rotation 0, translation 0.4, from the same fresh state with the same draws,
timed on the host clock with one synchronisation after the steps.

Beside them, the four planes kernels (§2 rows 1–4, production) against
their plain versions (``cuda_kernels.*`` and ``cuda_kernels.*_ref``) on one
shared state, seeded by 3 plain ticks, with the same inputs: ms per tick
(CUDA events, ``--steps`` calls of the kernel after 3 warm ones, and
``--plain-steps`` of the plain version after one), particle updates/s, and
the largest absolute difference of any output of one call from the shared
state.  On the CPU both sides of a pair are the plain version.

Then the device-decided resample (``csrc/resample.cu``: the staircase
``cuda_kernels.resample_staircase`` and the in-place gather
``cuda_kernels.resample_gather``) at the main path's shapes (production:
five planes, poses and counts) against their plain versions: ms per call
with a resample due and not due (``--steps`` calls replayed in one CUDA
graph, CUDA events), the bound (one read and one write of the state where
due, nothing where not), the plain versions' ms, and the ATen path the
parent ran (``fixed_order_cumsum``, ``grid_staircase_indices`` with its
``torch.cummax``, ``resample_planes_state``'s ``index_select``) as the
library yardstick; and the largest difference of the kernels' ancestors
and state from the plain versions'.

Prints one JSON line, with the card's name and power limit::

    python -m fastslam_tpu_torch.probes.compare [--particles 100000] [--steps 20] \\
        [--plain-steps 3] [--only {kernel,plain}] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from fastslam_tpu_torch.config import FastSLAMConfig
from fastslam_tpu_torch.core import cuda_kernels, kernels
from fastslam_tpu_torch.core.state import (
    FilterState, Measurements, init_planes_state, init_state, pad_measurements,
)
from fastslam_tpu_torch.probes.step import bench_measurements, events

WARM = 3
CHUNK = 16
ROWS = {1: "fused_update_planes", 2: "fused_update_planes_multi", 3: "fused_fs2_planes",
        4: "fused_fs2_planes_multi"}


def plain_step(state: FilterState, rotation, translation, measurements: Measurements,
               config: FastSLAMConfig, draws: kernels.Draws):
    """``kernels.fastslam_step`` composed from the public functions, its
    measurement update the loop of ``update_particles_one`` on any device:
    propose, the loop, normalize, Neff, the conditional systematic resample
    (decided on the host), the argmax pose.  Returns ``(state, pose)``."""
    state = kernels.propose(state, rotation, translation, measurements, config, draws)
    log_w, mean, cov, count = (state.log_weights, state.lm_mean, state.lm_cov,
                               state.lm_count)
    for m in range(measurements.capacity):
        log_w, mean, cov, count = kernels.update_particles_one(
            state.poses, log_w, mean, cov, count, measurements.range_bearing[m],
            measurements.valid[m], config, update_weights=kernels.ekf_weights(config))
    log_w = kernels.normalize_log_weights(log_w, config)
    state = state.replace(log_weights=log_w, lm_mean=mean, lm_cov=cov, lm_count=count)
    p = state.num_particles
    if bool(kernels.effective_particles(log_w, config) < config.resample_threshold_frac * p):
        idx = kernels.systematic_resample_indices(torch.exp(log_w), draws.u0)
        state = kernels.resample_state(state, idx, config)
    return state, kernels.estimate_pose(state)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def blocks_variant(variant: str, particles: int, landmarks: int, measurements: int,
                   steps: int, device, seed: int = 0) -> dict:
    """The script's loop for one variant: 3 warm steps, then ``steps``
    steps timed on the host clock."""
    cfg = FastSLAMConfig(num_particles=particles, max_landmarks=landmarks,
                         max_measurements=measurements)
    step = kernels.fastslam_step if variant == "kernel" else plain_step
    state = init_state(cfg, device)
    ms = pad_measurements(cfg, bench_measurements(measurements), device)
    rotation = torch.zeros((), device=device)
    translation = torch.full((), 0.4, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = lambda: kernels.draw(gen, particles)
    t0 = time.time()
    for _ in range(WARM):
        state, pose = step(state, rotation, translation, ms, cfg, draw())
    _sync(device)
    warm_s = time.time() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        state, pose = step(state, rotation, translation, ms, cfg, draw())
    _sync(device)
    dt = (time.perf_counter() - t0) / steps
    return {"step_ms": round(dt * 1e3, 4),
            "updates_per_s": round(particles * measurements / dt),
            "compile_and_warm_s": round(warm_s, 2),
            "pose": [round(float(v), 4) for v in pose.cpu()],
            "lm_count0": int(state.lm_count[0])}


def seeded_planes(cfg: FastSLAMConfig, gen: torch.Generator, ms: Measurements, device):
    """A production state after 3 plain ticks of translation: maps with
    matched and appended landmarks, non-uniform weights."""
    state = init_planes_state(cfg, device)
    for _ in range(3):
        d = kernels.draw(gen, cfg.num_particles)
        poses = kernels.propagate_particles(state.poses, 0.0, 0.4, cfg.rotation_noise * d.rot,
                                            cfg.translation_noise * d.trans)
        cuda_kernels.fused_update_planes_ref(
            poses, state.log_weights, state.lm_mx, state.lm_my, state.lm_ca, state.lm_cb,
            state.lm_cc, state.lm_cd, state.lm_count, ms.range_bearing, ms.valid, cfg)
        state = state.replace(poses=poses,
                              log_weights=kernels.normalize_log_weights(state.log_weights, cfg))
    return state


def row_calls(cfg: FastSLAMConfig, state, gen: torch.Generator, ms: Measurements, device):
    """Per row, ``(kernel(state), plain(state), ticks per call)``: one call
    of the row's kernel or plain version on a state (whose planes and
    counts it updates in place), with inputs drawn once."""
    p = cfg.num_particles
    fs2_cfg = cfg.replace(proposal_mode="fastslam2")
    d = kernels.draw(gen, p)
    poses = kernels.propagate_particles(state.poses, 0.0, 0.4, cfg.rotation_noise * d.rot,
                                        cfg.translation_noise * d.trans)
    z = ms.range_bearing[None].expand(CHUNK, -1, -1).contiguous()
    zv = ms.valid[None].expand(CHUNK, -1).contiguous()
    dc = kernels.draw(gen, p, CHUNK)
    noisy_rot = (cfg.rotation_noise * dc.rot).contiguous()     # rotation 0: noise only
    noisy_trans = (0.4 + cfg.translation_noise * dc.trans).contiguous()
    zero = torch.zeros(p, device=device)
    pred = kernels.propagate_particles(state.poses, 0.0, 0.4, zero, zero)
    rot, trans = torch.zeros((), device=device), torch.full((), 0.4, device=device)
    _, _, s_t2, s_r2, fxy = kernels.fs2_prior_scalars(rot, trans, fs2_cfg)
    noise = kernels.draw(gen, p, fs2=True).noise
    rots, transs = torch.zeros(CHUNK, device=device), torch.full((CHUNK,), 0.4, device=device)
    prior_c = kernels.fs2_prior_scalars(rots, transs, fs2_cfg)
    noise_c = kernels.draw(gen, p, CHUNK, fs2=True).noise
    planes = lambda s: (s.lm_mx, s.lm_my, s.lm_ca, s.lm_cb, s.lm_cc, s.lm_cd, s.lm_count)

    def call(row, plain):
        name = ROWS[row] + ("_ref" if plain else "")
        fn = getattr(cuda_kernels, name)
        if row == 1:
            return lambda s: fn(poses, s.log_weights, *planes(s), ms.range_bearing, ms.valid,
                                cfg)
        if row == 2:
            return lambda s: fn(s.poses, s.log_weights, *planes(s), z, zv, noisy_rot,
                                noisy_trans, cfg)
        if row == 3:
            return lambda s: fn(pred, s.log_weights, *planes(s), ms.range_bearing, ms.valid,
                                noise, s_t2, s_r2, fxy, fs2_cfg)
        return lambda s: fn(s.poses, s.log_weights, *planes(s), z, zv, noise_c, *prior_c,
                            fs2_cfg)
    return {row: (call(row, False), call(row, True), CHUNK if row in (2, 4) else 1)
            for row in ROWS}


def max_abs_diff(got, want) -> float:
    """The largest absolute difference over a call's outputs (None where
    both lack one; inf where only one does or the shapes differ)."""
    worst = 0.0
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        if g is None or w is None or g.shape != w.shape:
            return math.inf
        if g.numel():
            worst = max(worst, float((g.double() - w.double()).abs().max()))
    return worst


def time_call(fn, state, calls: int, warm: int, device) -> float:
    """ms per call of ``fn`` on ``state`` (CUDA events on the card, the host
    clock on the CPU)."""
    for _ in range(warm):
        fn(state)
    _sync(device)
    if device.type == "cuda":
        start, stop = events()
        start.record()
        for _ in range(calls):
            fn(state)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / calls
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(state)
    return (time.perf_counter() - t0) * 1e3 / calls


def planes_rows(particles: int, landmarks: int, measurements: int, steps: int,
                plain_steps: int, device, seed: int = 0) -> list:
    """Rows 1–4 against their plain versions on one shared state."""
    cfg = FastSLAMConfig(num_particles=particles, max_landmarks=landmarks,
                         max_measurements=measurements, parity_mode=False)
    gen = torch.Generator(device=device).manual_seed(seed)
    ms = pad_measurements(cfg, bench_measurements(measurements), device)
    shared = seeded_planes(cfg, gen, ms, device)
    out = []
    for row, (kernel, plain, ticks) in row_calls(cfg, shared, gen, ms, device).items():
        diff = max_abs_diff(kernel(shared.clone()), plain(shared.clone()))
        k_ms = time_call(kernel, shared.clone(), steps, WARM, device) / ticks
        p_ms = time_call(plain, shared.clone(), plain_steps, 1, device) / ticks
        out.append({"row": row, "kernel": ROWS[row], "ticks_per_call": ticks,
                    "ms": round(k_ms, 4), "plain_ms": round(p_ms, 4),
                    "updates_per_s": round(particles * measurements / k_ms * 1e3),
                    "plain_updates_per_s": round(particles * measurements / p_ms * 1e3),
                    "max_abs_diff": diff})
        print(f"row {row} {ROWS[row]}: {k_ms:.4f} ms/tick, plain {p_ms:.4f}, "
              f"max |diff| {diff:.3e}", file=sys.stderr)
    return out


# the H100's published memory rate (bytes per second), which bounds the resample
PEAK_BYTES_PER_S = 3.35e12


def graph_ms(fn, reps: int, device) -> float:
    """ms per call of ``fn()``: on the card ``reps`` calls replayed in one
    CUDA graph (``segment_sum_turns.replay_ms``), so the host's launch cost
    is not timed; on the CPU the host clock."""
    if device.type == "cuda":
        from fastslam_tpu_torch.probes.segment_sum_turns import replay_ms

        return replay_ms(fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def resample_row(particles: int, landmarks: int, steps: int, plain_steps: int, device,
                 seed: int = 0) -> dict:
    """The resample's two kernels against their plain versions and the
    parent's ATen path, on one random production state and spread weights."""
    cfg = FastSLAMConfig(num_particles=particles, max_landmarks=landmarks, parity_mode=False)
    p = particles
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_planes_state(cfg, device)
    for t in (state.lm_mx, state.lm_my, state.lm_ca, state.lm_cb, state.lm_cd, state.poses):
        t.normal_(generator=gen)
    state.lm_count.random_(0, landmarks + 1, generator=gen)
    log_w = kernels.normalize_log_weights(
        3.0 * torch.randn(p, generator=gen, device=device), cfg)
    w = torch.exp(log_w)
    u0 = torch.rand((), generator=gen, device=device) / p
    flags = {"due": torch.tensor(True, device=device),
             "not_due": torch.tensor(False, device=device)}
    buffers = lambda s: ([s.lm_mx, s.lm_my, s.lm_ca, s.lm_cb, s.lm_cd], [s.poses, s.lm_count])
    due = flags["due"]
    idx = cuda_kernels.resample_staircase(w, u0, due)
    idx_ref = cuda_kernels.resample_staircase_ref(w, u0, due)
    got, want = state.clone(), state.clone()
    cuda_kernels.resample_gather(*buffers(got), idx, due)
    cuda_kernels.resample_gather_ref(*buffers(want), idx_ref, due)
    diff = max(max_abs_diff([idx], [idx_ref]),
               max_abs_diff(sum(buffers(got), []), sum(buffers(want), [])))
    work = state.clone()
    stair = {k: graph_ms(lambda f=f: cuda_kernels.resample_staircase(w, u0, f), steps, device)
             for k, f in flags.items()}
    gather = {k: graph_ms(lambda f=f: cuda_kernels.resample_gather(*buffers(work), idx, f),
                          steps, device) for k, f in flags.items()}

    def plain():
        i = cuda_kernels.resample_staircase_ref(w, u0, due)
        cuda_kernels.resample_gather_ref(*buffers(work), i, due)

    def library():
        i = kernels.grid_staircase_indices(kernels.fixed_order_cumsum(w), u0, p)
        kernels.resample_planes_state(work, i, cfg)

    plain_ms = time_call(lambda _: plain(), None, plain_steps, 1, device)
    library_ms = time_call(lambda _: library(), None, steps, WARM, device)
    state_bytes = sum(t.numel() * t.element_size() for t in sum(buffers(state), []))
    bound_ms = (2 * state_bytes + w.numel() * 4 + idx.numel() * 8) / PEAK_BYTES_PER_S * 1e3
    ms = {k: stair[k] + gather[k] for k in flags}
    print(f"resample: {ms['due']:.4f} ms due (staircase {stair['due']:.4f}, gather "
          f"{gather['due']:.4f}), {ms['not_due']:.4f} not due; bound {bound_ms:.4f} / 0; "
          f"plain {plain_ms:.4f}, ATen {library_ms:.4f}; max |diff| {diff:.3e}",
          file=sys.stderr)
    return {"kernels": ["resample_staircase", "resample_gather"], "state_bytes": state_bytes,
            "ms": {k: round(v, 4) for k, v in ms.items()},
            "staircase_ms": {k: round(v, 4) for k, v in stair.items()},
            "gather_ms": {k: round(v, 4) for k, v in gather.items()},
            "bound_ms": {"due": round(bound_ms, 4), "not_due": 0.0},
            "plain_ms": round(plain_ms, 4), "library_ms": round(library_ms, 4),
            "max_abs_diff": diff}


def run(device="cuda", particles: int = 100_000, landmarks: int = 64, measurements: int = 16,
        steps: int = 20, plain_steps: int = 3, only=None) -> dict:
    """Both variants of the blocks step and the four planes rows; returns
    the record."""
    from fastslam_tpu_torch.eval.oracle_ate import check_device
    from fastslam_tpu_torch.probes import device_fields

    device = check_device(device)
    blocks = {}
    for variant in ((only,) if only else ("kernel", "plain")):
        r = blocks_variant(variant, particles, landmarks, measurements, steps, device)
        blocks[variant] = r
        print(f"{variant}: step={r['step_ms']:.2f}ms  updates/s={r['updates_per_s']:,}  "
              f"(compile+warm {r['compile_and_warm_s']:.1f}s)  pose={r['pose']}  "
              f"lm_count[0]={r['lm_count0']}", file=sys.stderr)
    return {"particles": particles, "landmarks": landmarks, "measurements": measurements,
            "steps": steps, "blocks_step": blocks,
            "planes_kernels": planes_rows(particles, landmarks, measurements, steps,
                                          plain_steps, device),
            "resample": resample_row(particles, landmarks, steps, plain_steps, device),
            **device_fields(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fastslam_tpu_torch.probes.compare")
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--landmarks", type=int, default=64)
    ap.add_argument("--measurements", type=int, default=16)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--plain-steps", type=int, default=3,
                    help="timed calls of each planes row's plain version")
    ap.add_argument("--only", choices=["kernel", "plain"], default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.particles, args.landmarks, args.measurements,
                         args.steps, args.plain_steps, args.only)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
