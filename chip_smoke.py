"""Smoke test of the PyTorch/CUDA port (``fastslam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each:

0. environment: the card's name and power limit (exits non-zero without a GPU);
1. build the CUDA kernels from ``fastslam_tpu_torch/csrc`` with nvcc;
2. the per-tick kernel against its plain PyTorch version at the bench
   geometry (P=100,000 particles, L=64 landmark slots, M=16 measurements),
   production and parity, from a state seeded by 3 plain ticks;
3. the chunked kernel against its plain version, C=16 ticks, production;
4. the main path: record a 300-tick synthetic log and replay it with
   ``replay_chunked`` on the GPU at P=100,000, L=64, chunk 16; the launch
   counters must show 18 chunked and 12 per-tick launches, the ATE must be
   under 0.1 m, and a small noise-free replay must agree with the CPU path;
5. kernel and plain times per tick, with CUDA events.

Any failure raises.  The line before the last is a JSON summary of the
kernels; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

P, L, M, C = 100_000, 64, 16, 16
# bench.py's measurement set: (range, bearing) pairs
MEASUREMENTS = [(2.0 + 0.3 * i, -2.5 + 0.35 * i) for i in range(16)]
TOL = 1e-4   # atol and rtol, kernel vs plain version on the card
DEVICE = "cuda"
SOURCE = "fastslam_tpu_torch/csrc/fused_update.cu"
REPLACES = {
    "fused_update_planes": "fastslam_tpu/core/pallas_kernels.py:618",
    "fused_update_planes_multi": "fastslam_tpu/core/pallas_kernels.py:1403",
}


def phase(n, text):
    print(f"[phase {n}] {text}", flush=True)


def compare(name, got, want, tol=TOL):
    """Max abs error of ``got`` vs ``want``; raises past atol=rtol=tol."""
    import torch

    err = (got - want).abs()
    bad = err > tol + tol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: {int(bad.sum())} values off, max abs err "
                             f"{err.max().item():.3e}")
    return err.max().item()


def seeded_state(cfg, gen, ms):
    """A state after 3 plain ticks of translation: maps with matched and
    freshly appended landmarks, non-uniform weights."""
    from fastslam_tpu_torch.core import cuda_kernels, kernels
    from fastslam_tpu_torch.core.state import init_planes_state

    state = init_planes_state(cfg, DEVICE)
    for _ in range(3):
        d = kernels.draw(gen, cfg.num_particles)
        poses = kernels.propagate_particles(
            state.poses, 0.0, 0.4, cfg.rotation_noise * d.rot,
            cfg.translation_noise * d.trans)
        cuda_kernels.fused_update_planes_ref(
            poses, state.log_weights, state.lm_mx, state.lm_my, state.lm_ca,
            state.lm_cb, state.lm_cc, state.lm_cd, state.lm_count,
            ms.range_bearing, ms.valid, cfg)
        state = state.replace(
            poses=poses,
            log_weights=kernels.normalize_log_weights(state.log_weights, cfg))
    return state


def args_of(state):
    return (state.log_weights, state.lm_mx, state.lm_my, state.lm_ca,
            state.lm_cb, state.lm_cc, state.lm_cd, state.lm_count)


def compare_update(tag, got, want, before_cnt):
    """Counts must agree on all but 1e-4 * P particles; floats on the rest."""
    import torch

    cnt_k, cnt_p = got[-1], want[-1]
    mismatch = int((cnt_k != cnt_p).sum())
    if mismatch > 1e-4 * P:
        raise AssertionError(f"{tag}: lm_count differs on {mismatch} particles")
    agree = cnt_k == cnt_p
    err = 0.0
    names = ("log_weights", "mx", "my", "ca", "cb", "cc", "cd")
    for name, g, w in zip(names, got[:-1], want[:-1]):
        if g is None:
            continue
        g, w = (g[..., agree], w[..., agree])
        err = max(err, compare(f"{tag} {name}", g, w))
    appends = int((cnt_p > before_cnt).sum())
    return mismatch, err, appends


def phase2(gen, ms):
    import torch

    from fastslam_tpu_torch.config import FastSLAMConfig
    from fastslam_tpu_torch.core import cuda_kernels, kernels

    worst = 0.0
    for parity in (False, True):
        cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, max_measurements=M,
                             parity_mode=parity)
        state = seeded_state(cfg, gen, ms)
        d = kernels.draw(gen, P)
        poses = kernels.propagate_particles(
            state.poses, 0.0, 0.4, cfg.rotation_noise * d.rot,
            cfg.translation_noise * d.trans)
        sk, sp = state.clone(), state.clone()
        before = state.lm_count.clone()
        got = cuda_kernels.fused_update_planes(poses, *args_of(sk), ms.range_bearing,
                                               ms.valid, cfg)
        torch.cuda.synchronize()
        want = cuda_kernels.fused_update_planes_ref(poses, *args_of(sp),
                                                    ms.range_bearing, ms.valid, cfg)
        mismatch, err, appends = compare_update("per-tick", got, want, before)
        worst = max(worst, err)
        updated = int((want[0] != state.log_weights).sum())
        phase(2, f"per-tick {'parity' if parity else 'production'}: lm_count "
                 f"mismatches {mismatch}/{P}, max abs err {err:.3e}, "
                 f"particles updated {updated}, appended {appends}")
    return worst


def phase3(gen, ms):
    import torch

    from fastslam_tpu_torch.config import FastSLAMConfig
    from fastslam_tpu_torch.core import cuda_kernels, kernels

    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, max_measurements=M,
                         parity_mode=False)
    state = seeded_state(cfg, gen, ms)
    d = kernels.draw(gen, P, C)
    rotating = (torch.arange(C, device=DEVICE) % 4 == 3)[:, None]
    noisy_rot = torch.where(rotating, 0.2 + cfg.rotation_noise * d.rot, 0.0)
    noisy_trans = torch.where(rotating, 0.0, 0.4 + cfg.translation_noise * d.trans)
    z = ms.range_bearing[None].expand(C, M, 2).contiguous()
    zv = ms.valid[None].expand(C, M).contiguous()
    sk, sp = state.clone(), state.clone()
    before = state.lm_count.clone()
    got = cuda_kernels.fused_update_planes_multi(
        state.poses, state.log_weights, *args_of(sk)[1:], z, zv, noisy_rot,
        noisy_trans, cfg)
    torch.cuda.synchronize()
    want = cuda_kernels.fused_update_planes_multi_ref(
        state.poses, state.log_weights, *args_of(sp)[1:], z, zv, noisy_rot,
        noisy_trans, cfg)
    mismatch, err, appends = compare_update(
        "chunked", (got[3][-1],) + tuple(got[4:]), (want[3][-1],) + tuple(want[4:]),
        before)
    agree = got[-1] == want[-1]
    for name, g, w in zip(("tx", "ty", "tyaw", "tlogw"), got[:4], want[:4]):
        err = max(err, compare(f"chunked {name}", g[:, agree], w[:, agree]))
    phase(3, f"chunked C={C} production: lm_count mismatches {mismatch}/{P}, "
             f"max abs err {err:.3e}, appended {appends}")
    return err


def phase4():
    import numpy as np
    import torch

    from fastslam_tpu_torch.app.runner import replay_chunked
    from fastslam_tpu_torch.config import FastSLAMConfig
    from fastslam_tpu_torch.core import cuda_kernels
    from fastslam_tpu_torch.drivers.replay import record_log
    from fastslam_tpu_torch.drivers.sim_world import SimWorld

    log = record_log(SimWorld(seed=3), num_ticks=300)
    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, max_measurements=M,
                         parity_mode=False)
    for k in cuda_kernels.LAUNCHES:
        cuda_kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    hist = replay_chunked(log, cfg, chunk_size=C, rng=0, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    if launches != {"fused_update_planes_multi": 18, "fused_update_planes": 12}:
        raise AssertionError(f"main path launches {launches}, expected 18 chunked "
                             "and 12 per-tick")
    est = np.asarray(hist.est_poses)
    if est.shape != (300, 3) or not np.isfinite(est).all():
        raise AssertionError(f"estimates: shape {est.shape}, finite "
                             f"{np.isfinite(est).all()}")
    ate = hist.metrics()["ate_rmse_m"]
    if not ate < 0.1:
        raise AssertionError(f"ATE {ate} m >= 0.1 m")
    phase(4, f"replay_chunked 300 ticks P={P} L={L} chunk {C} on cuda: ATE "
             f"{ate:.4f} m, wall {wall:.2f} s, launches {launches}")

    # the same path, noise-free and small, on the card and on the CPU
    small = FastSLAMConfig(num_particles=256, max_landmarks=16, parity_mode=False,
                           rotation_noise=0.0, translation_noise=0.0,
                           warmup_iterations=8)
    short = record_log(SimWorld(seed=3), num_ticks=52)
    on_gpu = np.asarray(replay_chunked(short, small, chunk_size=8, device=DEVICE).est_poses)
    on_cpu = np.asarray(replay_chunked(short, small, chunk_size=8, device="cpu").est_poses)
    diff = float(np.abs(on_gpu - on_cpu).max())
    if not diff < 1e-4:
        raise AssertionError(f"small replay: cuda vs cpu max diff {diff}")
    phase(4, f"small noise-free replay (P=256, 52 ticks): cuda vs cpu max diff {diff:.3e}")
    return launches, ate


def time_ms(fn, reps):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase5(gen, ms):
    from fastslam_tpu_torch.config import FastSLAMConfig
    from fastslam_tpu_torch.core import cuda_kernels, kernels

    import torch

    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, max_measurements=M,
                         parity_mode=False)
    state = seeded_state(cfg, gen, ms)
    d = kernels.draw(gen, P, C)
    noisy_rot = torch.zeros((C, P), device=DEVICE)
    noisy_trans = 0.4 + cfg.translation_noise * d.trans
    z = ms.range_bearing[None].expand(C, M, 2).contiguous()
    zv = ms.valid[None].expand(C, M).contiguous()
    sk, sp = state.clone(), state.clone()
    tick = lambda fn, s: (lambda: fn(state.poses, *args_of(s), ms.range_bearing,
                                     ms.valid, cfg))
    chunk = lambda fn, s: (lambda: fn(state.poses, state.log_weights, *args_of(s)[1:],
                                      z, zv, noisy_rot, noisy_trans, cfg))
    # plain, kernel, kernel, plain: the card's clocks drift between runs
    t = {}
    for name, fn, reps in (
        ("plain_tick", tick(cuda_kernels.fused_update_planes_ref, sp), 3),
        ("tick", tick(cuda_kernels.fused_update_planes, sk), 20),
        ("chunk", chunk(cuda_kernels.fused_update_planes_multi, sk), 5),
        ("plain_chunk", chunk(cuda_kernels.fused_update_planes_multi_ref, sp), 2),
    ):
        t[name] = time_ms(fn, reps)
    times = {
        "fused_update_planes": (t["tick"], t["plain_tick"]),
        "fused_update_planes_multi": (t["chunk"] / C, t["plain_chunk"] / C),
    }
    for name, (k, pl) in times.items():
        phase(5, f"{name}: kernel {k:.4f} ms/tick, plain {pl:.4f} ms/tick "
                 f"(P={P} L={L} M={M}{f' C={C}' if 'multi' in name else ''})")
    return times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    phase(0, f"torch {torch.__version__} cuda {torch.version.cuda}, "
             f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from fastslam_tpu_torch.config import FastSLAMConfig
    from fastslam_tpu_torch.core import _build
    from fastslam_tpu_torch.core.state import pad_measurements

    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    report = _build.library_path().with_suffix(".log")
    regs = [ln.strip() for ln in report.read_text().splitlines() if "registers" in ln] \
        if report.exists() else ["(cached build, no ptxas report)"]
    phase(1, f"built {SOURCE} in {build_s:.1f} s; ptxas: {' | '.join(regs)}")

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    ms = pad_measurements(FastSLAMConfig(max_measurements=M), MEASUREMENTS, DEVICE)
    err_tick = phase2(gen, ms)
    err_chunk = phase3(gen, ms)
    launches, _ = phase4()
    times = phase5(gen, ms)

    errs = {"fused_update_planes": err_tick, "fused_update_planes_multi": err_chunk}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name in ("fused_update_planes", "fused_update_planes_multi")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
