"""Smoke test of the PyTorch/CUDA port (``fastslam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each (or more):

0. environment: the card's name and power limit (exits non-zero without a GPU);
1. build the CUDA kernels from ``fastslam_tpu_torch/csrc`` with nvcc, and
   print each kernel's registers and spills from the ``ptxas`` report;
2. the per-tick motion kernel against its plain PyTorch version at the
   bench geometry (P=100,000 particles, L=64 landmark slots, M=16
   measurements), production and parity, from a state seeded by 3 plain
   ticks;
3. the chunked motion kernel against its plain version, C=16 ticks;
4. the motion main path: record a 300-tick synthetic log and replay it with
   ``replay_chunked`` on the GPU at P=100,000, L=64, chunk 16; the launch
   counters must show 18 chunked and 12 per-tick motion launches and no fs2
   launch, the ATE must be under 0.1 m, a second run must give the same
   estimates bit for bit, and a small noise-free replay must agree with the
   CPU path;
5. the per-tick FastSLAM 2.0 kernel against its plain version at the bench
   geometry, for both weightings (EKF pass, and evidence with the mode dial
   at 0.37);
6. the chunked fs2 kernel against its plain version, C=16, rotation and
   translation ticks, per-tick floors and the dial at 0.37 on some ticks;
7. the fs2 main path: the same replay with ``proposal_mode="fastslam2"``;
   the counters must show 18 chunked and 12 per-tick fs2 launches and no
   motion launch, the ATE must be under 0.15 m, and a second run must give
   the same estimates bit for bit;
8. fs2 on the card against the CPU: 3 chunks of 8 and 4 tail ticks at
   P=256, L=16 with the same draws; estimates and final state within
   atol = rtol = 1e-4;
9. kernel and plain times per tick, with CUDA events.

Any failure raises.  The line before the last is a JSON summary of the
kernels; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

P, L, M, C = 100_000, 64, 16, 16
# bench.py's measurement set: (range, bearing) pairs
MEASUREMENTS = [(2.0 + 0.3 * i, -2.5 + 0.35 * i) for i in range(16)]
TOL = 1e-4   # atol and rtol, kernel vs plain version on the card
DEVICE = "cuda"
KERNELS = {   # name: (source, the TPU kernel it replaces)
    "fused_update_planes": ("fastslam_tpu_torch/csrc/fused_update.cu",
                            "fastslam_tpu/core/pallas_kernels.py:618"),
    "fused_update_planes_multi": ("fastslam_tpu_torch/csrc/fused_update.cu",
                                  "fastslam_tpu/core/pallas_kernels.py:1403"),
    "fused_fs2_planes": ("fastslam_tpu_torch/csrc/fused_fs2.cu",
                         "fastslam_tpu/core/pallas_kernels.py:1113"),
    "fused_fs2_planes_multi": ("fastslam_tpu_torch/csrc/fused_fs2.cu",
                               "fastslam_tpu/core/pallas_kernels.py:1735"),
}
MOTION = ("fused_update_planes", "fused_update_planes_multi")
FS2 = ("fused_fs2_planes", "fused_fs2_planes_multi")


def phase(n, text):
    print(f"[phase {n}] {text}", flush=True)


def config(**kw):
    from fastslam_tpu_torch.config import FastSLAMConfig

    kw.setdefault("parity_mode", False)
    return FastSLAMConfig(num_particles=P, max_landmarks=L, max_measurements=M, **kw)


def compare(name, got, want, tol=TOL):
    """Max abs error of ``got`` vs ``want``; raises past atol=rtol=tol."""
    import torch

    err = (got - want).abs()
    bad = err > tol + tol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: {int(bad.sum())} values off, max abs err "
                             f"{err.max().item():.3e}")
    return err.max().item()


def ptxas_summary(report: str):
    """``kernel<flags>: N registers, S bytes spill stores`` per kernel."""
    out, name = [], None
    for line in report.splitlines():
        entry = re.search(r"entry function '(\S+)'", line)
        if entry:
            m = re.search(r"(fused_(?:update|fs2)_planes(?:_multi)?_kernel)I((?:Lb[01]E)+)",
                          entry.group(1))
            name = (f"{m.group(1)}<{','.join(re.findall('Lb([01])E', m.group(2)))}>"
                    if m else entry.group(1))
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and name:
            out.append([name, None, int(spill.group(1))])
        regs = re.search(r"Used (\d+) registers", line)
        if regs and out and out[-1][0] == name:
            out[-1][1] = int(regs.group(1))
    return [f"{n}: {r} registers, {s} B spill stores" for n, r, s in out]


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
    """Counts must agree on all but 1e-4 * P particles; floats on the rest.
    ``got``/``want``: (log_weights, mx, my, ca, cb, cc, cd, lm_count)."""
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
    return mismatch, err, appends, agree


def compare_chunk(tag, got, want, before_cnt):
    """Chunked outputs (tx, ty, tyaw, tlogw [C, P], planes, lm_count)."""
    mismatch, err, appends, agree = compare_update(
        tag, (got[3][-1],) + tuple(got[4:]), (want[3][-1],) + tuple(want[4:]),
        before_cnt)
    for name, g, w in zip(("tx", "ty", "tyaw", "tlogw"), got[:4], want[:4]):
        err = max(err, compare(f"{tag} {name}", g[:, agree], w[:, agree]))
    return mismatch, err, appends


def chunk_motion():
    """Per-tick rotation and translation of a chunk: every fourth tick
    rotates by 0.2 rad, the others translate 0.4 m."""
    import torch

    rotating = torch.arange(C, device=DEVICE) % 4 == 3
    return rotating, torch.where(rotating, 0.2, 0.0), torch.where(rotating, 0.0, 0.4)


def tiled(ms):
    return (ms.range_bearing[None].expand(C, M, 2).contiguous(),
            ms.valid[None].expand(C, M).contiguous())


def phase2(gen, ms):
    import torch

    from fastslam_tpu_torch.core import cuda_kernels, kernels

    worst = 0.0
    for parity in (False, True):
        cfg = config(parity_mode=parity)
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
        mismatch, err, appends, _ = compare_update("per-tick", got, want, before)
        worst = max(worst, err)
        updated = int((want[0] != state.log_weights).sum())
        phase(2, f"per-tick {'parity' if parity else 'production'}: lm_count "
                 f"mismatches {mismatch}/{P}, max abs err {err:.3e}, "
                 f"particles updated {updated}, appended {appends}")
    return worst


def phase3(gen, ms):
    import torch

    from fastslam_tpu_torch.core import cuda_kernels, kernels

    cfg = config()
    state = seeded_state(cfg, gen, ms)
    d = kernels.draw(gen, P, C)
    rotating, rots, trans = chunk_motion()
    noisy_rot = torch.where(rotating[:, None], rots[:, None] + cfg.rotation_noise * d.rot, 0.0)
    noisy_trans = torch.where(rotating[:, None], 0.0,
                              trans[:, None] + cfg.translation_noise * d.trans)
    z, zv = tiled(ms)
    sk, sp = state.clone(), state.clone()
    before = state.lm_count.clone()
    got = cuda_kernels.fused_update_planes_multi(
        state.poses, state.log_weights, *args_of(sk)[1:], z, zv, noisy_rot,
        noisy_trans, cfg)
    torch.cuda.synchronize()
    want = cuda_kernels.fused_update_planes_multi_ref(
        state.poses, state.log_weights, *args_of(sp)[1:], z, zv, noisy_rot,
        noisy_trans, cfg)
    mismatch, err, appends = compare_chunk("chunked", got, want, before)
    phase(3, f"chunked C={C} production: lm_count mismatches {mismatch}/{P}, "
             f"max abs err {err:.3e}, appended {appends}")
    return err


def replay_main_path(n, log, cfg, kernels_run, ate_bar):
    """``replay_chunked`` twice with the counters zeroed just before the
    first run; the first run must launch only ``kernels_run`` (18 chunked,
    12 per-tick), reach ATE < ``ate_bar``, and the second must repeat its
    estimates bit for bit.  Returns (launches, ATE)."""
    import numpy as np
    import torch

    from fastslam_tpu_torch.app.runner import replay_chunked
    from fastslam_tpu_torch.core import cuda_kernels

    for k in cuda_kernels.LAUNCHES:
        cuda_kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    hist = replay_chunked(log, cfg, chunk_size=C, rng=0, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    tick, chunked = kernels_run
    expected = {k: 0 for k in launches} | {chunked: 18, tick: 12}
    if launches != expected:
        raise AssertionError(f"main path launches {launches}, expected {expected}")
    est = np.asarray(hist.est_poses)
    if est.shape != (300, 3) or not np.isfinite(est).all():
        raise AssertionError(f"estimates: shape {est.shape}, finite "
                             f"{np.isfinite(est).all()}")
    ate = hist.metrics()["ate_rmse_m"]
    if not ate < ate_bar:
        raise AssertionError(f"ATE {ate} m >= {ate_bar} m")
    phase(n, f"replay_chunked 300 ticks P={P} L={L} chunk {C} on cuda, "
             f"proposal {cfg.proposal_mode}: ATE {ate:.4f} m, wall {wall:.2f} s, "
             f"launches {launches}")
    again = np.asarray(replay_chunked(log, cfg, chunk_size=C, rng=0,
                                      device=DEVICE).est_poses)
    if not np.array_equal(again, est):
        raise AssertionError(f"a second run differs: max diff "
                             f"{np.abs(again - est).max():.3e}")
    phase(n, "a second run gives the same 300 estimates bit for bit")
    return launches, ate


def phase4(log):
    import numpy as np

    from fastslam_tpu_torch.app.runner import replay_chunked
    from fastslam_tpu_torch.config import FastSLAMConfig
    from fastslam_tpu_torch.drivers.replay import record_log
    from fastslam_tpu_torch.drivers.sim_world import SimWorld

    launches, _ = replay_main_path(4, log, config(), MOTION, 0.1)

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
    return launches


def fs2_tick_inputs(cfg, gen, state, dial):
    """Mean-motion prediction of a 0.4 m translation, draws and prior."""
    import torch

    from fastslam_tpu_torch.core import kernels

    zero = torch.zeros(P, device=DEVICE)
    pred = kernels.propagate_particles(state.poses, 0.0, 0.4, zero, zero)
    _, _, s_t2, s_r2, fxy = kernels.fs2_prior_scalars(
        torch.tensor(0.0, device=DEVICE), torch.tensor(0.4, device=DEVICE), cfg)
    noise = kernels.draw(gen, P, fs2=True).noise
    return pred, noise, s_t2, s_r2, fxy, dial


def phase5(gen, ms):
    import torch

    from fastslam_tpu_torch.core import cuda_kernels

    worst = 0.0
    for evidence, dial in ((False, None), (True, 0.37)):
        cfg = config(proposal_mode="fastslam2", fs2_evidence_weights=evidence)
        state = seeded_state(cfg, gen, ms)
        pred, noise, s_t2, s_r2, fxy, dial = fs2_tick_inputs(cfg, gen, state, dial)
        sk, sp = state.clone(), state.clone()
        before = state.lm_count.clone()
        tail = (ms.range_bearing, ms.valid, noise, s_t2, s_r2, fxy, cfg)
        got = cuda_kernels.fused_fs2_planes(pred, *args_of(sk), *tail,
                                            evidence_scale=dial)
        torch.cuda.synchronize()
        want = cuda_kernels.fused_fs2_planes_ref(pred, *args_of(sp), *tail,
                                                 evidence_scale=dial)
        mismatch, err, appends, agree = compare_update("fs2 per-tick", got[1:],
                                                       want[1:], before)
        err = max(err, compare("fs2 per-tick poses", got[0][agree], want[0][agree]))
        worst = max(worst, err)
        moved = float((want[0] - pred).abs().max())
        phase(5, f"fs2 per-tick, evidence weights {evidence}, dial {dial}: lm_count "
                 f"mismatches {mismatch}/{P}, max abs err {err:.3e}, appended "
                 f"{appends}, max |sample - prediction| {moved:.3e}")
    return worst


def fs2_chunk_inputs(cfg, gen):
    """Chunk draws, the prior of rotation and translation ticks with
    per-tick floors, and the mode dial at 0.37 on every third tick."""
    import torch

    from fastslam_tpu_torch.core import kernels

    _, rots, trans = chunk_motion()
    floors = (torch.linspace(0.004, 0.02, C, device=DEVICE),
              torch.linspace(0.01, 0.002, C, device=DEVICE))
    dial = torch.where(torch.arange(C, device=DEVICE) % 3 == 1, 0.37, 1.0)
    prior = kernels.fs2_prior_scalars(rots, trans, cfg, floors)
    return kernels.draw(gen, P, C, fs2=True).noise, prior, dial


def phase6(gen, ms):
    import torch

    from fastslam_tpu_torch.core import cuda_kernels

    worst = 0.0
    for evidence in (False, True):
        cfg = config(proposal_mode="fastslam2", fs2_evidence_weights=evidence)
        state = seeded_state(cfg, gen, ms)
        noise, prior, dial = fs2_chunk_inputs(cfg, gen)
        z, zv = tiled(ms)
        sk, sp = state.clone(), state.clone()
        before = state.lm_count.clone()
        got = cuda_kernels.fused_fs2_planes_multi(
            state.poses, state.log_weights, *args_of(sk)[1:], z, zv, noise, *prior,
            cfg, evidence_scale=dial)
        torch.cuda.synchronize()
        want = cuda_kernels.fused_fs2_planes_multi_ref(
            state.poses, state.log_weights, *args_of(sp)[1:], z, zv, noise, *prior,
            cfg, evidence_scale=dial)
        mismatch, err, appends = compare_chunk("fs2 chunked", got, want, before)
        worst = max(worst, err)
        phase(6, f"fs2 chunked C={C}, evidence weights {evidence}: lm_count "
                 f"mismatches {mismatch}/{P}, max abs err {err:.3e}, appended {appends}")
    return worst


def phase8():
    """fs2 steps on the card against the CPU, from the same draws."""
    import numpy as np
    import torch

    from fastslam_tpu_torch.app.runner import odometry, scan_points
    from fastslam_tpu_torch.config import FastSLAMConfig
    from fastslam_tpu_torch.core import kernels
    from fastslam_tpu_torch.core.state import Measurements, init_planes_state
    from fastslam_tpu_torch.drivers.replay import record_log
    from fastslam_tpu_torch.drivers.sim_world import SimWorld
    from fastslam_tpu_torch.frontend.pipeline import scan_to_measurements
    from fastslam_tpu_torch.interop import planes_state_to_numpy

    p, c, chunks, tail = 256, 8, 3, 4
    cfg = FastSLAMConfig(num_particles=p, max_landmarks=16, parity_mode=False,
                         proposal_mode="fastslam2")
    log = record_log(SimWorld(seed=3), num_ticks=c * chunks + tail)
    pts, valid = scan_points(log)
    ms = [scan_to_measurements(torch.from_numpy(a), torch.from_numpy(v), cfg)
          for a, v in zip(pts, valid)]
    rb = torch.stack([m.range_bearing for m in ms])
    mv = torch.stack([m.valid for m in ms])
    rots, trans = (torch.from_numpy(a) for a in odometry(log, cfg))
    gen = torch.Generator().manual_seed(8)
    draws = [kernels.draw(gen, p, c, fs2=True) for _ in range(chunks)]
    draws += [kernels.draw(gen, p, fs2=True) for _ in range(tail)]

    def run(device):
        to = lambda t: t.to(device)
        state = init_planes_state(cfg, device)
        est = []
        for i, d in enumerate(draws):
            d = kernels.Draws(None, None, to(d.u0), to(d.noise))
            if i < chunks:
                sl = slice(i * c, (i + 1) * c)
                state, e = kernels.fastslam_steps_planes_chunked(
                    state, to(rots[sl]), to(trans[sl]), Measurements(to(rb[sl]), to(mv[sl])),
                    cfg, d)
            else:
                t = c * chunks + i - chunks
                state, e = kernels.fastslam_step_planes(
                    state, to(rots[t]), to(trans[t]), Measurements(to(rb[t]), to(mv[t])),
                    cfg, d)
                e = e[None]
            est.append(e.cpu())
        return torch.cat(est).numpy(), planes_state_to_numpy(state)

    est_gpu, st_gpu = run(DEVICE)
    est_cpu, st_cpu = run("cpu")
    if not np.array_equal(st_gpu["lm_count"], st_cpu["lm_count"]):
        raise AssertionError("fs2 cuda vs cpu: lm_count differs")
    pairs = [("estimates", est_gpu, est_cpu)] + [
        (k, st_gpu[k], v) for k, v in st_cpu.items() if v is not None and k != "lm_count"]
    errs = {k: compare(f"fs2 cuda vs cpu {k}", torch.from_numpy(g), torch.from_numpy(c))
            for k, g, c in pairs}
    worst = max(errs, key=errs.get)
    phase(8, f"fs2 steps ({chunks} chunks of {c} + {tail} ticks, P={p}): cuda vs cpu "
             f"within atol=rtol={TOL}, max abs err {errs[worst]:.3e} ({worst}), "
             f"estimates {errs['estimates']:.3e}, "
             f"{int(st_cpu['lm_count'].max())} landmarks at most")


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


def phase9(gen, ms):
    import torch

    from fastslam_tpu_torch.core import cuda_kernels, kernels

    cfg = config()
    state = seeded_state(cfg, gen, ms)
    d = kernels.draw(gen, P, C)
    noisy_rot = torch.zeros((C, P), device=DEVICE)
    noisy_trans = 0.4 + cfg.translation_noise * d.trans
    z, zv = tiled(ms)
    sk, sp = state.clone(), state.clone()
    tick = lambda fn, s: (lambda: fn(state.poses, *args_of(s), ms.range_bearing,
                                     ms.valid, cfg))
    chunk = lambda fn, s: (lambda: fn(state.poses, state.log_weights, *args_of(s)[1:],
                                      z, zv, noisy_rot, noisy_trans, cfg))
    fcfg = config(proposal_mode="fastslam2")
    pred, noise, s_t2, s_r2, fxy, _ = fs2_tick_inputs(fcfg, gen, state, None)
    cnoise, prior, _ = fs2_chunk_inputs(fcfg, gen)
    fs2_tick = lambda fn, s: (lambda: fn(pred, *args_of(s), ms.range_bearing, ms.valid,
                                         noise, s_t2, s_r2, fxy, fcfg))
    fs2_chunk = lambda fn, s: (lambda: fn(state.poses, state.log_weights,
                                          *args_of(s)[1:], z, zv, cnoise, *prior, fcfg))
    # plain, kernel, kernel, plain: the card's clocks drift between runs
    t = {}
    for name, fn, reps in (
        ("plain_tick", tick(cuda_kernels.fused_update_planes_ref, sp), 3),
        ("plain_fs2_tick", fs2_tick(cuda_kernels.fused_fs2_planes_ref, sp), 3),
        ("tick", tick(cuda_kernels.fused_update_planes, sk), 20),
        ("fs2_tick", fs2_tick(cuda_kernels.fused_fs2_planes, sk), 20),
        ("chunk", chunk(cuda_kernels.fused_update_planes_multi, sk), 5),
        ("fs2_chunk", fs2_chunk(cuda_kernels.fused_fs2_planes_multi, sk), 5),
        ("plain_chunk", chunk(cuda_kernels.fused_update_planes_multi_ref, sp), 2),
        ("plain_fs2_chunk", fs2_chunk(cuda_kernels.fused_fs2_planes_multi_ref, sp), 2),
    ):
        t[name] = time_ms(fn, reps)
    times = {
        "fused_update_planes": (t["tick"], t["plain_tick"]),
        "fused_update_planes_multi": (t["chunk"] / C, t["plain_chunk"] / C),
        "fused_fs2_planes": (t["fs2_tick"], t["plain_fs2_tick"]),
        "fused_fs2_planes_multi": (t["fs2_chunk"] / C, t["plain_fs2_chunk"] / C),
    }
    for name, (k, pl) in times.items():
        phase(9, f"{name}: kernel {k:.4f} ms/tick, plain {pl:.4f} ms/tick "
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
    from fastslam_tpu_torch.drivers.replay import record_log
    from fastslam_tpu_torch.drivers.sim_world import SimWorld

    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    report = _build.library_path().with_suffix(".log")
    regs = (ptxas_summary(report.read_text()) if report.exists()
            else ["(cached build, no ptxas report)"])
    phase(1, f"built {', '.join(p.name for p in _build.sources())} in {build_s:.1f} s")
    for line in regs:
        phase(1, f"ptxas: {line}")

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    ms = pad_measurements(FastSLAMConfig(max_measurements=M), MEASUREMENTS, DEVICE)
    errs = {"fused_update_planes": phase2(gen, ms),
            "fused_update_planes_multi": phase3(gen, ms)}
    log = record_log(SimWorld(seed=3), num_ticks=300)
    launches = phase4(log)
    errs["fused_fs2_planes"] = phase5(gen, ms)
    errs["fused_fs2_planes_multi"] = phase6(gen, ms)
    fs2_launches, _ = replay_main_path(7, log, config(proposal_mode="fastslam2"), FS2, 0.15)
    launches.update({k: fs2_launches[k] for k in FS2})
    phase8()
    times = phase9(gen, ms)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, replaces) in KERNELS.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
