"""The ceiling probes and the profiling utilities, on the CPU.

* The probes' plain versions against numpy transcriptions of the TPU
  kernels' bodies (``scripts/bench_hbm_floor.py:40-43``,
  ``scripts/bench_vpu_roofline.py:63-84``): the copy and ``mul_add`` exactly
  (float32, the same operations in the same order); ``fma_chain`` within
  rtol 1e-6, against a fused multiply-add emulated in extended precision
  (the plain version rounds each step twice, float64 then float32), and
  within one float32 ulp per step of the script's separate multiply and
  add.
* The wrappers refuse a wrong dtype, shape or count, and on the kernel path
  a non-contiguous tensor (meta tensors stand in for a card).
* Both probe commands with ``--device cpu`` print the scripts' keys.
"""

import json
import os

import numpy as np
import pytest
import torch

from fastslam_tpu_torch.core import cuda_kernels
from fastslam_tpu_torch.probes import hbm_floor, vpu_roofline
from fastslam_tpu_torch.utils import profiling

torch.set_num_threads(1)


def planes(seed, l, p, n):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(l, p)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("l,p", [(4, 37), (8, 1000)])
def test_copy_plain_matches_the_tpu_kernel_body(l, p):
    bufs = planes(0, l, p, 6) + planes(1, 1, p, 1)
    got = cuda_kernels.hbm_copy([torch.from_numpy(b) for b in bufs])
    assert len(got) == 7
    for g, b in zip(got, bufs):
        np.testing.assert_array_equal(g.numpy(), b + np.float32(1.0))


@pytest.mark.parametrize("passes,tile", [(0, 16), (3, 16), (17, 64)])
def test_mul_add_plain_matches_the_tpu_kernel_body(passes, tile):
    a, b, c = planes(2, 8, 300, 3)
    got = cuda_kernels.mul_add(*(torch.from_numpy(x) for x in (a, b, c)), passes, tile)
    want = c
    for _ in range(passes):
        want = a * b + want * np.float32(0.9999)
    assert want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)


def fma_reference(x, passes):
    """``8 * passes`` steps of fma(x, a, b) with a single rounding per
    step, emulated in extended precision (x * a is exact there)."""
    a, b = np.longdouble(np.float32(1.0000001)), np.longdouble(np.float32(1e-7))
    x = x.copy()
    for _ in range(8 * passes):
        x = (x.astype(np.longdouble) * a + b).astype(np.float32)
    return x


@pytest.mark.parametrize("passes", [1, 2])
def test_fma_chain_plain_matches_the_tpu_kernel_body(passes):
    (x,) = planes(3, 8, 500, 1)
    got = cuda_kernels.fma_chain(torch.from_numpy(x), passes).numpy()
    np.testing.assert_allclose(got, fma_reference(x, passes), rtol=1e-6)
    assert (got != fma_reference(x, passes)).mean() < 1e-3   # double roundings: rare
    # the bench script's body rounds the product too: a float32 multiply,
    # then a float32 add, so it may drift by up to one ulp (2^-23 relative)
    # per step
    want = x.copy()
    for _ in range(8 * passes):
        want = want * np.float32(1.0000001) + np.float32(1e-7)
    np.testing.assert_allclose(got, want, rtol=8 * passes * 2.0 ** -23)


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


L, P = 8, 64
BAD_CALLS = {
    "copy: six buffers": lambda: cuda_kernels.hbm_copy(
        [torch.zeros(L, P) for _ in range(6)]),
    "copy: float64 plane": lambda: cuda_kernels.hbm_copy(
        [torch.zeros(L, P, dtype=torch.float64)] + [torch.zeros(L, P)] * 5
        + [torch.zeros(1, P)]),
    "copy: row of two": lambda: cuda_kernels.hbm_copy(
        [torch.zeros(L, P)] * 6 + [torch.zeros(2, P)]),
    "copy: non-contiguous": lambda: cuda_kernels.hbm_copy(
        [meta(P, L).t()] + [meta(L, P)] * 5 + [meta(1, P)]),
    "mul_add: float64": lambda: cuda_kernels.mul_add(
        torch.zeros(L, P), torch.zeros(L, P, dtype=torch.float64), torch.zeros(L, P)),
    "mul_add: shapes differ": lambda: cuda_kernels.mul_add(
        torch.zeros(L, P), torch.zeros(L, P + 1), torch.zeros(L, P)),
    "mul_add: tile past shared memory": lambda: cuda_kernels.mul_add(
        *(torch.zeros(64, P) for _ in range(3)), passes=1, tile=303),
    "mul_add: negative passes": lambda: cuda_kernels.mul_add(
        *(torch.zeros(L, P) for _ in range(3)), passes=-1),
    "mul_add: non-contiguous": lambda: cuda_kernels.mul_add(
        meta(P, L).t(), meta(L, P), meta(L, P), passes=1, tile=16),
    "fma_chain: float64": lambda: cuda_kernels.fma_chain(
        torch.zeros(L, P, dtype=torch.float64)),
    "fma_chain: one axis": lambda: cuda_kernels.fma_chain(torch.zeros(P)),
    "fma_chain: non-contiguous": lambda: cuda_kernels.fma_chain(meta(P, L).t(), 1),
}


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_probe_wrappers_refuse_bad_inputs(case):
    launches = dict(cuda_kernels.LAUNCHES)
    with pytest.raises(ValueError):
        BAD_CALLS[case]()
    assert cuda_kernels.LAUNCHES == launches


def test_largest_tile_fits_shared_memory():
    # 3 * 64 * 302 * 4 = 231,936 bytes <= 227 KB; 303 columns do not fit
    a = torch.ones(64, 3)
    cuda_kernels.mul_add(a, a, a, passes=1, tile=302)


def run_cli(module, argv, capsys):
    capsys.readouterr()
    assert module.main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_hbm_floor_cli_on_cpu(capsys):
    out = run_cli(hbm_floor, ["--particles", "300", "--landmarks", "4", "--k", "2",
                              "--device", "cpu"], capsys)
    assert {"copy_ms", "gbps", "tile"} <= set(out)
    assert out["device"] == "cpu" and out["power_limit_w"] is None
    assert out["geometry"] == {"L": 4, "P": 300, "k": 2}
    assert out["copy_ms"] > 0 and out["gbps"] > 0
    assert out["gbps"] == pytest.approx(hbm_floor.copy_bytes(300, 4) / out["copy_ms"] / 1e6)


def test_vpu_roofline_cli_on_cpu(capsys):
    out = run_cli(vpu_roofline, ["--particles", "200", "--landmarks", "4", "--passes", "2",
                                 "--tile", "16", "--k", "2", "--device", "cpu"], capsys)
    assert {"geometry", "mul_add_pass_us", "mul_add_elements_per_s", "fma_ops_per_s_G",
            "per_LT_pass_us_at_P", "note"} <= set(out)
    assert out["geometry"] == {"L": 4, "P": 200, "tile": 16, "passes": 2, "k": 2}
    assert out["device"] == "cpu" and out["power_limit_w"] is None
    assert out["mul_add_pass_us"] == pytest.approx(out["mul_add_ms"] * 1e3 / 2)
    assert out["per_LT_pass_us_at_P"] == pytest.approx(out["mul_add_pass_us"])


def test_probe_cli_refuses_the_card_it_does_not_have():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        hbm_floor.main(["--particles", "64", "--landmarks", "2", "--k", "1"])


def test_phase_timer_counts_and_reports():
    timer = profiling.PhaseTimer()
    for _ in range(3):
        with timer.phase("filter", torch.zeros(2)):
            pass
    with timer.phase("frontend"):
        pass
    summary = timer.summary()
    assert summary["filter"]["count"] == 3 and summary["frontend"]["count"] == 1
    assert "filter" in timer.report()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)) as prof:
        with profiling.annotate("probe region"):
            cuda_kernels.hbm_copy([torch.zeros(2, 8)] * 6 + [torch.zeros(1, 8)])
    assert any("probe region" in e.key for e in prof.key_averages())
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "probe region" for e in trace["traceEvents"])
    assert os.path.getsize(tmp_path / "trace.json") > 0


def test_elapsed_ms_on_the_host_clock():
    assert profiling.elapsed_ms(lambda: sum(range(1000)), "cpu") > 0.0
