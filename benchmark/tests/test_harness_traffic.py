"""The traffic is made from the seed alone: the same seed gives the same
draws and the same checked chunks, another seed other ones."""

import torch

from benchmark.drivers import filter as driver
from harness_fixtures import TINY, tiny_cell  # noqa: F401


def draws(cell, seed):
    fr = driver.FilterRun(cell, seed, "cpu", overrides=TINY)
    fr.fill()
    first = {k: v.clone() for k, v in fr.draws.items()}
    fr.fill()
    return first, fr.draws, fr.samples


def test_same_seed_same_draws(tiny_cell):
    cell = tiny_cell("filter-motion-100k")
    a1, a2, sa = draws(cell, 2**31 + 7)
    b1, b2, sb = draws(cell, 2**31 + 7)
    c1, _, _ = draws(cell, 2**31 + 8)
    for k in a1:
        assert torch.equal(a1[k], b1[k]) and torch.equal(a2[k], b2[k])
        assert not torch.equal(a1[k], a2[k])
    assert sa == sb
    assert not torch.equal(a1["rot"], c1["rot"])


def test_u0_inside_its_interval(tiny_cell):
    _, d, _ = draws(tiny_cell("filter-fs2-100k"), 5)
    assert float(d["u0"].min()) >= 0.0 and float(d["u0"].max()) < 1.0 / TINY["num_particles"]
    assert "rot" not in d and d["noise"].shape[-2:] == (3, TINY["num_particles"])


def test_sampled_chunks_one_per_bucket():
    s = driver.sample_chunks(123456789012, [0, 16, 128, 1024, 8192])
    assert [0 <= s[0] < 16, 16 <= s[1] < 128, 128 <= s[2] < 1024, 1024 <= s[3] < 8192] == [True] * 4
    assert s == driver.sample_chunks(123456789012, [0, 16, 128, 1024, 8192])


def test_measurement_rows_are_bench_set(tiny_cell):
    rows = driver.measurement_rows(tiny_cell("filter-motion-100k").traffic)
    assert rows.shape == (16, 2)
    assert abs(rows[3, 0] - 2.9) < 1e-6 and abs(rows[3, 1] + 1.45) < 1e-6
