"""The collective tally (``parallel/collectives.py:tally``) and
``probes.collective_bytes`` against ``scripts/collective_bytes.py``.

The script, run in a subprocess at ``--devices 8 --per-device 256``, sums
the result bytes of every collective in the compiled HLO of the sharded
blocks step.  The port's tally of the same step on 8 CPU shards holds the
bulk ops that carry the landmark arrays equal in size to the script's: the
1.0 and 2.0 MB all-gathers of the means and covariances in the whole-state
branch, and the halo's 0.125 / 0.125 / 0.25 / 0.25 MB shifts.

Ops the two count differently, and which are not compared: the port
gathers the ``[P]`` weights (and the poses for the argmax) to keep its
float reductions bit for bit, where XLA reduces within each device and
all-reduces scalars (so the scalar ops and their bytes differ); the halo
resampler shifts the weights too, which XLA drops in production; the port
records the gathered state's re-split (``split``), which XLA slices
locally; and the script's halo module also holds the fallback branch's
whole-state gather, which a run on healthy weights does not take.
"""

import json
import os
import subprocess
import sys
from collections import Counter

import pytest
import torch

from fastslam_tpu_torch.parallel import collectives
from fastslam_tpu_torch.probes import collective_bytes

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, PER, L = 8, 256, 64


@pytest.fixture(scope="module")
def both():
    script = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "collective_bytes.py"),
         "--devices", str(S), "--per-device", str(PER)],
        cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True, text=True,
        timeout=600, check=True)
    return json.loads(script.stdout), collective_bytes.run("cpu", S, PER, L)


def mbytes(rec, op):
    return Counter(o["mbytes"] for o in rec["bulk_ops"] if o["op"] == op)


def test_whole_state_gather_carries_the_scripts_landmark_gathers(both):
    want, got = both
    assert got["devices"] == want["devices"] and got["particles"] == want["particles"]
    script, port = mbytes(want["gspmd_resample"], "all-gather"), \
        mbytes(got["gspmd_resample"], "all_gather")
    for size in (1.0, 2.0):          # lm_mean [P, L, 2], lm_cov [P, L, 4] float32
        assert script[size] == port[size] == 1, size
    branch = got["gspmd_resample"]["branches"]["resample"]
    assert Counter(o["mbytes"] for o in branch["bulk_ops"] if o["op"] == "all_gather")[2.0] == 1
    assert got["gspmd_resample"]["whole_state_bytes"] == S * PER * (3 + 1 + 6 * L + 1) * 4


def test_halo_shifts_equal_the_scripts(both):
    want, got = both
    script = mbytes(want["halo_resample"], "collective-permute")
    port = mbytes(got["halo_resample"], "ppermute")
    for size in (0.125, 0.25):       # a shard's lm_mean / lm_cov, to each neighbour
        assert script[size] == port[size] == 2, size
    assert got["halo_resample"]["whole_state_bytes"] == 0


def test_ring_and_branches(both):
    _, got = both
    ring = got["ring_resample"]
    block = PER * (3 + 1 + 6 * L + 1) * 4
    shifts = [o for o in ring["branches"]["resample"]["bulk_ops"] if o["op"] == "ppermute"]
    assert [o["mbytes"] for o in shifts] == [round(block / 2**20, 3)] * 2
    assert ring["by_site"]["ring"] >= 2 * block
    for name in collective_bytes.RESAMPLERS:
        r = got[name]
        quiet, res = r["branches"]["no_resample"], r["branches"]["resample"]
        assert r["collective_ops"] == quiet["collective_ops"] + res["collective_ops"]
        assert r["scalar_bytes"] == quiet["scalar_bytes"] + res["scalar_bytes"]
        assert r["bulk_bytes_total_mb"] == pytest.approx(
            quiet["bulk_bytes_total_mb"] + res["bulk_bytes_total_mb"], abs=2e-3)
        # the tick without a resample: the weights' gathers and the argmax pose
        assert set(r["by_site"]) - {"step"} <= {"whole_state", "halo", "ring"}
    assert got["device"] == "cpu"


def test_tally_records_each_collective():
    t = [torch.arange(6, dtype=torch.float32).reshape(3, 2) for _ in range(4)]
    devices = [torch.device("cpu")] * 4
    with collectives.tally() as ops:
        collectives.all_gather(t)
        with collectives.site("halo"):
            collectives.ppermute(t, 1, devices)
        collectives.psum([torch.tensor(1, dtype=torch.int32)] * 4)
        collectives.psum([torch.ones(5)] * 4)
        with collectives.tally() as inner:
            collectives.all_gather(t, dim=1)
    assert ops == [{"op": "all_gather", "bytes": 4 * 24, "site": None},
                   {"op": "ppermute", "bytes": 24, "site": "halo"},
                   {"op": "psum", "bytes": 8, "site": None},
                   {"op": "psum", "bytes": 20, "site": None},
                   {"op": "all_gather", "bytes": 4 * 24, "site": None}]
    assert inner == ops[-1:]
    collectives.all_gather(t)            # no tally open: nothing recorded
    assert len(ops) == 5


def test_summarize_splits_scalar_and_bulk():
    ops = [{"op": "psum", "bytes": 8, "site": None},
           {"op": "all_gather", "bytes": 256, "site": None},
           {"op": "all_gather", "bytes": 2**20, "site": "whole_state"}]
    s = collective_bytes.summarize(ops)
    assert s == {"collective_ops": 3, "scalar_ops": 2, "scalar_bytes": 264,
                 "bulk_ops": [{"op": "all_gather", "mbytes": 1.0}],
                 "bulk_bytes_total_mb": 1.0}
    assert collective_bytes.whole_state_bytes(ops) == 2**20
    assert collective_bytes.by_site(ops) == {"step": 264, "whole_state": 2**20}
