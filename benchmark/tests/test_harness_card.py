"""On the card: one short run of each cell from the command line, correct,
with the metrics the contract asks for.  Marked ``cuda``; skips without a
card:

    python3 -m pytest -m cuda benchmark/tests/test_harness_card.py
"""

import json
import subprocess
import sys

import pytest

from benchmark import harness
from harness_fixtures import card  # noqa: F401

pytestmark = pytest.mark.cuda
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_card(cell, trace, card):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                          "--seed", "4294967311", "--seconds", "2", "--trace", str(trace)],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert all(0 < m["value"] <= 105 for n, m in line["metrics"].items() if "roofline" in n)
    else:
        assert set(line["metrics"]) == {m["name"] for m in harness.load_cell(cell).end_to_end}
