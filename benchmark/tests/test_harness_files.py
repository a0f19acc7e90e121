"""Every cell, configuration, traffic mix, limit and metric of
BENCHMARK.json resolves to its files by name, within the contract's
shapes."""

import json
import re

import pytest

from benchmark import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == c.spec["config"]
    assert (harness.HERE / "drivers" / f"{c.traffic['driver']}.py").exists()
    assert c.chips == 1
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    assert "apart_tolerance" in c.limits and "particles_apart" in c.limits
    assert harness.window_seconds(c, 10.0, False) == 10.0
    assert 0 < harness.window_seconds(c, 10.0, True) <= 10.0


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found(metric):
    assert callable(harness.metric_reader(metric))
    assert harness.metric_reader(metric)({}) is None


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in metrics + BENCH["configs"] + BENCH["workloads"]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert all(0 < m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_cells_report_what_it_moves(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    for cell in m.get("workloads", CELLS):
        assert m["moves"] in {e["name"] for e in harness.load_cell(cell).end_to_end}


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    path = harness.ROOT / conf["file"]
    assert path.is_relative_to(harness.HERE)
    data = json.loads(path.read_text())
    assert data["reduced"] == conf["reduced"] and data["source"] == conf["source"]
    assert len(conf["source"]) <= 200 and data["guarantees"]
