"""The manifest against the benchmark's contract, and every file a cell
names found by name."""

import re

import pytest

from benchmark.harness import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = core.manifest()


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert len((core.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51


def test_names_and_units():
    names = [c["name"] for c in MAN["configs"]] + [w["name"] for w in MAN["workloads"]]
    names += [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += [w["traffic"] for w in MAN["workloads"]]
    names += [k for c in MAN["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    metric_names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_entries_have_exactly_the_contracts_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(cell):
    entry = core.cell_entry(MAN, cell)
    params = core.workload(cell)
    assert params["kind"] == entry["traffic"]
    driver = core.module("traffic", params["kind"])
    for fn in ("setup", "window", "close", "check"):
        assert callable(getattr(driver, fn))
    cfg = next(c for c in MAN["configs"] if c["name"] == entry["config"])
    assert (core.ROOT / cfg["file"]).exists()
    assert core.config(entry["config"])["name"] == entry["config"]
    ends = core.metrics_of(MAN, cell, False)
    layers = core.metrics_of(MAN, cell, True)
    assert "setup_s" in [m["name"] for m in ends] and len(ends) >= 2 and layers
    for m in ends + layers:
        assert callable(core.module("metrics", m["name"]).read)
    # a per-layer metric moves an end-to-end metric this cell reports
    for m in layers:
        assert m["moves"] in [e["name"] for e in ends]


def test_every_config_used_and_run_seconds_fit_24_cells():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200

