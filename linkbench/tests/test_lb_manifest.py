"""BENCHMARK.json, and every file it names, parse and keep to the
benchmark's contract; every name and unit uses the allowed characters."""

import json
import re

import pytest

from linkbench.harness import spec

MAN = spec.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert MAN["command"] == ["python3", "linkbench/run.py"]
    assert MAN["paths"] == ["linkbench"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_are_unique_and_allowed():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for e in MAN["configs"] + MAN["workloads"] + METRICS:
        assert NAME.match(e["name"]), e["name"]
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_configs_found_and_used():
    used = {w["config"] for w in MAN["workloads"]}
    files = set()
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("linkbench/configs/") and c["file"] not in files
        files.add(c["file"])
        assert _line(c["source"]) and _line(c["why"])
        cfg = spec.config(c["name"])
        assert cfg["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg
            assert not key.endswith(("_dim", "_rank")) and key not in ("n_fft", "cp_len")


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found(name):
    entry = next(w for w in MAN["workloads"] if w["name"] == name)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1 and _line(entry["why"])
    cell = spec.cell(name)
    assert spec.load_module("engines", cell.traffic["engine"]).Engine
    assert set(cell.checks["limits"]) == {"err_gap_ppm"}
    assert cell.checks["calls"] >= 2 and cell.checks["channels"] >= 256
    e2e = {m["name"] for m in cell.end_to_end}
    assert e2e == {"link_gsps", "batch_ms_p95", "setup_s"}
    assert cell.per_layer


def test_pairs_of_config_and_traffic_appear_once():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_metrics():
    names = {m["name"] for m in MAN["end_to_end"]}
    assert names == {"link_gsps", "batch_ms_p95", "setup_s"}
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_found(metric):
    assert set(metric) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert metric["moves"] == "link_gsps"
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert _line(metric["layer"])
    assert set(metric["workloads"]) <= set(CELLS) and metric["workloads"]
    assert callable(spec.load_module("metrics", metric["name"]).read)
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_one_layer_name_per_layer():
    """Metrics of one layer give the same ``layer``, letter for letter."""
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert {"engine", "torch ops", "kernel B", "kernel C", "kernel G", "kernel H",
            "device"} == layers


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
    with pytest.raises(ValueError):
        spec.check_name("a b")
