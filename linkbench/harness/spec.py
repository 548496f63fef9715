"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout's root lists the configurations,
cells and metrics. Each configuration is ``linkbench/configs/<name>.json``
(the link's numerology and its source), each traffic mix
``linkbench/traffic/<name>.json`` (the engine, its options, the channel
and the load), each cell's correctness check
``linkbench/checks/<cell>.json`` (the sample and the limits), each engine
``linkbench/engines/<engine>.py`` and each per-layer metric
``linkbench/metrics/<name>.py``. A new cell or metric is new files and a
new entry; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # linkbench/
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{check_name(name)}.json") as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def checks(cell_name: str) -> dict:
    return _json("checks", cell_name)


def load_module(kind: str, name: str):
    """``linkbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{check_name(name)}.py"
    spec = importlib.util.spec_from_file_location(f"linkbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One cell as it runs: its name, its configuration, traffic and
    check files' contents, and the manifest's metrics that it reports."""

    name: str
    config: dict
    traffic: dict
    checks: dict
    chips: int
    end_to_end: list
    per_layer: list


def cell(name: str, root: Path = ROOT) -> Cell:
    man = manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell named {name!r} in BENCHMARK.json")

    def reports(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return Cell(name=name, config=config(entry["config"]), traffic=traffic(entry["traffic"]),
                checks=checks(name), chips=int(entry["chips"]),
                end_to_end=[m for m in man["end_to_end"] if reports(m)],
                per_layer=[m for m in man["per_layer"] if reports(m)])
