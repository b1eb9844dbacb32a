"""Name-based lookup of what a cell is made of.

``BENCHMARK.json`` names the cell's configuration and traffic mix; each
is a data file found by that name (``configs/<name>.json``,
``traffic/<name>.json``), and the cell's correctness limit is
``limits/<cell>.json``. Each per-layer metric of ``BENCHMARK.json`` is
the reader ``metrics/<name>.py`` (its ``read(run)``). A new cell, mix,
configuration or metric is a new file and a new entry; nothing here
changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file
    traffic: dict  # the traffic mix file
    limits: dict  # the correctness limits of this cell
    end_to_end: tuple  # BENCHMARK.json entries of this cell's e2e metrics
    per_layer: tuple  # BENCHMARK.json entries of this cell's per-layer metrics


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def config_file(name: str) -> Path:
    return HERE / "configs" / f"{name}.json"


def traffic_file(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def limits_file(cell: str) -> Path:
    return HERE / "limits" / f"{cell}.json"


def metric_file(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; choose from "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    if Path(cfg_entry["file"]) != Path("perfbench/configs") / f"{w['config']}.json":
        raise ValueError(f"config {w['config']!r}: file {cfg_entry['file']!r} is "
                         f"not perfbench/configs/{w['config']}.json")
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(config_file(w["config"])),
        traffic=load_json(traffic_file(w["traffic"])),
        limits=load_json(limits_file(name)),
        end_to_end=tuple(m for m in bench["end_to_end"] if _applies(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _applies(m, name)),
    )


def metric_reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
