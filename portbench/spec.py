"""The benchmark's definition, found by name: BENCHMARK.json at the root
of the checkout names the cells; each cell's configuration, traffic mix
and metric readers are files of their own under portbench/, so a new
cell, mix or metric is a new file and a new entry, never an edit."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            with open(root / entry["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, here: Path = HERE) -> dict:
    with open(here / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics(bench: dict, cell: str, traced: bool) -> list:
    """The cell's metrics in a run: its end-to-end metrics untraced, its
    per-layer ones traced; a metric with a `workloads` key only in the
    cells it lists."""
    kind = "per_layer" if traced else "end_to_end"
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def reader(name: str, here: Path = HERE):
    """The `read(record)` function of portbench/metrics/<name>.py."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(bench: dict, cell: str, traced: bool, record: dict, here: Path = HERE) -> dict:
    """{name: {"value", "unit"}} of the metrics whose readers found
    something to read; a reader that returns None leaves its metric out."""
    out = {}
    for m in metrics(bench, cell, traced):
        value = reader(m["name"], here)(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
