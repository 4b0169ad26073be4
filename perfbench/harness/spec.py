"""The cells as data: ``BENCHMARK.json`` at the checkout's root names each
cell's configuration, traffic and metrics; each is a file of its own under
``perfbench/`` found by that name, so a new cell, configuration, traffic mix
or metric is a new file and an entry, and edits none."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # perfbench/
ROOT = HERE.parent


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict  # perfbench/configs/<config>.json
    traffic: dict  # perfbench/traffic/<traffic>.json
    metrics: dict  # {name: unit} this run reports
    traced: bool  # the run takes a device trace of its window


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def config_file(name: str) -> Path:
    return HERE / "configs" / f"{name}.json"


def traffic_file(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def metric_file(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def cell_metrics(bench: dict, workload: str, trace: bool) -> dict:
    """``{metric: unit}`` of the cell: its end-to-end metrics without a
    trace, its per-layer metrics with one (a metric with ``workloads`` only
    in those cells)."""
    group = bench["per_layer" if trace else "end_to_end"]
    return {m["name"]: m["unit"] for m in group
            if workload in m.get("workloads", [workload])}


def load_cell(workload: str, trace: bool, root: Path = ROOT) -> Cell:
    """The cell; its run is traced with ``--trace 1``, and without it where
    one of its end-to-end metrics is read from the device trace."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    metrics = cell_metrics(bench, workload, trace)
    return Cell(
        name=workload, chips=w["chips"],
        config=json.loads(config_file(w["config"]).read_text()),
        traffic=json.loads(traffic_file(w["traffic"]).read_text()),
        metrics=metrics,
        traced=trace or any(m["source"] == "device_trace" for m in bench["end_to_end"]
                            if m["name"] in metrics),
    )


def metric_reader(name: str):
    """The ``read(window)`` of ``perfbench/metrics/<name>.py``."""
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
