"""BENCHMARK.json keeps to the benchmark's contract, and every cell's
configuration, traffic and metric files are found by name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in METRICS]
             + [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    for text in ([c["why"] for c in BENCH["configs"] + BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_just_the_contract_keys():
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in BENCH["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"}
               for w in BENCH["workloads"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_by_name(workload):
    from perfbench.harness import spec

    for trace in (False, True):
        cell = spec.load_cell(workload, trace)
        assert cell.chips in (1, 4)
        for name in cell.metrics:
            assert spec.metric_file(name).exists(), name
        assert "setup_s" in cell.metrics or trace
        assert cell.traced  # device_ms_per_gbase, an end-to-end metric, reads the trace
        assert len(cell.metrics) >= 2 if not trace else len(cell.metrics) >= 1


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(config):
    from perfbench.harness import spec

    data = json.loads((ROOT / config["file"]).read_text())
    assert spec.config_file(config["name"]) == ROOT / config["file"]
    assert data["source"] == config["source"] and data["reduced"] == config["reduced"] == []
    assert data["assumed"] and data["guarantees"]
    assert all(n > 0 for _c, n in data["contigs"])
    assert len({c for c, _n in data["contigs"]}) == len(data["contigs"])


def test_grch38_is_the_primary_assembly_at_its_published_length():
    data = json.loads((ROOT / "perfbench/configs/grch38.json").read_text())
    assert sum(n for _c, n in data["contigs"]) == 3_088_286_401
    assert len(data["contigs"]) == 25
