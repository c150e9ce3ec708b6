"""BENCHMARK.json and the files it names: each configuration, cell, traffic
mix and metric loads by its name, and every per-layer metric moves an
end-to-end metric that each cell reporting it reports."""

import json
import os
import re

import pytest

from stark_bench import run

BENCH = run.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["stark_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(run.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"prove_s", "peak_gib", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25, m


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c = run.Cell.load(cell, BENCH)
    assert c.entry["chips"] == 1
    assert c.config["name"] == c.entry["config"]
    entry = next(e for e in BENCH["configs"] if e["name"] == c.entry["config"])
    assert entry["file"] == f"stark_bench/configs/{entry['name']}.json"
    assert entry["reduced"] == c.config["reduced"] and entry["source"] == c.config["source"]
    assert set(c.params) >= {"warmup_jobs", "check_jobs", "profile_jobs"}
    assert c.metric_names(False, BENCH) == ["prove_s", "peak_gib", "setup_s"]
    assert c.metric_names(True, BENCH), "a cell reports at least one per-layer metric"


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["end_to_end"]] + PER_LAYER)
def test_metric_reader_loads(name):
    entry = next(m for m in BENCH["end_to_end"] + BENCH["per_layer"] if m["name"] == name)
    reader = run.load_metric(name)
    assert reader.UNIT == entry["unit"]
    if "layer" in entry:
        assert (reader.LAYER, reader.MOVES) == (entry["layer"], entry["moves"])


@pytest.mark.parametrize("name", PER_LAYER)
def test_per_layer_moves_what_its_cells_report(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    reporting = [c for c in CELLS if name in run.Cell.load(c, BENCH).metric_names(True, BENCH)]
    assert reporting
    for c in reporting:
        assert entry["moves"] in run.Cell.load(c, BENCH).metric_names(False, BENCH), (name, c)


def test_every_file_is_named_from_name_characters():
    for base, _dirs, files in os.walk(os.path.join(run.ROOT, "stark_bench")):
        if "__pycache__" in base:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), run.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_config_files_are_json_objects():
    for e in BENCH["configs"]:
        with open(os.path.join(run.ROOT, e["file"])) as f:
            assert isinstance(json.load(f), dict)
