"""``BENCHMARK.json`` against the contract's shape, and every name found."""

import json
import os
import re

import pytest

from bench_port.harness.manifest import Manifest

from .tiny_root import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"), entry["name"]))
    assert len(set(names)) == len(names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(bench["workloads"])
    assert bench["paths"] == ["bench_port"] and bench["command"] == ["python3", "bench_port/run.py"]


def test_bounds_and_metrics(bench):
    names = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in names
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in names
        assert set(m["workloads"]) <= cells
        e2e = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(e2e.get("workloads", cells))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  json.load(open(os.path.join(REPO, "BENCHMARK.json")))
                                  ["workloads"]])
def test_cell_files_found_by_name(cell):
    manifest = Manifest(REPO)
    spec = manifest.cell(cell)
    assert spec["config"]["name"] == spec["entry"]["config"]
    assert spec["traffic"]["kind"] in ("chat", "ingest")
    assert "limits" in spec["cell"] and spec["cell"]["limits"]["faults"] == 0
    for trace in (False, True):
        for m in manifest.metrics(cell, trace):
            if trace:
                assert callable(manifest.reader(m["name"]))
    assert len(manifest.metrics(cell, False)) >= 2 and manifest.metrics(cell, True)


def test_every_file_is_used():
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    metrics = {m["name"] for m in bench["per_layer"]}
    assert {f[:-3] for f in os.listdir(os.path.join(BENCH, "metrics"))} == metrics
    cells = {w["name"] for w in bench["workloads"]}
    assert {f[:-5] for f in os.listdir(os.path.join(BENCH, "workloads"))} == cells
    assert {f[:-5] for f in os.listdir(os.path.join(BENCH, "traffic"))} == \
        {w["traffic"] for w in bench["workloads"]}
