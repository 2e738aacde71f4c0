"""BENCHMARK.json against the contract's form, every name resolving to its
file, and a cell, a traffic mix, a kind and a per-layer metric added as new
files in a copy being found with no edit."""
from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def test_manifest_keys_and_names(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "benchmark/run.py"]
    assert man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


def test_every_name_resolves(man):
    for w in man["workloads"]:
        cell = harness.Cell(w["name"], man)
        assert os.path.isfile(cell.kind_path)
        assert cell.kind().run
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
            assert callable(cell.reader(m["name"]).read)
        assert cell.limits
    for c in man["configs"]:
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_added_files_are_found(tmp_path, man):
    """A throwaway cell on a new mix, kind, limits and metric, added as new
    files in a copy of the benchmark, runs through the harness's lookup with
    no file edited but BENCHMARK.json's entries."""
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    (bench / "traffic" / "toy_mix.json").write_text(
        json.dumps({"kind": "toy", "n": 3}))
    (bench / "kinds" / "toy.py").write_text(
        "def run(cell, args, device, start_wall):\n"
        "    return {'n': cell.traffic['n']}\n")
    (bench / "limits" / "toy.cell.json").write_text('{"x": 1}')
    (bench / "metrics" / "toy.metric.py").write_text(
        "def read(ctx):\n    return ctx['v'] * 2\n")
    man = json.loads(json.dumps(man))
    man["workloads"].append({"name": "toy.cell", "config":
                             man["configs"][0]["name"], "traffic": "toy_mix",
                             "chips": 1, "why": "a test"})
    man["end_to_end"].append({"name": "toy_rate", "unit": "x/s",
                              "better": "higher", "bound": 0.05,
                              "source": "host_clock",
                              "workloads": ["toy.cell"]})
    man["per_layer"].append({"name": "toy.metric", "unit": "%",
                             "better": "higher", "source": "device_trace",
                             "layer": "kernels", "moves": "toy_rate",
                             "workloads": ["toy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    cell = harness.Cell("toy.cell", harness.manifest(str(root)),
                        bench=str(bench), root=str(root))
    assert cell.kind().run(cell, None, None, 0) == {"n": 3}
    assert sorted(m["name"] for m in cell.end_to_end) == ["setup_s",
                                                          "toy_rate"]
    assert [m["name"] for m in cell.per_layer] == ["toy.metric"]
    assert cell.reader("toy.metric").read({"v": 21}) == 42
    assert cell.limits == {"x": 1}
