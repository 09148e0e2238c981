"""``BENCHMARK.json`` against the contract's form: names, units and
lengths in the allowed characters, every piece found by name, bounds in
range, and a run budget that fits 24 cells."""

import json
import re

import pytest

from benchmark.manifest import ROOT, Cell, load_manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = load_manifest()
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51 and \
        isinstance(MAN["run_seconds"], int)
    cells, rs = 24, MAN["run_seconds"]
    assert (2 + 14 * cells) * (rs + 60) + cells * 180 + 1200 <= 43200


def test_command_and_paths():
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert len(MAN["command"]) <= 32 and all(line(w) for w in MAN["command"])
    files = [w for w in MAN["command"] if (ROOT / w).exists()]
    assert files and all(any(f.startswith(p + "/") for p in MAN["paths"])
                         for f in files)


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_config(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and line(conf["source"]) \
        and line(conf["why"])
    assert conf["file"].startswith("benchmark/configs/")
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"] and data["reduced"] == \
        conf["reduced"] == []
    assert "assumed" in data and line(data["source"])
    assert any(w["config"] == conf["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_workload(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and line(w["why"])
    cell = Cell(w["name"])
    assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
    assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").exists()
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_pairs_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    for key in ("configs", "workloads"):
        names = [x["name"] for x in MAN[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_metrics():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and line(m["layer"])
        assert m["source"] in SOURCES
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in {"lower", "higher"}
        assert set(m.get("workloads", cells)) <= cells


def test_files_under_paths_are_named_from_name_characters():
    for f in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in f.parts or not f.is_file():
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
