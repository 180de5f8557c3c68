"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, the files each entry names, and what every cell reports."""
import json
import os
import re

import pytest

from perfbench.harness import cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ROOT = cell.ROOT


@pytest.fixture(scope="module")
def bench():
    return cell.manifest()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert bench["command"][1] == "perfbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_and_units(bench):
    entries = (bench["configs"] + bench["workloads"] + bench["end_to_end"]
               + bench["per_layer"])
    for entry in entries:
        assert NAME.match(entry["name"]), entry["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(metric["unit"]), metric["unit"]
        assert metric["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_every_cell_finds_its_files_and_reports(bench):
    for w in bench["workloads"]:
        files = cell.cell_files(bench, w["name"])
        names = {m["name"] for m in files["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert files["per_layer"]
        for m in files["per_layer"]:
            assert callable(cell.reader(m["name"]))
            assert m["moves"] in names
        cell.driver_for(files["mix"]["kind"])
        assert files["limits"]


def test_configs_used_and_files_distinct(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]


def test_four_chip_share_and_the_check_fits(bench):
    cells = bench["workloads"]
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    # a full check of 24 cells: 2 + 14 x cells runs of run_seconds + 60 s,
    # 2 x 90 s a cell to compile, 1200 s spare, within 43200 s
    n = 24
    total = ((2 + 14 * n) * (bench["run_seconds"] + 60) + n * 2 * 90
             + 1200)
    assert total <= 43200


def test_the_core_names_no_cell_mix_or_metric(bench):
    """The harness core finds drivers, mixes, readers and limits by name:
    its sources name no configuration, traffic kind or metric (besides the
    contract's setup_s, which it measures itself)."""
    names = {c["name"] for c in bench["configs"]}
    names |= {w["name"] for w in bench["workloads"]}
    names |= {w["traffic"] for w in bench["workloads"]}
    names |= {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    names |= {cell.load_json(cell.BENCH_DIR, "traffic", f"{w['traffic']}"
                             ".json")["kind"] for w in bench["workloads"]}
    names.discard(cell.SETUP)
    for core in ("run.py", "harness/cell.py", "harness/trace.py"):
        with open(os.path.join(cell.BENCH_DIR, core)) as f:
            words = set(re.findall(r"[A-Za-z0-9_.]+", f.read()))
        assert not names & words, (core, names & words)
