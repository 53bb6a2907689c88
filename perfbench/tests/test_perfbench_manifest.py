"""BENCHMARK.json against the shapes its reader accepts, and every name it gives
against the files the harness finds by it."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer", "moves", "workloads"}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "perfbench/run.py"]
    assert M["paths"] == ["perfbench"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in M[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads"):
        assert len({x["name"] for x in M[key]}) == len(M[key])
    metrics = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= METRIC_KEYS


def test_configs():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["why"]) and one_line(c["source"])
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert (BENCH / "reference" / f"{c['name']}.py").is_file()
        assert any(w["config"] == c["name"] for w in M["workloads"])


def test_workloads():
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and one_line(w["why"])
        assert NAME.match(w["traffic"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
        assert json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
    assert [w["name"] for w in M["workloads"]] == ["r2l_serve", "r2l_distill", "teacher_train",
                                                   "r2l_serve_int8"]


def test_end_to_end():
    names = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in names and len(M["end_to_end"]) <= 16
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (BENCH / "endtoend" / f"{m['name']}.py").is_file()


def test_per_layer():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        assert one_line(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        moved = e2e[m["moves"]].get("workloads", sorted(cells))
        assert set(m["workloads"]) <= set(moved) & cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", ["r2l_serve", "r2l_distill", "teacher_train",
                                  "r2l_serve_int8"])
def test_every_cell_reports_enough(cell):
    e2e = [m for m in M["end_to_end"] if cell in m.get("workloads", [cell])]
    per_layer = [m for m in M["per_layer"] if cell in m.get("workloads", [cell])]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per_layer
    assert any("mfu" in m["name"] for m in per_layer)


def test_run_seconds_fit_the_check():
    # 2 + 14 x 24 runs of run_seconds + 60 s, 24 cells' compile allowance,
    # 1200 s spare, within 43200 s
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
