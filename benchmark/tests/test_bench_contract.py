"""BENCHMARK.json and the result line against the benchmark's contract:
names, units, bounds, every file a name points at, and the last line's
schema with the compared numbers last."""

import json
import re

import harness
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys_and_limits():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert s["command"] == ["python3", "benchmark/run.py"] and s["paths"] == ["benchmark"]
    assert 1 <= s["run_seconds"] <= 51
    assert len(json.dumps(s)) <= 64 * 1024
    cells = len(s["workloads"])
    assert 2 + 14 * 24 * 0 <= 43200  # keeps the arithmetic below honest
    full = 24 * (14 * (s["run_seconds"] + 60) + 180) + 2 * (s["run_seconds"] + 60) + 1200
    assert full <= 43200 and cells <= 24


def test_names_units_and_files():
    s = spec()
    names = [x["name"] for x in s["configs"] + s["workloads"] + s["end_to_end"]
             + s["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len({x["name"] for x in s["end_to_end"] + s["per_layer"]}) == len(
        s["end_to_end"]) + len(s["per_layer"])
    configs = {c["name"]: c for c in s["configs"]}
    for c in s["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        with open(ROOT / c["file"]) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
    used = set()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "checks" / f"{w['name']}.json").is_file()
        used.add(w["config"])
    assert used == set(configs)
    for m in s["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in s["end_to_end"])
    e2e = {m["name"]: m for m in s["end_to_end"]}
    for m in s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        for w in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    s = spec()
    for w in s["workloads"]:
        cell = harness.Cell(ROOT, w["name"])
        e2e = [m["name"] for m in cell.end_to_end()]
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer()


def test_result_line_schema():
    line = harness.result_line(True, 10, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
                               {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                                "count": 1, "memory_peak_bytes": 123},
                               {"logits_rel_l2": (0.01, 0.1)},
                               {"device_ops": [["k", 0.1]], "idle_gaps": [["a -> b", 0.01]]})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert out["checks"] == {"logits_rel_l2": {"value": 0.01, "limit": 0.1}}
    assert out["metrics"]["setup_s"] == {"value": 1.5, "unit": "s"}
