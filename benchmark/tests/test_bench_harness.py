"""The harness finds a configuration, a traffic mix and a per-layer metric
added as new files alone, by the names BENCHMARK.json gives them; a tiny
cell of them runs end to end on the CPU and is correct."""

import json

import numpy as np
import torch

import harness
import run
import traffic
from conftest import TINY_CASES, real_limits, tiny_config, write_root

THROWAWAY = '''
def read(ctx):
    if ctx.get("kind") != "cases":
        return None
    return float(ctx["slots"])
'''


def test_new_files_are_found_by_name(tmp_path):
    cfg = tiny_config(name="throwaway_cfg", patch=64)
    mix = dict(TINY_CASES, cycle=[[64, 64], [80, 96]])
    root = write_root(tmp_path, cfg, {"throwaway_mix": mix}, {"x.predict": "throwaway_mix"},
                      {"x.predict": real_limits("b.predict")},
                      {"throwaway.slots": THROWAWAY})
    cell = harness.Cell(root, "x.predict")
    assert cell.cfg["name"] == "throwaway_cfg" and cell.mix["cycle"] == [[64, 64], [80, 96]]
    assert cell.limits == real_limits("b.predict")
    names = [m["name"] for m in cell.per_layer()]
    assert "throwaway.slots" in names and "predict.useful_tile_pct" in names
    assert "train.batch_wait_ms" not in names
    assert [m["name"] for m in cell.end_to_end()] == ["predict.mpx_per_s",
                                                      "predict.case_p90_s", "setup_s"]
    assert cell.reader("throwaway.slots")({"kind": "cases", "slots": 24}) == 24.0
    assert cell.reader("throwaway.slots")({"kind": "train"}) is None


def test_tiny_cell_runs_on_the_cpu(tiny_root):
    cell = harness.Cell(tiny_root, "t.predict")
    harness.program_env(tiny_root, cell.cfg)
    out = run.run_cell(cell, 2**31 + 17, 0.5, False, torch.device("cpu"))
    line = json.loads(out["line"]({"platform": "cpu", "kind": "cpu", "count": 1}))
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"setup_s", "predict.mpx_per_s", "predict.case_p90_s"}
    assert list(line)[-1] == "checks"


def test_cases_are_the_cycle_and_the_seed_draws_pixels():
    mix = dict(TINY_CASES)
    a, b, c = (traffic.cases(mix, s, 1) for s in (1, 1, 2))
    assert [x.shape for x in a] == [(1, 1, h, w) for h, w in mix["cycle"]]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert [x.shape for x in c] == [x.shape for x in a]
    assert not np.array_equal(a[0], c[0])


def test_tiles_follow_the_sliding_window():
    # nnU-Net pads to the patch and to a multiple of half of it, steps by half
    assert traffic.tiles_of((512, 512), (512, 512), 0.5) == 1
    assert traffic.tiles_of((384, 448), (512, 512), 0.5) == 1
    assert traffic.tiles_of((640, 576), (512, 512), 0.5) == 4
    assert traffic.tiles_of((1024, 1024), (512, 512), 0.5) == 9


def test_trace_reduction(tmp_path):
    events = [{"ph": "X", "cat": "kernel", "name": "nvjet_gemm", "ts": 0, "dur": 10},
              {"ph": "X", "cat": "kernel", "name": "elementwise_kernel<add>", "ts": 5, "dur": 10},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 40, "dur": 5},
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 100}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = harness.reduce_trace(str(path), window_s=100e-6)
    assert out["busy_s"] == 20e-6
    assert out["idle_gaps"] == [["elementwise -> copies", 25e-6]]
    assert harness.family_seconds(out["kernels"]) == {"cuBLAS GEMM": 10e-6,
                                                      "elementwise": 10e-6,
                                                      "copies": 5e-6}
    assert harness.quantile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 0.9) == 9.1
