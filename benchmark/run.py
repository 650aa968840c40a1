"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the chips the cell asks for.
With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy time and a breakdown.
A run exits with another code than 0 and prints no result when there is no
CUDA device, too few of them, when the program is missing, or when JAX or the
JAX package has been loaded. The numbers that decide ``correct`` are printed
beside their limits as the last lines on standard error and, under
``checks``, last in the result line.
"""

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]  # the harness, then the program beside it

import harness  # noqa: E402


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = harness.Cell(ROOT, args.workload)
    harness.program_env(ROOT, cell.cfg)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev)
    bad = harness.forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: the benchmark measures the PyTorch port alone")
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell.chips, **out["device"]}
    print(out["line"](device), flush=True)
    return 0


def run_cell(cell, seed: int, seconds: float, trace: bool, dev) -> dict:
    """Run the cell on `dev`; returns the pieces of its result line (the
    line itself as a function of the device dict)."""
    kind = cell.mix["kind"]
    if kind == "cases":
        import kind_cases as driver
    elif kind == "train":
        import kind_train as driver
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    res = driver.run(cell, seed, seconds, trace, dev, T0, log)
    if trace:
        metrics = {}
        for m in cell.per_layer():
            value = cell.reader(m["name"])(res["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end()}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in res["metrics"].items()
                   if k in units}
    checks = res["checks"]
    correct = res["failed"] == 0 and all(v <= lim for v, lim in checks.values())
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v!r} limit {lim!r}")

    def line(device):
        return harness.result_line(correct, res["attempted"], res["failed"], metrics, device,
                                   checks, res["breakdown"] if trace else None)

    return {"line": line, "device": res["device"], "correct": correct, "checks": checks,
            "metrics": metrics, "res": res}


if __name__ == "__main__":
    sys.exit(main())
