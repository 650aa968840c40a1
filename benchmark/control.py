"""Readings that set a cell's correctness limits: the program's numbers, and
those of the control and of the faults the cell can have, on given seeds.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

prints one JSON line a seed. What each reading puts in the program's place:

- ``program``: the program as the configuration states it (the lower
  reading);
- ``program_int8`` (the control): the program with its own int8 serving
  mode on (``DINOUNET_TPU_VIT_INT8=1``: the backbone's projections in w8a8),
  the step below the bfloat16 the configuration states;
- ``half_variants`` (cases): the reference's mean over half of the mirror
  variants;
- ``half_batch`` (train): the reference's steps over the first half of the
  batch;
- ``augment_bf16`` (train): the reference's augmentation computed in
  bfloat16, a step below the float32 it states (its numbers alone);
- a step that returns its state unchanged reads 1 on the change by the
  check's own measure, and needs no run.

A train cell's readings follow the same three steps: the program's
augmented batches are replayed to the int8 program, and the reference
augments the program's crops by the program's draws.
"""

import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import harness  # noqa: E402
import kind_cases  # noqa: E402
import kind_train  # noqa: E402
import traffic  # noqa: E402
import weights  # noqa: E402
from reference import predict as refpredict  # noqa: E402
from reference import train as reftrain  # noqa: E402

INT8 = "DINOUNET_TPU_VIT_INT8"
ROWS = ("program", "program_int8", "half_variants", "half_batch", "augment_bf16")


def cases_readings(cell, seeds, dev, rows=ROWS):
    import torch

    cfg, mix = cell.cfg, cell.mix
    predictor, network = kind_cases.build(cell, seeds[0], dev)
    capture = harness.Capture(network.encoder.dinov3_adapter.backbone, torch)
    patch = tuple(cfg["plans_2d"]["patch_size"])
    axes, step = mix["mirror_axes"], mix["tile_step_size"]
    sides = [r for r in ("program", "program_int8") if r in rows]
    for seed in seeds:
        weights.fill(network.named_parameters(), seed, dev)
        ref = kind_cases.reference(cell, seed, dev)
        cases = traffic.cases(mix, seed, cfg["assumed"]["num_input_channels"], dev)
        j = kind_cases.sampled_case(seed, len(cases))
        worst = {k: {"logits_rel_l2": 0.0} for k in sides + [
            r for r in ("half_variants",) if r in rows]}
        for i, case in enumerate(cases):
            want = refpredict.predict_case(ref, case, patch, step, axes, dev)
            for side in sides:
                if side == "program_int8":
                    os.environ[INT8] = "1"
                capture.armed, capture.calls = i == j, []
                got = predictor.predict_logits_from_preprocessed_data(case)
                capture.armed = False
                os.environ.pop(INT8, None)
                w = worst[side]
                w["logits_rel_l2"] = max(w["logits_rel_l2"], kind_cases.rel_l2(got, want))
                if i == j:
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    w["backbone_rel_l2"] = kind_cases.features_gap(ref, case, capture.calls,
                                                                   patch, step, axes, dev)
            if "half_variants" in rows:
                got = refpredict.predict_case(ref, case, patch, step, axes[:1], dev)
                w = worst["half_variants"]
                w["logits_rel_l2"] = max(w["logits_rel_l2"], kind_cases.rel_l2(got, want))
        capture.calls = []
        del ref
        yield seed, worst


def train_readings(cell, seeds, dev, rows=ROWS):
    """Per seed a fresh trainer (as a run builds it) takes the checked steps;
    the other sides follow from its crops, draws and batches."""
    import torch

    cfg = cell.cfg
    for seed in seeds:
        captured, program = kind_train.checked_steps(cell, seed, dev)
        got = {"program": program}
        if "program_int8" in rows:
            got["program_int8"] = kind_train.checked_steps(cell, seed, dev, replay=captured,
                                                           env={INT8: "1"})[1]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        batches, data_gap, label_share = kind_train.augmented(cfg, captured, dev)
        want = reference_steps(cell, seed, batches, dev)
        out = {k: {"augment_rel_l2": data_gap, "augment_label_share": label_share,
                   **kind_train.compare(v, want)} for k, v in got.items()}
        if "half_batch" in rows:
            half = kind_train.compare(reference_steps(cell, seed, batches, dev, half=True), want)
            half.pop("backbone_rel_l2")  # the fault leaves the forward whole
            out["half_batch"] = half
        if "augment_bf16" in rows:
            low, _, _ = kind_train.augmented(cfg, captured, dev, torch.bfloat16)
            as_program = [dict(s, out=(d.cpu(), g.cpu())) for s, (d, g) in zip(captured, low)]
            _, d, lab = kind_train.augmented(cfg, as_program, dev)
            out["augment_bf16"] = {"augment_rel_l2": d, "augment_label_share": lab}
        yield seed, out


def reference_steps(cell, seed, batches, dev, half=False) -> dict:
    import torch

    cfg = cell.cfg
    ref = kind_cases.reference(cell, seed, dev)
    keeps = kind_train.drop_path_keeps(cfg, seed, batches)
    if half:
        batches = [(d[: len(d) // 2], s[: len(s) // 2]) for d, s in batches]
        keeps = [[[k[: len(k) // 2] for k in block] for block in step] for step in keeps]
    out = reftrain.run_steps(ref, batches, keeps, float(cell.mix["initial_lr"]))
    del ref
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--rows", default=",".join(ROWS))
    args = ap.parse_args()
    cell = harness.Cell(BENCH.parent, args.workload)
    harness.program_env(BENCH.parent, cell.cfg)
    import torch

    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    readings = cases_readings if cell.mix["kind"] == "cases" else train_readings
    for seed, row in readings(cell, seeds, dev, tuple(args.rows.split(","))):
        print(json.dumps({"workload": cell.name, "seed": seed, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
