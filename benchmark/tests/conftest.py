"""The benchmark's own tests: CPU tests at a tiny size, and tests marked
``cuda`` that run the controls at a cell's size on the card (they skip
without one; a fixture decides, never an import).

    python -m pytest -q benchmark/tests            # here, on the CPU
    python -m pytest -q benchmark/tests -m cuda    # on a machine with the card
"""

import copy
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the control's readings at a cell's size run on the card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _threads_and_environment():
    """Torch on few threads beside other test workers; the environment as
    it was (a run sets the program's variables)."""
    import os

    import torch

    n = torch.get_num_threads()
    saved = dict(os.environ)
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
    os.environ.clear()
    os.environ.update(saved)


def tiny_config(name: str = "tiny_s", patch: int = 64, batch: int = 2) -> dict:
    """dinounet_b's configuration file with ViT-S/16's widths and a small
    patch: the same program path at a size the CPU holds."""
    with open(BENCH / "configs" / "dinounet_b.json") as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg.update(name=name, model_name="dinounet_s", trainer="DinoUNetTrainer_s",
               batch_size=batch)
    cfg["backbone"].update(published="dinov3_vits16", embed_dim=384, num_heads=6,
                           ffn_hidden=1536)
    cfg["plans_2d"].update(patch_size=[patch, patch], batch_size=batch)
    return cfg


def write_root(tmp: Path, cfg: dict, mixes: dict, cells: dict, limits: dict,
               metrics: dict = None) -> Path:
    """A checkout-like folder: BENCHMARK.json beside a benchmark folder
    ``bench`` holding only the given data files and metric readers."""
    bench = tmp / "bench"
    for sub in ("configs", "traffic", "checks", "metrics"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    (bench / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    for name, mix in mixes.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for cell, lim in limits.items():
        (bench / "checks" / f"{cell}.json").write_text(json.dumps(lim))
    for name, src in (metrics or {}).items():
        (bench / "metrics" / f"{name}.py").write_text(src)
    with open(ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    spec["paths"] = ["bench"]
    spec["configs"] = [{"name": cfg["name"], "source": "test", "reduced": [], "why": "test",
                        "file": f"bench/configs/{cfg['name']}.json"}]
    spec["workloads"] = [{"name": c, "config": cfg["name"], "traffic": t, "chips": 1,
                          "why": "test"} for c, t in cells.items()]
    kinds = {c: mixes[t]["kind"] for c, t in cells.items()}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            want = "cases" if "predict" in m["name"] else "train"
            m["workloads"] = [c for c, k in kinds.items() if k == want]
    for name in (metrics or {}):
        spec["per_layer"].append({"name": name, "unit": "n", "better": "higher",
                                  "source": "program_counter", "layer": "test",
                                  "moves": "setup_s", "workloads": list(cells)})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


TINY_CASES = {"kind": "cases", "cycle": [[128, 128], [192, 160], [96, 128]],
              "tile_step_size": 0.5, "use_gaussian": True, "mirror_axes": [0, 1],
              "tile_batch": 2}
TINY_TRAIN = {"kind": "train", "n_cases": 6, "case_size": [128, 128], "initial_lr": 0.001}


def real_limits(cell: str) -> dict:
    with open(BENCH / "checks" / f"{cell}.json") as f:
        return json.load(f)


# At a size the CPU holds a random ViT-S's bfloat16 gradients read 6-14 % off in
# the relative L2 numbers, where dinounet_b's at 512^2 read 1-2 % on the card:
# the tiny train cell is held to b.train's other limits only.
TINY_TRAIN_CHECKS = ("augment_rel_l2", "augment_label_share", "backbone_rel_l2",
                     "first_grad_leaf_gap", "change_leaf_gap")


@pytest.fixture()
def tiny_root(tmp_path, monkeypatch):
    """A tiny predict cell and a tiny train cell, held to the real cells'
    limits (``b.predict``'s, and ``b.train``'s of ``TINY_TRAIN_CHECKS``)."""
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    cfg = tiny_config(patch=128, batch=4)
    root = write_root(tmp_path / "root", cfg, {"tiny_cases": TINY_CASES,
                                               "tiny_train": TINY_TRAIN},
                      {"t.predict": "tiny_cases", "t.train": "tiny_train"},
                      {"t.predict": real_limits("b.predict"),
                       "t.train": {k: v for k, v in real_limits("b.train").items()
                                   if k in TINY_TRAIN_CHECKS}})
    return root
