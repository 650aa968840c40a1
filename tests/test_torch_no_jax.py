"""The port stands without JAX: the machine that serves it has none.

Every module of ``dinounet_tpu_torch`` and the end-to-end CLI
``dinounet_training_torch.py`` are imported in a fresh interpreter, after
which neither jax, flax nor the JAX package may be loaded; and no source file
of the port, the CLI included, names them in an import (lazy imports
included).
"""

import json
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import dinounet_tpu_torch

PKG_DIR = Path(dinounet_tpu_torch.__file__).parent
REPO = PKG_DIR.parent
CLI = REPO / "dinounet_training_torch.py"
FORBIDDEN = ("jax", "flax", "dinounet_tpu")
_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(jax|flax|dinounet_tpu)(?![\w])", re.MULTILINE)


def _port_modules():
    """Every module of the package, and the CLI script."""
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG_DIR)],
                                                        "dinounet_tpu_torch.")
                  ) + [CLI.stem]


def test_importing_every_port_module_loads_no_jax():
    modules = _port_modules()
    assert "dinounet_tpu_torch.inference.predictor" in modules
    assert "dinounet_tpu_torch.api" in modules and "dinounet_training_torch" in modules
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_port_source_imports_jax():
    sources = sorted(PKG_DIR.rglob("*.py")) + [CLI]
    assert CLI.is_file() and PKG_DIR / "api.py" in sources
    offenders = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
                 for p in sources for m in _IMPORT.finditer(p.read_text())]
    assert offenders == []
    assert _IMPORT.search("    from dinounet_tpu.ops import x")  # the check bites
    assert not _IMPORT.search("from dinounet_tpu_torch.ops import x")


def test_importing_every_port_module_needs_no_pil():
    """No port module imports PIL at its top: the card's machine may lack
    it, and only reading or writing a PNG or TIFF file needs it."""
    modules = _port_modules()
    assert "dinounet_tpu_torch.imageio.natural_image" in modules
    code = (
        "import importlib, sys\n"
        "sys.modules['PIL'] = None\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_importing_every_port_module_needs_no_matplotlib():
    """Nor matplotlib: only writing an overlay PNG or the progress plot
    imports it, inside the function. The post-training tools are among the
    modules imported."""
    modules = _port_modules()
    for name in ("postprocessing.remove_connected_components", "ensembling.ensemble",
                 "evaluation.accumulate_cv_results", "evaluation.find_best_configuration",
                 "utilities.overlay_plots"):
        assert "dinounet_tpu_torch." + name in modules
    code = (
        "import importlib, sys\n"
        "sys.modules['PIL'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] == 'matplotlib'"
        " and sys.modules[k] is not None))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_importing_every_port_module_needs_no_zstandard():
    """Nor zstandard: only the Blosc zstd codec imports it, on first use
    (``compression/blosc1_chunk.py``). The dataset backends, the loader
    and the ``.b2nd`` engine are among the modules imported."""
    modules = _port_modules()
    for name in ("compression.blosc1_chunk", "compression.b2nd", "compression.blosc2_shim",
                 "training.nnunet_dataset", "training.data_loader"):
        assert "dinounet_tpu_torch." + name in modules
    code = (
        "import importlib, sys\n"
        "sys.modules['zstandard'] = None\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"
