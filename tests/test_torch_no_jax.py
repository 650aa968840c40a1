"""The port stands without JAX: the machine that serves it has none.

Every module of ``dinounet_tpu_torch`` and the end-to-end CLI
``dinounet_training_torch.py`` are imported in a fresh interpreter, after
which neither jax, flax, the JAX package, nor the packages its checkpoints
are written with (optax, orbax, tensorstore, ml_dtypes) may be loaded; no
source file of the port, the CLI, ``chip_smoke.py`` and the test helper it
imports included, names them
in an import (lazy imports included); and the JAX package's checkpoints
and a zstd ``.b2nd`` file read with all of them and ``zstandard`` blocked.
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
FORBIDDEN = ("jax", "flax", "dinounet_tpu", "optax", "orbax", "tensorstore", "ml_dtypes")
_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(jax|flax|dinounet_tpu|optax|orbax|tensorstore|ml_dtypes)"
    r"(?![\w])", re.MULTILINE)
_ZSTANDARD = re.compile(r"^\s*(?:from|import)\s+zstandard(?![\w])", re.MULTILINE)
CHIP_SMOKE = REPO / "chip_smoke.py"
FIXTURE_NETWORK = REPO / "tests" / "fixture_network.py"  # chip_smoke.py imports it
JAX_FIXTURE = REPO / "tests" / "fixtures" / "jax_checkpoint"


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
    sources = sorted(PKG_DIR.rglob("*.py")) + [CLI, CHIP_SMOKE, FIXTURE_NETWORK]
    assert CLI.is_file() and FIXTURE_NETWORK.is_file() and PKG_DIR / "api.py" in sources
    offenders = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
                 for p in sources for m in _IMPORT.finditer(p.read_text())]
    assert offenders == []
    assert _IMPORT.search("    from dinounet_tpu.ops import x")  # the check bites
    assert _IMPORT.search("        import optax._src.base")
    assert not _IMPORT.search("from dinounet_tpu_torch.ops import x")
    # zstandard: imported once, where a Blosc zstd chunk is written
    zstd_importers = [p.relative_to(REPO) for p in sources
                      if _ZSTANDARD.search(p.read_text())]
    assert [str(p) for p in zstd_importers] == [
        "dinounet_tpu_torch/compression/blosc1_chunk.py"]
    blosc = (PKG_DIR / "compression" / "blosc1_chunk.py").read_text()
    assert len(_ZSTANDARD.findall(blosc)) == 1
    assert "def _zstandard():\n" in blosc


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
    """Nor zstandard: only writing a Blosc zstd chunk imports it, on first
    use (``compression/blosc1_chunk.py``). The dataset backends, the loader
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


def test_the_jax_checkpoints_read_with_the_jax_packages_blocked():
    """In a fresh interpreter with jax, flax, optax, orbax, tensorstore,
    ml_dtypes and zstandard blocked: every port module imports, both folds
    of the committed JAX model folder (its pickled file and its orbax
    directory) read to the port's dict, and its zstd ``.b2nd`` case reads
    equal to its array."""
    modules = _port_modules()
    for name in ("compression.zstd", "compression.zstd_native", "compression.ocdbt",
                 "compression.zarr2", "training.jax_checkpoint"):
        assert "dinounet_tpu_torch." + name in modules
    model = JAX_FIXTURE / "DinoUNetTrainer__nnUNetPlans__2d"
    code = (
        "import importlib, sys\n"
        f"for m in {FORBIDDEN + ('zstandard',)!r}: sys.modules[m] = None\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import numpy as np\n"
        "from dinounet_tpu_torch.training.checkpointing import load_checkpoint\n"
        "from dinounet_tpu_torch.compression.b2nd import open_b2nd\n"
        "for f in (0, 1):\n"
        f"    c = load_checkpoint(f'{model}/fold_{{f}}/checkpoint_final.pth')\n"
        "    assert c['trainer_name'] == 'DinoUNetTrainer' and len(c['network_weights']) > 300\n"
        f"a = open_b2nd('{JAX_FIXTURE / 'case.b2nd'}')[:]\n"
        f"assert np.array_equal(a, np.load('{JAX_FIXTURE / 'case.npy'}'))\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


TORCH_TOOLS = sorted((REPO / "tools").glob("*_torch.py"))
# the JAX package's tools, whose counterparts these are
_JAX_TOOL = re.compile(r"^\s*(?:from|import)\s+(?:tools\.)?(learnability_run|"
                       r"int8_accuracy_experiment)(?![\w])", re.MULTILINE)


def test_the_torch_tools_import_no_jax():
    """``tools/*_torch.py`` (the learnability run, the int8 accuracy
    experiment) name neither JAX, the JAX package nor the JAX tools in an
    import, and importing them in a fresh interpreter loads none of them."""
    names = [p.name for p in TORCH_TOOLS]
    assert {"learnability_run_torch.py", "int8_accuracy_experiment_torch.py"} <= set(names)
    offenders = [f"{p.name}: {m.group(0).strip()}" for p in TORCH_TOOLS
                 for pattern in (_IMPORT, _JAX_TOOL) for m in pattern.finditer(p.read_text())]
    assert offenders == []
    assert _JAX_TOOL.search("    from tools.learnability_run import make_dataset")
    assert _JAX_TOOL.search("import int8_accuracy_experiment")
    assert not _JAX_TOOL.search("from tools.learnability_run_torch import main")
    code = (
        "import importlib.util, json, sys\n"
        f"for p in {[str(p) for p in TORCH_TOOLS]!r}:\n"
        "    spec = importlib.util.spec_from_file_location(p.split('/')[-1][:-3], p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r} or k.split('.')[-1] in ('learnability_run', "
        "'int8_accuracy_experiment'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
