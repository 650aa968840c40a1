"""No module that a run or the reference loads has the top-level name
``jax``, ``jaxlib``, ``flax`` or ``dinounet_tpu`` (the part before the first
dot, compared whole: the port's own name begins with the JAX package's),
and the reference loads nothing of the program either."""

import json
import subprocess
import sys

from conftest import BENCH, ROOT

PROBE = '''
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
'''


def top_level(imports: str):
    code = PROBE.format(bench=str(BENCH), root=str(ROOT), imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = top_level("import run, harness, kind_cases, kind_train, control\n"
                       "import dinounet_tpu_torch.inference.predictor\n"
                       "import dinounet_tpu_torch.run\n"
                       "import dinounet_tpu_torch.training.dinounet_trainer")
    assert "dinounet_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "dinounet_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = top_level("import reference.model, reference.predict, reference.train, weights")
    assert not loaded & {"jax", "jaxlib", "flax", "dinounet_tpu", "dinounet_tpu_torch"}


def test_the_check_compares_whole_top_level_names():
    import harness

    assert harness.forbidden_modules(["dinounet_tpu_torch.run", "torch", "jaxtyping"]) == []
    assert harness.forbidden_modules(["jaxlib.xla_client", "dinounet_tpu.models",
                                      "flax"]) == ["dinounet_tpu", "flax", "jaxlib"]
