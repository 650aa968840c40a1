"""The port reads the JAX package's trained checkpoints with no JAX.

The JAX package writes here, with its own trainer's ``save_checkpoint``
(``tools/make_jax_checkpoint_fixture.py``'s helpers): a small DinoUNetTrainer
model folder whose fold 0 is the single pickled file (model axis 1) and
fold 1 the orbax directory (model axis 2 on the 8-device test mesh, its
frozen backbone in bf16), both after a few steps of the trainer's optax
chain. The port then reads them with ``jax``, ``flax``, ``optax``,
``orbax``, ``tensorstore``, ``ml_dtypes`` and ``zstandard`` blocked in
``sys.modules``:

* the weights bit-equal to ``state_dict_from_flax`` of the JAX variables,
  whole or read into a template, and the other keys equal;
* the orbax ``leaf_NNNN`` order equal to ``jax.tree.leaves(tx.init(params))``
  and the momentum buffers equal to the JAX trace;
* a port step after loading equal to the JAX trainer's step after its own
  load, within the optax-vs-SGD bound (tests/test_torch_training.py);
* two gloo ranks on a model axis each reading only its shards (the fused
  qkv by heads), equal to the slices of the whole read;
* ``nnUNetPredictor`` on the model folder writing the JAX predictor's files
  (at tests/test_torch_pipeline.py's bounds), and finding directory folds.

The committed fixture (``tests/fixtures/jax_checkpoint``, what the card
reads) must still read to the arrays that the JAX ``load_checkpoint``
gives for it. The OCDBT store and the zarr arrays are also held to
tensorstore on stores it writes with interior B+tree nodes and many
versions.
"""

import contextlib
import hashlib
import json
import os
import pickle
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from dinounet_tpu_torch.compression.ocdbt import OcdbtError, OcdbtStore
from dinounet_tpu_torch.compression.zarr2 import ZarrArray, ZarrError
from dinounet_tpu_torch.inference.predictor import nnUNetPredictor
from dinounet_tpu_torch.models.convert import _torch_layout, state_dict_from_flax
from dinounet_tpu_torch.parallel import launch
from dinounet_tpu_torch.training import jax_checkpoint
from dinounet_tpu_torch.training.checkpointing import (CHECKPOINT_KEYS, JAX_DIRECTORY,
                                                       JAX_FILE, checkpoint_format,
                                                       load_checkpoint, load_checkpoint_meta)
from dinounet_tpu_torch.training.dinounet_trainer import DinoUNetTrainer
from dinounet_tpu_torch.training.trainer import clip_and_step
from tests import torch_ranks
from tests.fixture_network import injected_network
from tests.torch_threads import one_torch_thread  # noqa: F401
from tools import make_jax_checkpoint_fixture as fixture_tool

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "ml_dtypes", "zstandard")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "jax_checkpoint")
FIXTURE_MODEL = os.path.join(FIXTURE, "DinoUNetTrainer__nnUNetPlans__2d")
# the test network: fp32 compute in both packages (the predictors' files are
# held at 1e-4), two heads so that a model axis of 2 splits them
TEST_NETWORK = {
    **fixture_tool.FIXTURE_NETWORK, "model_name": "dinounet_jaxtest",
    "vit_name": "dinov3_jaxtest",
    "vit": {**fixture_tool.FIXTURE_NETWORK["vit"], "num_heads": 2, "dtype": "float32"},
    "overrides": {**fixture_tool.FIXTURE_NETWORK["overrides"], "dtype": "float32"},
}
# fold -> (model axis, devices): the pickled fold on one device, the orbax
# fold on a mesh of 2 of the 8 test devices (orbax's write of its ~640 arrays
# takes 3x longer over all 8)
FOLDS = {0: (1, 1), 1: (2, 2)}
SEG_AGREEMENT, PROBABILITY_ATOL = 0.999, 1e-4
# the predictors return fp16 logits, and where the two fp32 logits of a
# pixel round to neighbouring fp16 values its probabilities move by up to a
# quarter of that ulp: 1.2e-4 at logits between 1 and 2 (measured with the
# heads at full scale). The heads at this scale keep the logits within
# (-1, 1), the range of tests/test_torch_pipeline.py's network, where its
# bound of 1e-4 on the probabilities holds.
HEAD_SCALE = 0.25


@contextlib.contextmanager
def blocked():
    """Importing any of BLOCKED raises inside the block."""
    saved = {k: v for k, v in sys.modules.items() if k.split(".")[0] in BLOCKED}
    try:
        for name in set(saved) | set(BLOCKED):
            sys.modules[name] = None
        yield
    finally:
        for name in set(saved) | set(BLOCKED):
            del sys.modules[name]
        sys.modules.update(saved)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(np.asarray(tree), np.float32)


# the JAX predictor's files of the case from each fold alone, written by a
# process of its own (sys.modules is the process's: the port's reads here
# block the JAX packages while it runs)
_JAX_PREDICTIONS = """
import json, os, sys
sys.path.insert(0, {repo!r})
from dinounet_tpu.inference.predictor import nnUNetPredictor
from tools import make_jax_checkpoint_fixture as fixture_tool
with fixture_tool.network_spec_patches(json.loads({spec!r})):
    predictor = nnUNetPredictor(tile_step_size=0.5, use_mirroring=False, tile_batch=4)
    predictor.initialize_from_trained_model_folder({model!r}, (0, 1))
for fold, params in zip((0, 1), list(predictor.list_of_parameters)):
    predictor.list_of_parameters = [params]
    predictor.predict_from_files({cases!r}, os.path.join({out!r}, f"fold_{{fold}}"),
                                 save_probabilities=True, num_processes_preprocessing=1,
                                 num_processes_segmentation_export=1)
"""


@pytest.fixture(scope="module")
def jax_folder(tmp_path_factory):
    """The JAX trainer's two folds in a model folder, per fold its path and
    what the JAX ``load_checkpoint`` returns; a raw PNG case; and, started
    in the background as soon as the folds are written, the two-rank
    spawn and the JAX predictor's files of the case from each fold (both
    in processes of their own)."""
    from PIL import Image

    from dinounet_tpu.training.checkpointing import load_checkpoint as jax_load

    root = tmp_path_factory.mktemp("jax_ckpt")
    env = {"nnUNet_preprocessed": str(root / "pre"), "nnUNet_results": str(root / "res")}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    plans, dataset_json = fixture_tool.plans_and_dataset("Dataset989_JaxTest")
    folds = {}
    pool = ThreadPoolExecutor(1)
    predictions = None
    try:
        with fixture_tool.network_spec_patches(TEST_NETWORK):
            for fold, (axis, devices) in FOLDS.items():
                trainer = fixture_tool.make_trainer(plans, dataset_json, fold, axis, devices)
                path = fixture_tool.write_fold(trainer, seed=10 + fold, steps=0,
                                               backbone_dtype="bfloat16" if fold else None,
                                               head_scale=HEAD_SCALE)
                folds[fold] = {"path": path, "jax": jax_load(path), "trainer": trainer}
            model = trainer.output_folder_base
            for name, obj in (("plans.json", plans), ("dataset.json", dataset_json)):
                with open(os.path.join(model, name), "w") as f:
                    json.dump(obj, f)
            ranks = pool.submit(launch.spawn, torch_ranks.jax_orbax_shards, 2, {
                "spec": TEST_NETWORK, "path": folds[1]["path"], "plans": plans,
                "dataset_json": dataset_json, "env": env}, devices="cpu")
        (root / "raw").mkdir()
        image = (np.random.default_rng(2).random((72, 80)) * 255).astype(np.uint8)
        Image.fromarray(image).save(root / "raw" / "case_000_0000.png")
        cases = [[str(root / "raw" / "case_000_0000.png")]]
        out = str(root / "jax_predictions")
        code = _JAX_PREDICTIONS.format(repo=REPO, spec=json.dumps(TEST_NETWORK), model=model,
                                       cases=cases, out=out)
        predictions = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True,
                                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
        yield {"model": model, "folds": folds, "plans": plans, "dataset_json": dataset_json,
               "env": env, "root": root, "cases": cases, "ranks": ranks,
               "jax_predictions": lambda: _finished(predictions, out)}
    finally:
        pool.shutdown(wait=True)
        if predictions is not None:
            predictions.communicate(timeout=600)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _finished(process: subprocess.Popen, out: str) -> str:
    output, _ = process.communicate(timeout=600)
    assert process.returncode == 0, output[-3000:]
    return out


def _port_trainer(jax_folder, fold):
    with injected_network(TEST_NETWORK):
        trainer = DinoUNetTrainer(jax_folder["plans"], "2d", fold,
                                  jax_folder["dataset_json"], device="cpu")
        trainer.seed = 0
        trainer.initialize()
    return trainer


def _trainable_names(trainer):
    return [n for n, p in trainer.network.named_parameters() if p.requires_grad]


# ------------------------------------------------------------------ weights


@pytest.mark.parametrize("fold", sorted(FOLDS))
def test_weights_and_meta_equal_the_jax_reading(jax_folder, fold):
    """Either form, read with the JAX packages blocked: the weights
    bit-equal to state_dict_from_flax of the variables that the JAX
    load_checkpoint returns, and every other key equal."""
    f = jax_folder["folds"][fold]
    want = state_dict_from_flax(_np_tree(f["jax"]["network_weights"]))
    with blocked():
        fmt = checkpoint_format(f["path"])
        got = load_checkpoint(f["path"])
        meta = load_checkpoint_meta(f["path"])
    assert fmt == (JAX_FILE if fold == 0 else JAX_DIRECTORY)
    assert set(got) == set(CHECKPOINT_KEYS)
    assert got["network_weights"].keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got["network_weights"][k], v), k
    for k, v in f["jax"].items():
        if k not in ("network_weights", "optimizer_state"):
            assert got[k] == v == meta[k], k
    assert got["optimizer_state"] is None  # the optimizer's order needs the names


@pytest.mark.parametrize("fold", sorted(FOLDS))
def test_template_read_equals_the_whole_read(jax_folder, fold):
    """Read into the port network's own tensors: the same values, in the
    template's tensors."""
    f = jax_folder["folds"][fold]
    want = state_dict_from_flax(_np_tree(f["jax"]["network_weights"]))
    with injected_network(TEST_NETWORK):
        network = DinoUNetTrainer.build_network_architecture(
            "DinoUNet", {}, [], 1, 3, enable_deep_supervision=False)
    template = network.state_dict()
    with blocked():
        got = load_checkpoint(f["path"], network_template=template)["network_weights"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] is template[k] and torch.equal(got[k], v.to(got[k].dtype)), k


@pytest.mark.parametrize("fold", [0, 1])
def test_committed_fixture_reads_as_jax_reads_it(fold):
    """The fixture that the card reads: every array as the JAX
    load_checkpoint gives it (and as sha256.json records it)."""
    from dinounet_tpu.training.checkpointing import load_checkpoint as jax_load

    path = os.path.join(FIXTURE_MODEL, f"fold_{fold}", "checkpoint_final.pth")
    want = fixture_tool.array_digests(jax_load(path))
    with open(os.path.join(FIXTURE, "sha256.json")) as fh:
        assert json.load(fh)[f"fold_{fold}"] == want
    with blocked():
        raw = jax_checkpoint.read_jax_checkpoint(path)
    got = {}
    for p, t in _flat(raw["network_weights"], "network_weights"):
        got[p] = _digest(t)
    for i, t in enumerate(jax_checkpoint.tree_leaves(raw["optimizer_state"])):
        got[f"optimizer_state/{i:04d}"] = _digest(torch.as_tensor(t))
    assert got == want


def _flat(tree, prefix):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", tree[k]


def _digest(t: torch.Tensor) -> str:
    bf16 = t.dtype == torch.bfloat16
    a = (t.view(torch.int16) if bf16 else t).contiguous().numpy()
    dtype = "bfloat16" if bf16 else str(a.dtype)
    return f"{dtype} {'x'.join(map(str, a.shape))} {hashlib.sha256(a.tobytes()).hexdigest()}"


# ---------------------------------------------------------------- optimizer


def test_orbax_leaf_order_equals_jax(jax_folder):
    """The trainable params' traces, then the count: the order of
    jax.tree.leaves(tx.init(params)), derived here from the sorted keys."""
    import jax

    f = jax_folder["folds"][1]
    params = f["jax"]["network_weights"]["params"]
    leaves = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(f["trainer"].tx.init, params))[0]
    want = []
    for path, leaf in leaves:
        keys = tuple(getattr(k, "key", None) for k in path)
        trace = [i for i, k in enumerate(path) if getattr(k, "name", None) == "trace"]
        want.append(tuple(keys[trace[0] + 1:]) if trace else "count")
    got = jax_checkpoint.trace_leaf_paths(params) + ["count"]
    assert got == want
    stored = sorted(f["jax"]["optimizer_state"])
    assert stored == [f"leaf_{i:04d}" for i in range(len(want))]
    for name, path in zip(stored[:-1], got[:-1]):
        node = params
        for k in path:
            node = node[k]
        assert f["jax"]["optimizer_state"][name].shape == node.shape


@pytest.mark.parametrize("fold", sorted(FOLDS))
def test_momentum_equals_the_jax_trace(jax_folder, fold):
    import jax

    f = jax_folder["folds"][fold]
    trainer = _port_trainer(jax_folder, fold)
    names = _trainable_names(trainer)
    with blocked():
        opt = load_checkpoint(f["path"], trainable_names=names)["optimizer_state"]
    params = f["jax"]["network_weights"]["params"]
    paths = jax_checkpoint.trace_leaf_paths(params)
    jax_opt = f["jax"]["optimizer_state"]
    leaves = ([jax_opt[k] for k in sorted(jax_opt)] if fold else jax.tree.leaves(jax_opt))
    by_name = {}
    for path, leaf in zip(paths, leaves):
        name = jax_checkpoint.port_names(path)[0][0]
        by_name[name] = torch.from_numpy(np.ascontiguousarray(
            _torch_layout("/".join(path[1:]), np.asarray(leaf, np.float32))))
    assert len(opt["state"]) == len(names) == len(by_name)
    for i, name in enumerate(names):
        assert torch.equal(opt["state"][i]["momentum_buffer"], by_name[name]), name
    assert set(opt) == {"state"}  # the hyperparameters are the resuming trainer's


def test_resume_keeps_the_trainers_own_hyperparameters(jax_folder):
    """A trainer whose SGD has another momentum and decay than the JAX
    trainer's keeps them when it resumes from a JAX fold, and takes the
    fold's momentum buffers."""
    trainer = _port_trainer(jax_folder, 1)
    for group in trainer.optimizer.param_groups:
        group.update(momentum=0.9, weight_decay=1e-4)
    groups = [{k: v for k, v in g.items() if k != "params"}
              for g in trainer.optimizer.param_groups]
    with blocked():
        trainer.load_checkpoint(jax_folder["folds"][1]["path"])
    assert [{k: v for k, v in g.items() if k != "params"}
            for g in trainer.optimizer.param_groups] == groups
    trainable = [p for p in trainer.network.parameters() if p.requires_grad]
    assert all("momentum_buffer" in trainer.optimizer.state[p] for p in trainable)


@pytest.mark.parametrize("fold", sorted(FOLDS))
def test_resumed_step_matches_the_jax_step(jax_folder, fold):
    """The port trainer's load_checkpoint and one SGD step, against the
    JAX trainer's own load_checkpoint and one step of its optax chain, on
    the same gradients (clipped: their global norm is over 12)."""
    import jax
    import jax.numpy as jnp
    import optax

    from dinounet_tpu.parallel import replicated

    f = jax_folder["folds"][fold]
    jt = f["trainer"]
    jt.load_checkpoint(f["path"])
    params = jt.variables["params"]
    opt_state = jax.device_put(jt.opt_state, replicated(jt.mesh))
    rng = np.random.default_rng(5)
    grads = jax.tree.map(lambda p: np.asarray(3 * rng.standard_normal(p.shape), np.float32),
                         jax.device_get(params))
    placed = jax.tree.map(lambda g, p: jax.device_put(jnp.asarray(g, p.dtype), p.sharding),
                          grads, params)
    stepped = jax.jit(lambda g, o, p: optax.apply_updates(p, jt.tx.update(g, o, p)[0]))(
        placed, opt_state, params)
    count = int(jax.tree.leaves(jt.opt_state)[-1])
    lr = fixture_tool_lr(jt, count)
    want = state_dict_from_flax({"params": _np_tree(stepped)})

    trainer = _port_trainer(jax_folder, fold)
    with blocked():
        trainer.load_checkpoint(f["path"])
    assert trainer.current_epoch == f["jax"]["current_epoch"]
    assert trainer._best_ema == f["jax"]["_best_ema"]
    assert trainer.logger.my_fantastic_logging["train_losses"] == \
        f["jax"]["logging"]["train_losses"]
    port_grads = state_dict_from_flax({"params": grads})
    for name, p in trainer.network.named_parameters():
        if p.requires_grad:
            p.grad = port_grads[name].clone()
    for group in trainer.optimizer.param_groups:
        group["lr"] = lr
    clip_and_step(trainer.optimizer, 12.0)
    for name, p in trainer.network.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def fixture_tool_lr(jax_trainer, count: int) -> float:
    """The JAX chain's learning rate at step `count` (its poly schedule)."""
    from dinounet_tpu.training.lr_scheduler import poly_lr

    return float(poly_lr(jax_trainer.initial_lr, count // jax_trainer.num_iterations_per_epoch,
                         jax_trainer.num_epochs))


# ------------------------------------------------------------ a model axis


def test_two_ranks_read_only_their_shards(jax_folder):
    """Two gloo ranks, a DinoUNetTrainer on a model axis of 2 each, resume
    from the orbax fold: each holds its slices of the whole read (the qkv
    by heads of q, k and v) and the whole momentum, and asked the stored
    arrays for exactly the elements it holds."""
    ranks = jax_folder["ranks"].result()
    assert [r["rank"] for r in ranks] == [0, 1]
    names = {}  # state-dict name -> the zarr array it is read from
    for path in _leaf_paths(jax_folder["folds"][1]["jax"]["network_weights"]):
        for name, _, _ in jax_checkpoint.port_names(path[1:]):
            names[name] = ".".join(("network_weights",) + path)
    for r in ranks:
        assert r["size"] == 2 and r["epoch"] == jax_folder["folds"][1]["jax"]["current_epoch"]
        assert r["equal_to_slices"] and r["momentum_equal"]
        assert any(k.endswith("attn.qkv.weight") for k in r["split"])
        for name, n in r["held"].items():
            if name in names:
                assert r["requested"][names[name]] == n, name


def _leaf_paths(tree, prefix=()):
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += _leaf_paths(tree[k], prefix + (k,))
        else:
            out.append(prefix + (k,))
    return out


# ------------------------------------------------------------ the predictor


@pytest.mark.parametrize("fold", sorted(FOLDS))
def test_predictor_on_a_jax_model_folder_writes_the_jax_predictors_files(jax_folder,
                                                                         tmp_path, fold):
    """Both predictors' initialize_from_trained_model_folder on the JAX
    model folder, predict_from_files of one raw PNG case from each fold
    with the probabilities saved: the same segmentation on >= 99.9 % of
    the pixels, probabilities within 1e-4. The port detects both folds;
    the JAX predictor's detection skips the directory one."""
    from dinounet_tpu_torch.imageio.natural_image import NaturalImage2DIO

    model = jax_folder["model"]
    assert nnUNetPredictor.auto_detect_available_folds(model, "checkpoint_final.pth") == [0, 1]
    with injected_network(TEST_NETWORK), blocked():
        p = nnUNetPredictor(tile_step_size=0.5, use_mirroring=False, device="cpu",
                            tile_batch=4)
        p.initialize_from_trained_model_folder(model, (fold,))
        p.predict_from_files(jax_folder["cases"], str(tmp_path / "port"),
                             save_probabilities=True, num_processes_preprocessing=1,
                             num_processes_segmentation_export=1)
    jax_out = os.path.join(jax_folder["jax_predictions"](), f"fold_{fold}")
    io = NaturalImage2DIO()
    got = io.read_seg(str(tmp_path / "port" / "case_000.png"))[0]
    want = io.read_seg(os.path.join(jax_out, "case_000.png"))[0]
    dtypes = {k: v.dtype for k, v in p.network.state_dict().items()}
    assert {k: v.dtype for k, v in p.list_of_parameters[0].items()} == dtypes
    assert got.shape == want.shape == (1, 1, 72, 80)
    assert float(np.mean(got == want)) >= SEG_AGREEMENT
    pg = np.load(tmp_path / "port" / "case_000.npz")["probabilities"]
    pw = np.load(os.path.join(jax_out, "case_000.npz"))["probabilities"]
    assert pg.shape == pw.shape
    np.testing.assert_allclose(pg, pw, rtol=0, atol=PROBABILITY_ATOL)


# ------------------------------------------------------------- the pickles


def test_bf16_pickles_and_refused_globals(tmp_path):
    """The JAX save_checkpoint's single file with bf16 arrays reads to their
    bits; a pickle naming any other global (jax's, os's) raises without the
    global being imported."""
    import ml_dtypes

    from dinounet_tpu.training.checkpointing import save_checkpoint as jax_save

    rng = np.random.default_rng(0)
    w = rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16)
    f = np.asfortranarray(rng.standard_normal((3, 4)).astype(np.float32))
    jax_save({"network_weights": {"params": {"w": w, "f": f, "i": np.arange(4, dtype=np.int64)}},
              "optimizer_state": None, "current_epoch": np.int64(3),
              "_best_ema": np.float32(0.5)}, str(tmp_path / "ck.pth"))
    with blocked():
        got = jax_checkpoint.read_jax_pickle(str(tmp_path / "ck.pth"))
    params = got["network_weights"]["params"]
    assert params["w"].dtype == torch.bfloat16
    assert np.array_equal(params["w"].view(torch.int16).numpy(), w.view(np.int16))
    assert np.array_equal(params["f"].numpy(), f) and params["i"].tolist() == [0, 1, 2, 3]
    assert got["current_epoch"] == 3 and type(got["current_epoch"]) is int
    assert got["_best_ema"] == 0.5

    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    for obj, name in ((Evil(), "system"), ({"network_weights": sys.modules["jax"].numpy.zeros(2)},
                                           "jax")):
        path = tmp_path / f"{name}.pth"
        with open(path, "wb") as fh:
            pickle.dump(obj, fh)
        with blocked(), pytest.raises(jax_checkpoint.JaxCheckpointError, match="global"):
            jax_checkpoint.read_jax_pickle(str(path))


def test_refused_orbax_layouts(jax_folder, tmp_path):
    """zarr v3 and orbax's layout without OCDBT raise by name."""
    src = jax_folder["folds"][1]["path"]
    for key, value, match in (("use_zarr3", True, "zarr v3"), ("use_ocdbt", False, "OCDBT")):
        dst = tmp_path / key
        shutil.copytree(src, dst)
        meta_path = dst / "arrays" / "_METADATA"
        meta = json.loads(meta_path.read_text())
        meta[key] = value
        meta_path.write_text(json.dumps(meta))
        with pytest.raises(jax_checkpoint.JaxCheckpointError, match=match):
            jax_checkpoint.read_orbax_directory(str(dst))


# --------------------------------------------------------- OCDBT and zarr


@pytest.fixture(scope="module")
def tensorstore_db(tmp_path_factory):
    """An OCDBT database tensorstore writes with small nodes (interior
    B+tree levels), inline and out-of-line values and 60 versions, and the
    values it holds."""
    import tensorstore as ts

    root = tmp_path_factory.mktemp("ocdbt")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": {"max_decoded_node_bytes": 400,
                                     "max_inline_value_bytes": 20,
                                     "version_tree_arity_log2": 2,
                                     "compression": {"id": "zstd", "level": 5}}}).result()
    rng = np.random.default_rng(1)
    values = {}
    for i in range(60):
        key = f"k{i % 37:03d}/{'x' * (i % 5)}"
        values[key] = rng.integers(0, 256, int(rng.integers(0, 60)), dtype=np.uint8).tobytes()
        kv.write(key, values[key]).result()
    return str(root), values


@pytest.mark.parametrize("decoder", ["plain", "native"])
def test_ocdbt_store_reads_what_tensorstore_wrote(tensorstore_db, decoder):
    root, values = tensorstore_db
    with blocked():
        store = OcdbtStore(root, decoder)
        assert store._root[0] > 0  # interior nodes
        assert store.keys() == sorted(values)
        assert store.read_many(list(values)) == values
        with pytest.raises(KeyError):
            store.read("missing")


def test_ocdbt_checksums_are_verified(tensorstore_db, tmp_path):
    root, _ = tensorstore_db
    shutil.copytree(root, tmp_path / "db")
    manifest = tmp_path / "db" / "manifest.ocdbt"
    raw = bytearray(manifest.read_bytes())
    raw[20] ^= 1
    manifest.write_bytes(bytes(raw))
    with pytest.raises(OcdbtError, match="CRC-32C"):
        OcdbtStore(str(tmp_path / "db"))


@pytest.mark.parametrize("dtype", ["bfloat16", "<f4", "<i4", "|b1", "|u1", "<f8"])
def test_zarr_regions_equal_numpy(tmp_path, dtype):
    """Arrays tensorstore writes as zarr v2 over OCDBT (chunks that do not
    divide the shape): whole and region reads equal numpy's slices; a
    missing chunk raises without a fill value and fills with one."""
    import ml_dtypes
    import tensorstore as ts

    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((13, 10, 7)) * 4).astype(np_dtype)
    kv = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    for name, fill in (("a", None), ("b", False if dtype == "|b1" else 0)):
        spec = {"driver": "zarr", "kvstore": {**kv, "path": f"{name}/"},
                "metadata": {"dtype": dtype, "shape": list(a.shape), "chunks": [4, 6, 7],
                             "compressor": {"id": "zstd", "level": 1}, "fill_value": fill}}
        arr = ts.open(spec, create=True).result()
        if name == "a":
            arr.write(a).result()
        else:
            arr[:4].write(a[:4]).result()
    store = OcdbtStore(str(tmp_path))
    z = ZarrArray(store, "a")
    want = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) if dtype == "bfloat16" \
        else torch.from_numpy(a)
    assert torch.equal(z.read(), want)
    for region in ((slice(2, 11), slice(3, 10), slice(0, 7)), (slice(4, 8),) * 2 + (slice(1, 3),),
                   (slice(0, 13), slice(0, 10), slice(0, 7))):
        assert torch.equal(z.read_region(region), want[region]), region
    b = ZarrArray(store, "b")
    got = b.read()
    assert torch.equal(got[:4], want[:4]) and not got[4:].to(torch.float32).any()
    b.fill_value = None
    with pytest.raises(ZarrError, match="missing"):
        b.read_region((slice(5, 6), slice(0, 1), slice(0, 1)))


# ------------------------------------------------------------ full width

_FULL_WIDTH_READ = """
import hashlib, json, sys, time
for m in {blocked!r}:
    sys.modules[m] = None
sys.path.insert(0, {repo!r})
from dinounet_tpu_torch.training.checkpointing import load_checkpoint
out = {{}}
for path in {paths!r}:
    t0 = time.perf_counter()
    weights = load_checkpoint(path)["network_weights"]
    seconds = time.perf_counter() - t0
    out[path] = {{"seconds": seconds, "digests": {{
        k: hashlib.sha256(v.contiguous().numpy().tobytes()).hexdigest()
        for k, v in weights.items()}}}}
    del weights
# VmHWM: this process's own peak (ru_maxrss would count the parent's pages
# at the fork that started it)
with open("/proc/self/status") as f:
    out["max_rss_mb"] = next(int(line.split()[1]) for line in f
                             if line.startswith("VmHWM")) / 1024
print(json.dumps(out))
"""


@pytest.mark.slow
def test_full_width_dinounet_b_reads_bit_equal(tmp_path):
    """DinoUNetTrainer_b at full width (ViT-B/16, the default adapter and
    decoder), written by the JAX trainer in both forms (model axis 1: the
    pickled file; 2: the orbax directory over 8 devices), read in a fresh
    process with the JAX packages blocked: every tensor bit-equal to
    state_dict_from_flax of the JAX variables. Prints the read seconds and
    the reader's peak RSS. Marked slow: JAX's write of the full-width state
    on the CPU takes minutes."""
    from dinounet_tpu.models.vit import VIT_CONFIGS as JAX_VIT_CONFIGS
    from dinounet_tpu.training.checkpointing import load_checkpoint as jax_load

    vit = JAX_VIT_CONFIGS["dinov3_vitb16"]
    spec = {"model_name": "dinounet_b_full", "vit_name": "dinov3_vitb16_full",
            "vit": {f: getattr(vit, f) for f in ("embed_dim", "depth", "num_heads",
                                                  "ffn_ratio", "ffn_layer", "qkv_bias")},
            "interaction_indexes": [2, 5, 8, 11], "overrides": {},
            "architecture": {**fixture_tool.ARCHITECTURE,
                             "features_per_stage": [32, 64, 128, 256]}}
    env = {"nnUNet_preprocessed": str(tmp_path / "pre"),
           "nnUNet_results": str(tmp_path / "res")}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    plans, dataset_json = fixture_tool.plans_and_dataset("Dataset988_FullWidth")
    want, paths = {}, []
    try:
        with fixture_tool.network_spec_patches(spec):
            for fold, axis in ((0, 1), (1, 2)):
                trainer = fixture_tool.make_trainer(plans, dataset_json, fold, axis)
                path = fixture_tool.write_fold(trainer, seed=fold, steps=0)
                variables = _np_tree(jax_load(path)["network_weights"])
                want[path] = {k: hashlib.sha256(v.contiguous().numpy().tobytes()).hexdigest()
                              for k, v in state_dict_from_flax(variables).items()}
                paths.append(path)
                del trainer, variables
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    code = _FULL_WIDTH_READ.format(blocked=BLOCKED, repo=REPO, paths=paths)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for path in paths:
        assert got[path]["digests"] == want[path], path
        print(f"{os.path.basename(os.path.dirname(path))}: {len(want[path])} tensors read "
              f"in {got[path]['seconds']:.2f} s")
    print(f"reader's peak RSS {got['max_rss_mb']:.0f} MB")
