"""The port's ``parallel/`` against the JAX package's, on CPU ranks.

The rank bodies live in ``tests/torch_ranks.py`` (no JAX) and in the port's
``parallel/dryrun.py``; ``parallel.launch.spawn`` starts them as gloo ranks
on the CPU. This process computes the JAX side and hands every rank the same
numpy-made tensors. One spawn of two ranks holds the mesh, the repeated and
the conflicting ``init_distributed``, a data-parallel train step of the tiny
DinoUNet of tests/test_torch_models.py (batch Dice off and on), the narrow
SwiGLU and mlp blocks split over a model axis (in bf16 arithmetic's fp32
and in the int8 serving mode, on the JAX blocks' weights and on weights
whose maxima lie off each rank), and a sharded checkpoint's round trip;
another runs four trainers on a model axis of 2 (the 7B-structured, an
s-structured one reading a published-layout ``.pth`` into its shards, the
same in the int8 serving mode, the plans' PlainConvUNet), the last three
held to one process's run. Tolerances, fp32
(each gradient tensor's error is taken over its
largest entry, that scale floored at 0.1 of the model's largest gradient:
the biases in front of an InstanceNorm have a true gradient of 0 and hold
rounding noise on both sides):
- the two-rank step against the JAX train step on a 2-device mesh: the loss
  to 1e-5 relative, the whole trainable gradient to 1e-5 relative L2, each
  tensor to 2e-5 (1.1e-5 measured, on the SPM's first BatchNorm: the port's
  fp32 arithmetic against JAX's, which the one-process step shows too), the
  BatchNorm statistics to 1e-5 relative (1e-6 absolute);
- the two-rank step against the port's one-process step on the whole
  batch: the loss to 1e-6 relative, the whole gradient and each tensor to
  1e-5 -- where a stray factor of the ranks, a local batch Dice or local
  BatchNorm statistics would be off by their own size;
- the split blocks against JAX ``Block`` (the mlp block's statistics
  against its output's own): 1e-5;
- the split int8 blocks against the port's whole int8 blocks: bit for bit,
  statistics included (the int32 sums are exact and both scales are taken
  over the ranks); against the JAX int8 ``Block`` (its jnp ``QuantDense``
  layers, the unfused path): 1e-5, the same fp32 operations (XLA's erf in
  the mlp block's GELU against PyTorch's, an fp32 ulp, moves no level at
  these seeds);
- a trainer on the model axis against one process: the logged loss within
  the train-parity bound (2 %), the trained parameters to 1e-5 relative L2
  (the split only reorders fp32 sums).
"""

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinounet_tpu_torch.models.convert import state_dict_from_flax
from dinounet_tpu_torch.models.dinounet import DinoUNet as TorchDinoUNet
from dinounet_tpu_torch.models.dinounet import DinoUNetConfig as TorchConfig
from dinounet_tpu_torch.models.vit import Block as TorchBlock
from dinounet_tpu_torch.models.vit import DinoViT as TorchDinoViT
from dinounet_tpu_torch.models.vit import VIT_CONFIGS as TORCH_VIT_CONFIGS
from dinounet_tpu_torch.models.vit import ViTConfig as TorchViTConfig
from dinounet_tpu_torch.parallel import launch
from dinounet_tpu_torch.parallel.mesh import init_distributed
from dinounet_tpu_torch.parallel.sharding import ModelShard, shard_dim
from dinounet_tpu_torch.training.checkpointing import load_checkpoint
from dinounet_tpu_torch.training.losses import dc_and_ce_loss
from tests import torch_ranks
from tests.test_torch_models import CFG_KW, HW, N_CLASSES, VIT_KW, variables  # noqa: F401

BACKBONE = "encoder.dinov3_adapter.backbone."
# the narrow SwiGLU block: the 7B's structure at width 64
BLOCK_KW = dict(embed_dim=64, depth=1, num_heads=4, ffn_ratio=2.0, ffn_layer="swiglu",
                qkv_bias=False, n_storage_tokens=4)
# the narrow mlp block: the ViT-S/B/L's structure at width 64
MLP_BLOCK_KW = dict(embed_dim=64, depth=1, num_heads=4, ffn_ratio=2.0, ffn_layer="mlp",
                    qkv_bias=True, n_storage_tokens=4)
# per-tensor gradient scales are floored at this fraction of the model's
# largest gradient: the biases in front of an InstanceNorm have a true
# gradient of 0, and both sides hold rounding noise there (~1e-7 of it)
GRAD_FLOOR = 0.1


def _fill(shapes, seed: int):
    """Seeded values for a JAX variable tree (kernels of variance 1/fan_in)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['kernel']"):
            return noise / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        return 0.2 * noise

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _rope(n_prefix: int, Dh: int):
    from dinounet_tpu.models.vit import rope_sincos

    sin, cos = rope_sincos(4, 4, Dh)
    return (np.concatenate([np.zeros((n_prefix, Dh), np.float32), np.asarray(sin)]),
            np.concatenate([np.ones((n_prefix, Dh), np.float32), np.asarray(cos)]))


@pytest.fixture(scope="module")
def step_inputs():
    rng = np.random.default_rng(31)
    return (rng.standard_normal((4, 1, HW, HW)).astype(np.float32),
            rng.integers(0, N_CLASSES, (4, HW, HW)))


def _jax_block(kw: dict, seed: int):
    """The JAX ``Block`` of `kw` at width 64, seeded weights, and its output
    (its plain attention and unfused dense layers: ``DINOUNET_TPU_ATTN_IMPL
    =jax``, no statistics threaded), then its output in the int8 serving
    mode (``DINOUNET_TPU_VIT_INT8=1``: every dense layer a jnp
    ``QuantDense``)."""
    from dinounet_tpu.models.vit import Block, ViTConfig

    cfg = ViTConfig(**kw, dtype="float32")
    sin, cos = _rope(cfg.n_prefix_tokens, cfg.head_dim)
    x = np.random.default_rng(32).standard_normal((2, 21, 64)).astype(np.float32)
    block = Block(cfg)
    params = _fill(jax.eval_shape(lambda: block.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                     (sin, cos))), seed)["params"]
    outs = []
    for int8 in ("0", "1"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("DINOUNET_TPU_ATTN_IMPL", "jax")
            mp.setenv("DINOUNET_TPU_VIT_INT8", int8)
            outs.append(np.asarray(jax.jit(
                lambda p, x: block.apply({"params": p}, x, (sin, cos)))(params, jnp.asarray(x))))
    state = state_dict_from_flax({"params": {"backbone": {"block0": params}}})
    prefix = BACKBONE + "blocks.0."
    state = {k[len(prefix):]: v for k, v in state.items()}
    return state, x, (sin, cos), outs[0], outs[1]


def _off_rank(state: dict, kind: str) -> dict:
    """`state` (a narrow block's, split over two ranks) with every token's
    maximum entering a row-parallel layer in rank 0's half of its K and
    every column maximum of a row-parallel weight in rank 1's: the v rows of
    rank 0's heads and rank 0's fc1 (mlp) or w2 (SwiGLU) rows scaled up 16
    times, the last input column of proj and fc2 / w3 set to 1."""
    s = {k: v.clone() for k, v in state.items()}
    C = s["attn.proj.weight"].shape[0]
    rows = slice(2 * C, 2 * C + C // 2)  # the v rows of rank 0's heads
    s["attn.qkv.weight"][rows] *= 16
    if "attn.qkv.bias" in s:
        s["attn.qkv.bias"][rows] *= 16
    s["attn.proj.weight"][:, -1] = 1.0
    first, last = ("mlp.fc1", "mlp.fc2") if kind == "mlp" else ("mlp.w2", "mlp.w3")
    half = s[first + ".weight"].shape[0] // 2
    s[first + ".weight"][:half] *= 16
    if first + ".bias" in s:
        s[first + ".bias"][:half] *= 16
    s[last + ".weight"][:, -1] = 1.0
    return s


@pytest.fixture(scope="module")
def jax_block():
    """The SwiGLU block (the 7B's structure)."""
    return _jax_block(BLOCK_KW, 1)


@pytest.fixture(scope="module")
def jax_mlp_block():
    """The mlp block (the ViT-S/B/L's structure)."""
    return _jax_block(MLP_BLOCK_KW, 2)


def jax_mesh_step(variables, image, target):  # noqa: F811
    """The JAX train step's loss, gradients and batch statistics, the batch
    sharded over a 2-device mesh, for batch Dice off and on."""
    from dinounet_tpu.models.dinounet import DinoUNet, DinoUNetConfig
    from dinounet_tpu.models.vit import ViTConfig
    from dinounet_tpu.parallel import batch_sharding, make_mesh
    from dinounet_tpu.training.losses import dc_and_ce_loss as jax_loss

    model = DinoUNet(DinoUNetConfig(vit=ViTConfig(**VIT_KW, dtype="float32"),
                                    dtype="float32", drop_path_rate=0.0, **CFG_KW))
    mesh = make_mesh(1, jax.devices("cpu")[:2])

    @jax.jit
    def step(params, batch_stats, x, t):
        def loss_of(p, batch_dice):
            out, mut = model.apply({"params": p, "batch_stats": batch_stats}, x,
                                   train=True, mutable=["batch_stats"])
            return (jax_loss(out, t, batch_dice=batch_dice, smooth=1e-5, do_bg=False),
                    mut["batch_stats"])
        return [jax.value_and_grad(loss_of, has_aux=True)(params, bd) for bd in (False, True)]

    sharding = batch_sharding(mesh)
    with mesh:
        res = step(variables["params"], variables["batch_stats"],
                   jax.device_put(jnp.asarray(np.moveaxis(image, 1, -1)), sharding),
                   jax.device_put(jnp.asarray(target), sharding))
    return {bd: (float(loss), state_dict_from_flax({"params": grads}),
                 state_dict_from_flax({"batch_stats": stats}))
            for bd, ((loss, stats), grads) in zip((False, True), res)}


@pytest.fixture(scope="module")
def planned_set(tmp_path_factory):
    """tests/helpers.py's PNG set planned by the port (64 x 64, the plans'
    batch set to 3), the nnUNet_* variables pointing at it for the module."""
    from dinounet_tpu_torch import api
    from dinounet_tpu_torch.planning import fingerprint
    from dinounet_tpu_torch.utilities.json_export import load_json, save_json
    from tests.helpers import make_png_dataset
    from tests.test_torch_api import DATASET, DATASET_ID, TINY_KW

    root = str(tmp_path_factory.mktemp("ddp"))
    with pytest.MonkeyPatch.context() as mp:
        for sub, var in (("raw", "nnUNet_raw"), ("pre", "nnUNet_preprocessed"),
                         ("res", "nnUNet_results")):
            os.makedirs(os.path.join(root, sub))
            mp.setenv(var, os.path.join(root, sub))
        init = fingerprint.DatasetFingerprintExtractor.__init__

        def fast(self, *args, **kwargs):
            init(self, *args, **kwargs)
            self.num_foreground_voxels_for_intensitystats = 10 ** 5

        mp.setattr(fingerprint.DatasetFingerprintExtractor, "__init__", fast)
        make_png_dataset(os.path.join(root, "raw"), n_cases=6)
        api.plan_and_preprocess(DATASET_ID, **TINY_KW)
        plans_file = os.path.join(root, "pre", DATASET, "nnUNetPlans.json")
        plans = load_json(plans_file)
        plans["configurations"]["2d"]["batch_size"] = 3
        save_json(plans, plans_file, sort_keys=False)
        yield root, DATASET_ID


def _train_two_cpu_ranks(dataset_id):
    from dinounet_tpu_torch.run import run_training
    from dinounet_tpu_torch.utilities import registry

    registry.trainers.add("TinyParallelTrainer", torch_ranks.TinyParallelTrainer)
    return run_training(dataset_id, "2d", 0, "TinyParallelTrainer", num_gpus=2,
                        device="cpu")


class TinySOneProcess(torch_ranks.TinySParallelTrainer):
    """TinySParallelTrainer under its own name, for one process."""


class TinyPlainOneProcess(torch_ranks.TinyParallelTrainer):
    """TinyParallelTrainer under its own name, for one process."""


class TinySInt8OneProcess(torch_ranks.TinySParallelTrainer):
    """TinySParallelTrainer under its own name, for one process in the int8
    serving mode."""


# a trainer on the model axis -> its one-process counterpart (the int8 one
# run apart from the others, after them)
ONE_PROCESS = {"TinySParallelTrainer": TinySOneProcess,
               "TinyPlainModelAxisTrainer": TinyPlainOneProcess}
INT8_ONE_PROCESS = {"TinySInt8ParallelTrainer": TinySInt8OneProcess}


def _train_one_process(dataset_id, name: str, pretrained: str) -> dict:
    """``run_training`` of ONE_PROCESS[name] in this process (no model
    axis): its logged train losses and trained trainable parameters."""
    from dinounet_tpu_torch.run import run_training
    from dinounet_tpu_torch.utilities import registry

    cls = {**ONE_PROCESS, **INT8_ONE_PROCESS}[name]
    cls.pretrained = pretrained
    registry.trainers.add(cls.__name__, cls)
    trainer = run_training(dataset_id, "2d", 0, cls.__name__, num_gpus=1, device="cpu")
    return {"train_losses": trainer.logger.my_fantastic_logging["train_losses"],
            "trainable": {n: p.detach().clone()
                          for n, p in trainer.network.named_parameters() if p.requires_grad}}


def _published_backbone(path: str) -> str:
    """TinySParallelTrainer's backbone in the published layout (the port's
    names, a finite ``bias_mask`` 1 / 0 / 1 over q / k / v a block), seeded,
    saved to `path`."""
    vit = TorchDinoViT(TorchViTConfig(**torch_ranks.TINY_S_VIT, dtype="float32"))
    gen = torch.Generator().manual_seed(34)
    sd = {k: (0.5 * torch.randn(v.shape, generator=gen) if v.dim() < 2
              else torch.randn(v.shape, generator=gen) / v.shape[-1] ** 0.5)
          for k, v in vit.state_dict().items()}
    for i in range(torch_ranks.TINY_S_VIT["depth"]):
        sd[f"blocks.{i}.attn.qkv.bias_mask"] = torch.tensor([1.0, 0.0, 1.0]).repeat_interleave(64)
    torch.save(sd, path)
    return path


@pytest.fixture(scope="module")
def two_ranks(variables, step_inputs, jax_block, jax_mlp_block, planned_set,  # noqa: F811
              tmp_path_factory):
    """Every spawn of the module, started together while JAX compiles here:
    two gloo ranks running ``torch_ranks.parallel_checks``, the two-rank
    ``run_training`` (``torch_ranks.TinyParallelTrainer`` on the planned
    set), two ranks running ``torch_ranks.train_on_model_axis``, the two dry
    runs on four ranks each, and the one-process runs the model axis's
    trainers are held to. The payload, the ranks' results, ``jax_mesh_step``'s,
    and the other runs' results by name."""
    image, target = step_inputs
    block_state, x, rope = jax_block[:3]
    vit = TorchDinoViT(TorchViTConfig(**{**BLOCK_KW, "depth": 2}, dtype="float32"))
    gen = torch.Generator().manual_seed(33)
    vit_state = {k: torch.randn(v.shape, generator=gen) for k, v in vit.state_dict().items()}
    params = [torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2, 2))]
    opt = torch.optim.SGD(params, lr=0.1, momentum=0.99, nesterov=True)
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    directory = str(tmp_path_factory.mktemp("dcp") / "checkpoint_final.pth")
    payload = dict(
        cfg=TorchConfig(vit=TorchViTConfig(**VIT_KW, dtype="float32"), dtype="float32",
                        drop_path_rate=0.0, **CFG_KW),
        state=state_dict_from_flax(variables), image=torch.from_numpy(image),
        target=torch.from_numpy(target),
        block_cfg=TorchViTConfig(**BLOCK_KW, dtype="float32"), block_state=block_state,
        off_rank_state=_off_rank(block_state, "swiglu"),
        mlp_block_cfg=TorchViTConfig(**MLP_BLOCK_KW, dtype="float32"),
        mlp_block_state=jax_mlp_block[0],
        mlp_off_rank_state=_off_rank(jax_mlp_block[0], "mlp"),
        x=torch.from_numpy(x), rope=tuple(torch.from_numpy(t) for t in rope),
        vit_state=vit_state, optimizer_state=opt.state_dict(), directory=directory,
        pretrained=_published_backbone(str(tmp_path_factory.mktemp("pth") / "vits.pth")))
    from dinounet_tpu_torch.parallel.dryrun import dryrun_7b_block, dryrun_multichip

    pretrained = payload["pretrained"]
    with ThreadPoolExecutor(4) as pool:
        ranks = pool.submit(launch.spawn, torch_ranks.parallel_checks, 2, payload,
                            devices="cpu")
        others = {"training": pool.submit(_train_two_cpu_ranks, planned_set[1]),
                  "model_axis": pool.submit(launch.spawn, torch_ranks.train_on_model_axis, 2,
                                            {"dataset_id": planned_set[1],
                                             "pretrained": pretrained}, devices="cpu"),
                  "multichip": pool.submit(dryrun_multichip, 4),
                  "7b_block": pool.submit(dryrun_7b_block, 4)}
        others["one_process"] = pool.submit(
            lambda: {name: _train_one_process(planned_set[1], name, pretrained)
                     for name in ONE_PROCESS})
        want = jax_mesh_step(variables, image, target)
        results = {name: f.result() for name, f in others.items()}
        ranks = ranks.result()
    # the int8 trainer's one-process run, alone: the switch is the process's
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DINOUNET_TPU_VIT_INT8", "1")
        results["one_process"]["TinySInt8ParallelTrainer"] = _train_one_process(
            planned_set[1], "TinySInt8ParallelTrainer", pretrained)
    return payload, ranks, want, results


# ------------------------------------------------------------- mesh, init


def test_mesh_shapes_and_divisibility(two_ranks):
    for rank in two_ranks[1]:
        assert rank["mesh"]["meshes"] == {1: (2, 1), 2: (1, 2)}
        assert rank["mesh"]["indivisible_raises"]


def test_repeated_init_tolerated_and_conflicting_raises(two_ranks):
    assert all(rank["mesh"]["repeat_conflict_raises"] for rank in two_ranks[1])


@pytest.mark.parametrize("kwargs, env, error", [
    (dict(rank=0, world_size=2, init_method="localhost:29500"), {}, "tcp://"),
    (dict(rank=0, world_size=2, init_method="tcp://localhost:0"), {}, "tcp://"),
    (dict(rank=0, world_size=2, init_method="file://relative/store"), {}, "file:///"),
    (dict(rank=2, world_size=2, init_method="tcp://localhost:29500"), {}, "outside"),
    (dict(rank=0, world_size=2, init_method="tcp://localhost:29500"),
     {"WORLD_SIZE": "4"}, "WORLD_SIZE"),
    (dict(rank=0, world_size=2), {}, "MASTER_ADDR"),
    (dict(rank=0, world_size=2, backend="nccl", init_method="tcp://localhost:29500"),
     {}, "NCCL"),
    (dict(), {}, "rank and a world size"),
])
def test_init_distributed_misconfiguration_raises(kwargs, env, error, monkeypatch):
    """Each raises before any connection is tried (no process group is
    made): nothing degrades to one process."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: pytest.fail("init_process_group reached"))
    with pytest.raises(ValueError, match=error):
        init_distributed(device_type="cpu", **kwargs)
    assert not torch.distributed.is_initialized()


# ------------------------------------------------------------ the plan


def _jax_7b_structured_tree():
    from dinounet_tpu.models.dinounet import DinoUNet, DinoUNetConfig
    from dinounet_tpu.models.vit import ViTConfig

    cfg = DinoUNetConfig(vit=ViTConfig(**{**BLOCK_KW, "depth": 4}, dtype="float32"),
                         **{**CFG_KW, "interaction_indexes": (0, 1, 2, 3)})
    x = jnp.zeros((1, HW, HW, 1), jnp.float32)
    return jax.eval_shape(lambda: DinoUNet(cfg).init(jax.random.PRNGKey(0), x,
                                                     train=False))


def test_plan_shards_what_param_spec_tree_shards():
    """Every leaf of a tiny 7B-structured DinoUNet's JAX tree carried
    through the bridge: the port's plan splits exactly the tensors that
    ``param_spec_tree`` splits, along the same dim (each sharded leaf is
    filled with its index along the 'model' dim, so the bridge's
    transposes show where it went), and nothing trainable."""
    from dinounet_tpu.parallel import MODEL_AXIS, param_spec_tree

    shapes = _jax_7b_structured_tree()
    specs = param_spec_tree(shapes["params"])

    def mark(leaf, spec):
        dims = [d for d, axis in enumerate(spec) if axis == MODEL_AXIS]
        if not dims:
            return np.zeros(leaf.shape, np.float32)
        shape = [1] * len(leaf.shape)
        shape[dims[0]] = leaf.shape[dims[0]]
        ramp = np.arange(1, leaf.shape[dims[0]] + 1, dtype=np.float32).reshape(shape)
        return np.broadcast_to(ramp, leaf.shape).copy()

    marked = jax.tree_util.tree_map(mark, shapes["params"], specs,
                                    is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    bridged = state_dict_from_flax({"params": marked,
                                    "batch_stats": jax.tree_util.tree_map(
                                        lambda s: np.zeros(s.shape, np.float32),
                                        shapes["batch_stats"])})
    want = {}
    for name, t in bridged.items():
        varying = [d for d in range(t.dim()) if t.shape[d] > 1
                   and not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
        if t.abs().sum() > 0:
            want[name] = varying[0] if varying else 0
    port = TorchDinoUNet(TorchConfig(vit=TorchViTConfig(**{**BLOCK_KW, "depth": 4}),
                                     **{**CFG_KW, "interaction_indexes": (0, 1, 2, 3)}))
    got = {n: shard_dim(n) for n in port.state_dict() if shard_dim(n) is not None}
    assert set(port.state_dict()) == set(bridged)
    assert got == want and len(got) == 4 * 7  # qkv, proj, w1 and w2 (+ biases), w3
    trainable = {n for n, p in port.named_parameters() if p.requires_grad}
    assert not trainable & set(got)
    assert all(n.startswith(BACKBONE + "blocks.") for n in got)


def test_real_size_shard_shapes_equal_jax():
    """The ViT-7B block built as each rank's shard on ``meta``: the shapes
    JAX's specs give its shards at embed 4096, 32 heads, hidden 8192
    (``__graft_entry__.py:309-313``), transposed to (out, in)."""
    from dinounet_tpu.models.vit import VIT_CONFIGS, Block
    from dinounet_tpu.parallel import MODEL_AXIS, param_spec_tree

    n_model = 2
    jcfg = dataclasses.replace(VIT_CONFIGS["dinov3_vit7b16"], depth=1, dtype="float32")
    x = jax.ShapeDtypeStruct((1, 21, 4096), jnp.float32)
    sin = jax.ShapeDtypeStruct((21, 128), jnp.float32)
    params = jax.eval_shape(lambda x, s: Block(jcfg).init(jax.random.PRNGKey(0), x, (s, s)),
                            x, sin)["params"]
    specs = param_spec_tree({"backbone": params})["backbone"]
    want = {}
    for layer, parent in (("qkv", "attn"), ("proj", "attn"), ("w1", "mlp"), ("w2", "mlp"),
                          ("w3", "mlp")):
        shape = list(params[parent][layer]["kernel"].shape)
        for d, axis in enumerate(specs[parent][layer]["kernel"]):
            if axis == MODEL_AXIS:
                shape[d] //= n_model
        want[f"{parent}.{layer}.weight"] = tuple(reversed(shape))
    assert want["attn.qkv.weight"] == (12288 // n_model, 4096)
    tcfg = dataclasses.replace(TORCH_VIT_CONFIGS["dinov3_vit7b16"], depth=1)
    with torch.device("meta"):
        for rank in range(n_model):
            block = TorchBlock(tcfg, torch.bfloat16, ModelShard(rank, n_model))
            held = {k: tuple(v.shape) for k, v in block.state_dict().items()}
            assert {k: held[k] for k in want} == want


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("model", ["dinov3_vits16", "dinov3_vitb16", "dinov3_vitl16"])
def test_real_size_mlp_shard_shapes_equal_jax(model, rank):
    """``shard_state_dict`` on the ViT-S/B/L's whole state dict (built on
    ``meta``): each block tensor's shard has the shape JAX's
    ``param_spec_tree`` gives it at full size (the kernels transposed to
    (out, in)), and the shapes a block built as the rank's shard holds;
    nothing outside the blocks' dense layers is split."""
    from dinounet_tpu.models.vit import VIT_CONFIGS, Block
    from dinounet_tpu.parallel import MODEL_AXIS, param_spec_tree
    from dinounet_tpu_torch.parallel.sharding import shard_state_dict

    n_model = 2
    jcfg = dataclasses.replace(VIT_CONFIGS[model], depth=1, dtype="float32")
    C, Dh = jcfg.embed_dim, jcfg.embed_dim // jcfg.num_heads
    x = jax.ShapeDtypeStruct((1, 21, C), jnp.float32)
    sin = jax.ShapeDtypeStruct((21, Dh), jnp.float32)
    params = jax.eval_shape(lambda x, s: Block(jcfg).init(jax.random.PRNGKey(0), x, (s, s)),
                            x, sin)["params"]
    specs = param_spec_tree({"backbone": params})["backbone"]
    want = {}
    for parent, layer in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")):
        for kind, torch_kind in (("kernel", "weight"), ("bias", "bias")):
            shape = list(params[parent][layer][kind].shape)
            for d, axis in enumerate(specs[parent][layer][kind]):
                if axis == MODEL_AXIS:
                    shape[d] //= n_model
            want[f"blocks.0.{parent}.{layer}.{torch_kind}"] = tuple(reversed(shape))
    assert want["blocks.0.mlp.fc1.weight"] == (4 * C // n_model, C)
    assert want["blocks.0.mlp.fc2.bias"] == (C,)
    tcfg = dataclasses.replace(TORCH_VIT_CONFIGS[model], depth=1)
    with torch.device("meta"):
        whole = TorchDinoViT(tcfg, torch.bfloat16).state_dict()
        block = TorchBlock(tcfg, torch.bfloat16, ModelShard(rank, n_model)).state_dict()
    mine = shard_state_dict(whole, rank, n_model)
    got = {k: tuple(v.shape) for k, v in mine.items()}
    assert {k: got[k] for k in want} == want
    assert {"blocks.0." + k: tuple(v.shape) for k, v in block.items()} == {
        k: v for k, v in got.items() if k.startswith("blocks.0.")}
    assert all(got[k] == tuple(whole[k].shape) for k in got if k not in want)


# ------------------------------------------------------ the data-parallel step


def _grad_errors(got: dict, want: dict) -> dict:
    """Each trainable tensor's largest difference over its largest entry,
    floored at GRAD_FLOOR of the model's largest gradient; under "all", the
    relative L2 of the whole trainable gradient."""
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in want.values())
    out = {n: float((got[n] - want[n]).abs().max())
           / max(float(want[n].abs().max()), floor) for n in got}
    flat = [torch.cat([d[n].flatten() for n in sorted(got)]) for d in (got, want)]
    out["all"] = float((flat[0] - flat[1]).norm() / flat[1].norm())
    return out


def _worst(errors: dict) -> list:
    return sorted(errors.items(), key=lambda kv: -kv[1])[:5]


@pytest.mark.parametrize("batch_dice", [False, True])
def test_two_rank_step_matches_jax_mesh_step(two_ranks, batch_dice):
    ranks = [r["ddp"][batch_dice] for r in two_ranks[1]]
    want_loss, want_grads, want_stats = two_ranks[2][batch_dice]
    # each rank's loss is its share: their mean is the global batch's loss
    loss = np.mean([r["loss"] for r in ranks])
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for name, g in ranks[0]["grads"].items():
        assert torch.equal(g, ranks[1]["grads"][name]), name
    grads = ranks[0]["grads"]
    assert not any(n.startswith(BACKBONE) for n in grads) and len(grads) > 100
    errors = _grad_errors(grads, {n: want_grads[n] for n in grads})
    assert errors.pop("all") <= 1e-5
    assert max(errors.values()) <= 2e-5, _worst(errors)
    assert len(ranks[0]["stats"]) > 10
    for name, got in ranks[0]["stats"].items():
        assert torch.equal(ranks[1]["stats"][name], got), name
        np.testing.assert_allclose(got.numpy(), want_stats[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("batch_dice", [False, True])
def test_two_rank_step_matches_one_process(two_ranks, batch_dice):
    """The port's step on the whole batch in this process, against the two
    ranks' halves: a stray factor of the ranks, a local batch Dice or local
    BatchNorm statistics would be off by their own size."""
    payload, ranks = two_ranks[0], [r["ddp"][batch_dice] for r in two_ranks[1]]
    model = TorchDinoUNet(payload["cfg"])
    model.load_state_dict(payload["state"], strict=True)
    model.train()
    loss = dc_and_ce_loss(model(payload["image"]), payload["target"],
                          batch_dice=batch_dice, smooth=1e-5, do_bg=False)
    loss.backward()
    assert np.mean([r["loss"] for r in ranks]) == pytest.approx(float(loss.detach()),
                                                                rel=1e-6)
    want = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert set(ranks[0]["grads"]) == set(want)
    errors = _grad_errors(ranks[0]["grads"], want)
    assert errors.pop("all") <= 1e-5
    assert max(errors.values()) <= 1e-5, _worst(errors)
    buffers = dict(model.named_buffers())
    for name, got in ranks[0]["stats"].items():
        torch.testing.assert_close(got, buffers[name], rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ the model axis


def test_split_block_matches_jax_block(two_ranks, jax_block):
    want = jax_block[3]
    for rank in two_ranks[1]:
        np.testing.assert_allclose(rank["block"].numpy(), want, rtol=1e-5, atol=1e-5)


def test_sharded_checkpoint_round_trip(two_ranks):
    """Written by two ranks, read back onto their shards, and into this
    process as whole tensors (the qkv weight back at (3C, C))."""
    payload, ranks = two_ranks[:2]
    for rank in ranks:
        assert rank["dcp"]["equal"] and rank["dcp"]["optimizer_equal"]
        assert rank["dcp"]["meta"] == (3, "DinoUNetTrainer_7b", {"train_losses": [0.5]})
        assert rank["dcp"]["sharded"] == ["blocks.0.attn.qkv.weight",
                                          "blocks.1.attn.qkv.weight"]
    back = load_checkpoint(payload["directory"])
    assert back["network_weights"].keys() == payload["vit_state"].keys()
    for name, t in payload["vit_state"].items():
        assert torch.equal(back["network_weights"][name], t), name
    opt = back["optimizer_state"]
    assert opt["param_groups"] == payload["optimizer_state"]["param_groups"]
    for i, entry in payload["optimizer_state"]["state"].items():
        assert torch.equal(opt["state"][i]["momentum_buffer"], entry["momentum_buffer"])
    assert back["current_epoch"] == 3


# --------------------------------------------------------- dry runs


def test_dryrun_multichip_four_ranks(two_ranks):
    losses = two_ranks[3]["multichip"]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    assert losses[0] == losses[1] and losses[2] == losses[3]  # one batch a model group


def test_dryrun_7b_block_four_ranks(two_ranks):
    assert max(two_ranks[3]["7b_block"]) <= 1e-5


# ------------------------------------------------------ training, prediction


def test_run_training_on_two_cpu_ranks(planned_set, two_ranks, tmp_path):
    """``run_training(num_gpus=2, device="cpu")``: the ranks train the
    global batch of 4 (the plans' 3 rounded up to the data axis), rank 0
    alone writes the log and checkpoint, the validation's two cases are
    split over the ranks, and rank 0's summary.json has both: the files
    one process's final validation writes from checkpoint_final."""
    from dinounet_tpu_torch.run import get_trainer_from_args

    result = two_ranks[3]["training"]
    folder = result.output_folder
    assert folder.endswith(os.path.join("TinyParallelTrainer__nnUNetPlans__2d", "fold_0"))
    log = result.logger.my_fantastic_logging
    assert len(log["train_losses"]) == 1 and np.isfinite(log["train_losses"][0])
    assert os.path.isfile(os.path.join(folder, "checkpoint_final.pth"))
    logs = [f for f in os.listdir(folder) if f.startswith("training_log_")]
    assert len(logs) == 1
    with open(os.path.join(folder, logs[0])) as f:
        text = f.read()
    assert text.count("Training done.") == 1
    assert "rank 0 of 2 (data axis 2, model axis 1)" in text
    with open(os.path.join(folder, "validation", "summary.json")) as f:
        summary = json.load(f)
    cases = sorted(os.path.basename(c["prediction_file"]) for c in summary["metric_per_case"])
    assert cases == sorted(f for f in os.listdir(os.path.join(folder, "validation"))
                           if f.endswith(".png")) and len(cases) == 2
    checkpoint = load_checkpoint(os.path.join(folder, "checkpoint_final.pth"))
    assert not any(k.startswith("module.") for k in checkpoint["network_weights"])
    validation = os.path.join(folder, "validation")
    by_ranks = {f: open(os.path.join(validation, f), "rb").read()
                for f in os.listdir(validation)}
    one = get_trainer_from_args(planned_set[1], "2d", 0, "TinyParallelTrainer", device="cpu")
    one.load_checkpoint(checkpoint)
    threads = torch.get_num_threads()
    torch.set_num_threads(launch.cpu_threads(2))  # the ranks' sums, in their order
    try:
        one.perform_actual_validation()
    finally:
        torch.set_num_threads(threads)
    assert {f: open(os.path.join(validation, f), "rb").read()
            for f in os.listdir(validation)} == by_ranks


def test_split_mlp_block_matches_jax_block(two_ranks, jax_mlp_block):
    """The mlp block split over two ranks (its heads, fc1's columns, the
    row-parallel proj / fc2 and the post-reduce pass) against the JAX mlp
    block unsplit, fp32: the output, and the statistics it hands the next
    LayerNorm against the output's own."""
    want = jax_mlp_block[3]
    for rank in two_ranks[1]:
        out, (mu, var) = rank["mlp_block"]
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(mu.numpy(), want.mean(-1), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(var.numpy(), want.var(-1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("state", ["block_state", "off_rank_state"])
@pytest.mark.parametrize("kind", ["mlp", "swiglu"])
def test_split_int8_block_equals_whole_int8_block(two_ranks, kind, state):
    """``DINOUNET_TPU_VIT_INT8=1`` on a model axis of 2: the split mlp block
    (#13 and #10 on the rank's rows, #12's and #11's row-parallel modes, the
    int8 post-reduce pass) and the split SwiGLU block (``QuantDense`` column-
    and row-parallel) equal the port's whole int8 blocks bit for bit, the
    mlp block's statistics included, on the JAX blocks' weights and on the
    off-rank weights."""
    for rank in two_ranks[1]:
        got = rank["int8"][kind, state]
        split, whole = got["split"], got["whole"]
        if kind == "mlp":
            (split, (mu, var)), (whole, (mu_w, var_w)) = split, whole
            assert torch.equal(mu, mu_w) and torch.equal(var, var_w)
        assert split.dtype == torch.float32 and torch.equal(split, whole)


@pytest.mark.parametrize("kind", ["mlp", "swiglu"])
def test_split_int8_block_matches_jax_int8_block(two_ranks, jax_block, jax_mlp_block, kind):
    """The split int8 blocks against the JAX blocks with
    ``DINOUNET_TPU_VIT_INT8=1`` (jnp ``QuantDense`` layers), fp32: 1e-5; the
    int8 mode moved the output off the float block's."""
    want, float_out = (jax_mlp_block if kind == "mlp" else jax_block)[4:2:-1]
    for rank in two_ranks[1]:
        out = rank["int8"][kind, "block_state"]["split"]
        out = out[0] if kind == "mlp" else out
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
        assert not np.allclose(out.numpy(), float_out, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["mlp", "swiglu"])
def test_int8_scales_are_taken_over_the_model_axis(two_ranks, kind):
    """On the off-rank weights each row-parallel layer's maxima lie off a
    rank: rank 1's per-token activation maxima are all below the
    all-reduced ones (every token's lies in rank 0's half), rank 0's weight
    column maxima all below theirs (every column's lies in rank 1's half);
    each of the two row-parallel layers reduced one of each. A rank-local
    scale would differ from the whole block's there, which
    test_split_int8_block_equals_whole_int8_block holds to bit equality."""
    for r, rank in enumerate(two_ranks[1]):
        maxima = rank["int8"][kind, "off_rank_state"]["maxima"]
        assert sorted(k for k, _, _ in maxima) == ["activation"] * 2 + ["weight"] * 2
        for what, local, reduced in maxima:
            assert torch.all(local <= reduced)
            if (what, r) in (("activation", 1), ("weight", 0)):
                assert torch.all(local < reduced), (what, r)


def test_run_training_on_a_model_axis(two_ranks):
    """``DinoUNetTrainer_7b``'s build (a 7B-structured DinoUNet at width 64)
    on two CPU ranks with ``DINOUNET_TPU_MODEL_AXIS=2``: each rank holds
    its shards, checkpoint_final is a sharded checkpoint's directory that
    a fresh trainer reads back onto its shards, and that reads into one
    process as the whole network's state; the final validation predicted
    both cases (the model group together)."""
    ranks = [r["Tiny7bParallelTrainer"] for r in two_ranks[3]["model_axis"]]
    folder = ranks[0]["output_folder"]
    qkv = "encoder.dinov3_adapter.backbone.blocks.0.attn.qkv.weight"
    for rank in ranks:
        assert rank["resumed_equal"] and rank["epoch"] == 1
        assert rank["shards"][qkv] == (3 * 64 // 2, 64)
    final = os.path.join(folder, "checkpoint_final.pth")
    assert os.path.isdir(final) and os.path.isfile(os.path.join(final, "meta.pth"))
    whole = torch_ranks.Tiny7bParallelTrainer.build_network_architecture(
        None, {}, [], 1, 3, False)
    whole.load_state_dict(load_checkpoint(final)["network_weights"])
    assert tuple(whole.state_dict()[qkv].shape) == (3 * 64, 64)
    with open(os.path.join(folder, "validation", "summary.json")) as f:
        assert len(json.load(f)["metric_per_case"]) == 2
    texts = []
    for name in os.listdir(folder):  # the training's and the fresh trainer's
        if name.startswith("training_log_"):
            with open(os.path.join(folder, name)) as f:
                texts.append(f.read())
    assert len(texts) == 2 and sum(t.count("Training done.") for t in texts) == 1
    assert all("rank 0 of 2 (data axis 1, model axis 2)" in t for t in texts)


# the train-parity bound on the loss (chip_smoke.py's TRAIN_LOSS_BOUND)
TRAIN_LOSS_BOUND = 0.02


def test_int8_trainer_on_a_model_axis_matches_one_process(two_ranks):
    """``DinoUNetTrainer_s``'s build (TinySParallelTrainer) in the int8
    serving mode on two CPU ranks with ``DINOUNET_TPU_MODEL_AXIS=2``: it
    builds, steps and validates; its loss is one int8 process's within the
    train-parity bound and its trained parameters one process's to 1e-5
    relative L2 (the split int8 backbone is the whole one's bit for bit);
    the int8 mode moved the loss off the bf16-arithmetic run's."""
    name = "TinySInt8ParallelTrainer"
    ranks = [r[name] for r in two_ranks[3]["model_axis"]]
    one = two_ranks[3]["one_process"][name]
    float_losses = two_ranks[3]["model_axis"][0]["TinySParallelTrainer"]["train_losses"]
    for rank in ranks:
        assert rank["resumed_equal"] and rank["epoch"] == 1
        assert rank["train_losses"][0] == pytest.approx(one["train_losses"][0],
                                                        rel=TRAIN_LOSS_BOUND)
        assert rank["train_losses"] != float_losses
        flat = [torch.cat([d[k].flatten() for k in sorted(d)])
                for d in (rank["trainable"], one["trainable"])]
        assert float((flat[0] - flat[1]).norm() / flat[1].norm()) <= 1e-5
    with open(os.path.join(ranks[0]["output_folder"], "validation", "summary.json")) as f:
        assert len(json.load(f)["metric_per_case"]) == 2


@pytest.mark.parametrize("name", ["TinySParallelTrainer", "TinyPlainModelAxisTrainer"])
def test_trainer_on_a_model_axis_matches_one_process(two_ranks, tmp_path, name):
    """``DinoUNetTrainer_s``'s build (an mlp DinoUNet of the ViT-S's
    structure at width 64, its backbone read from a published-layout
    ``.pth`` into each rank's shards) and the plans' ``PlainConvUNet``, each
    on two CPU ranks with ``DINOUNET_TPU_MODEL_AXIS=2``: each rank holds its
    shards (the plain network whole); its two steps' loss is one process's
    within the train-parity bound, and the trained parameters are one
    process's (fp32: the row-parallel sums only reorder); the sharded
    checkpoint_final reads back onto the shards and into one process as
    the whole network, its backbone the file's."""
    from dinounet_tpu_torch.models.convert import backbone_state_dict_from_dinov3

    ranks = [r[name] for r in two_ranks[3]["model_axis"]]
    one = two_ranks[3]["one_process"][name]
    for rank in ranks:
        assert rank["resumed_equal"] and rank["epoch"] == 1
        assert len(rank["train_losses"]) == 1
        assert rank["train_losses"][0] == pytest.approx(one["train_losses"][0],
                                                        rel=TRAIN_LOSS_BOUND)
        assert rank["trainable"].keys() == one["trainable"].keys()
        flat = [torch.cat([d[k].flatten() for k in sorted(d)])
                for d in (rank["trainable"], one["trainable"])]
        assert float((flat[0] - flat[1]).norm() / flat[1].norm()) <= 1e-5
    folder = ranks[0]["output_folder"]
    final = load_checkpoint(os.path.join(folder, "checkpoint_final.pth"))["network_weights"]
    if name == "TinyPlainModelAxisTrainer":
        assert ranks[0]["shards"] == {k: tuple(v.shape) for k, v in final.items()}
        return
    prefix = BACKBONE + "blocks.0."
    assert {k: ranks[0]["shards"][prefix + k] for k in (
        "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias",
        "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")} == {
        "attn.qkv.weight": (96, 64), "attn.qkv.bias": (96,), "attn.proj.weight": (64, 32),
        "attn.proj.bias": (64,), "mlp.fc1.weight": (64, 64), "mlp.fc1.bias": (64,),
        "mlp.fc2.weight": (64, 64), "mlp.fc2.bias": (64,)}
    assert all(rank["pretrained_equal"] for rank in ranks)
    whole = torch_ranks.TinySParallelTrainer.build_network_architecture(None, {}, [], 1, 3,
                                                                         False)
    whole.load_state_dict(final)
    file = backbone_state_dict_from_dinov3(
        torch.load(two_ranks[0]["pretrained"], weights_only=True),
        TorchViTConfig(**torch_ranks.TINY_S_VIT))
    backbone = whole.encoder.dinov3_adapter.backbone.state_dict()
    assert all(torch.equal(backbone[k], v) for k, v in file.items())
    for n, t in ranks[0]["trainable"].items():
        assert torch.equal(final[n], t), n


def test_more_gpus_than_visible_raise():
    from dinounet_tpu_torch.run import run_training

    with pytest.raises(ValueError, match="visible CUDA"):
        run_training(501, "2d", 0, num_gpus=torch.cuda.device_count() + 2, device="cuda")


def test_predictor_parts_match_jax_and_one_run(planned_set, two_ranks, tmp_path):
    """Each part's cases are the JAX predictor's striding of the same list,
    and the parts' files together are one run's."""
    from dinounet_tpu.inference.predictor import nnUNetPredictor as JaxPredictor

    from dinounet_tpu_torch.inference.predictor import nnUNetPredictor

    root, result = planned_set[0], two_ranks[3]["training"]
    images = os.path.join(root, "raw", "Dataset501_Toy2d", "imagesTr")
    model_folder = os.path.dirname(result.output_folder)

    def predictor(cls, **kw):
        p = cls(use_mirroring=False, **kw)
        p.dataset_json = {"file_ending": ".png"}
        return p

    jax_p, port_p = predictor(JaxPredictor), predictor(nnUNetPredictor, device="cpu")
    for n in (1, 2, 4):
        for k in range(n):
            want = jax_p._manage_input_and_output_lists(images, "out", part_id=k,
                                                        num_parts=n)
            got = port_p._manage_input_and_output_lists(images, "out", part_id=k,
                                                        num_parts=n)
            assert [list(x) if x is not None else None for x in got] == \
                [list(x) if x is not None else None for x in want]
    with pytest.raises(ValueError, match="part"):
        port_p._manage_input_and_output_lists(images, "out", part_id=2, num_parts=2)

    port_p.initialize_from_trained_model_folder(model_folder, (0,))
    port_p.predict_from_files(images, str(tmp_path / "whole"), num_processes_preprocessing=1,
                              num_processes_segmentation_export=1)
    for k in range(2):
        port_p.predict_from_files(images, str(tmp_path / "parts"), num_parts=2, part_id=k,
                                  num_processes_preprocessing=1,
                                  num_processes_segmentation_export=1)
    whole = sorted(f for f in os.listdir(tmp_path / "whole") if f.endswith(".png"))
    assert len(whole) == 6
    assert whole == sorted(f for f in os.listdir(tmp_path / "parts") if f.endswith(".png"))
    for f in whole:
        assert (tmp_path / "whole" / f).read_bytes() == (tmp_path / "parts" / f).read_bytes()
