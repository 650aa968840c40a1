"""Rank bodies for tests/test_torch_parallel.py, run in processes that
``dinounet_tpu_torch.parallel.launch.spawn`` starts (gloo on the CPU).

This module imports no JAX: a spawned rank imports it afresh, and the JAX
side of every comparison is computed in the parent pytest process, which
hands each rank the same numpy-made tensors.
"""

import os

import torch
import torch.distributed as dist

from dinounet_tpu_torch.models import vit as vit_module
from dinounet_tpu_torch.models.dinounet import DinoUNet, DinoUNetConfig
from dinounet_tpu_torch.models.vit import Block, ViTConfig
from dinounet_tpu_torch.ops import dense_q8 as dense_q8_module
from dinounet_tpu_torch.parallel.mesh import (MODEL_AXIS, init_distributed, make_mesh,
                                              wrap_data_parallel)
from dinounet_tpu_torch.parallel.sharding import (ModelShard, dcp_state_dict,
                                                  shard_state_dict)
from dinounet_tpu_torch.training.checkpointing import (CHECKPOINT_KEYS, load_checkpoint,
                                                       save_checkpoint)
from dinounet_tpu_torch.training.dinounet_trainer import DinoUNetTrainer_7b, DinoUNetTrainer_s
from dinounet_tpu_torch.training.losses import dc_and_ce_loss
from dinounet_tpu_torch.training.trainer import nnUNetTrainer


def _raises(exc, fn, *args, **kwargs) -> bool:
    try:
        fn(*args, **kwargs)
    except exc:
        return True
    return False


def mesh_checks() -> dict:
    """The repeated and the conflicting initialisation, and the meshes."""
    rank, world = dist.get_rank(), dist.get_world_size()
    init_distributed(rank, world, "gloo", device_type="cpu")  # tolerated
    meshes = {n: tuple(make_mesh(n, "cpu").mesh.shape) for n in (1, world)}
    return {"repeat_conflict_raises": _raises(RuntimeError, init_distributed, rank, world,
                                              "nccl", device_type="cpu"),
            "indivisible_raises": _raises(ValueError, make_mesh, world + 1, "cpu"),
            "meshes": meshes}


def ddp_steps(device, payload: dict) -> dict:
    """One train-mode step of the tiny DinoUNet a batch-Dice setting, each
    rank on its half of the batch through the trainer's data-parallel
    wrapper: the rank's loss share, the trainable gradients and the updated
    BatchNorm statistics."""
    mesh = make_mesh(1, "cpu")
    data_group = mesh.get_group("data")
    rank, world = dist.get_rank(), dist.get_world_size()
    local = payload["image"].shape[0] // world
    part = slice(rank * local, (rank + 1) * local)
    out = {}
    for batch_dice in (False, True):
        model = DinoUNet(payload["cfg"])
        model.load_state_dict(payload["state"], strict=True)
        model.train()
        ddp = wrap_data_parallel(model, data_group, device)
        loss = dc_and_ce_loss(ddp(payload["image"][part]), payload["target"][part],
                              batch_dice=batch_dice, smooth=1e-5, do_bg=False,
                              reduce_group=data_group)
        loss.backward()
        out[batch_dice] = {
            "loss": float(loss.detach()),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "stats": {n: b.clone() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))}}
    return out


def sharded_block(payload: dict, prefix: str = "", state: str = "block_state",
                  whole: bool = False):
    """The narrow SwiGLU block (or, with `prefix` "mlp_", the narrow mlp
    block) built as this rank's shard of a model axis over every rank, fed
    the full block's weights (``payload[prefix + state]``) through
    ``shard_state_dict``, or with `whole` built and fed whole: its output
    (the whole (B, N, C); the mlp block's with the next LayerNorm's
    statistics)."""
    shard = None
    full = payload[prefix + state]
    if not whole:
        mesh = make_mesh(dist.get_world_size(), "cpu")
        shard = ModelShard(dist.get_rank(), dist.get_world_size(), mesh.get_group(MODEL_AXIS))
        full = shard_state_dict(full, shard.rank, shard.size)
    block = Block(payload[prefix + "block_cfg"], torch.float32, shard)
    block.load_state_dict(full)
    with torch.no_grad():
        return block(payload["x"], payload["rope"])


def int8_blocks(payload: dict) -> dict:
    """The narrow mlp and SwiGLU blocks in the int8 serving mode, split over
    the model axis and whole on this rank, on the JAX blocks' weights
    ("state") and on the off-rank weights ("off_rank": every token's maximum
    entering a row-parallel layer in rank 0's half of its K, every column
    maximum of its weight in rank 1's). By kind and weights: the split and
    the whole outputs, and the split's maxima as (local, all-reduced) pairs,
    "activation" or "weight" (each row-parallel layer's, in call order)."""
    calls = []

    def recording(t, group):
        out = reduce_max(t, group)
        calls.append(("weight" if t.dim() == 2 else "activation", t.clone(), out.clone()))
        return out

    reduce_max = dense_q8_module.all_reduce_max
    os.environ["DINOUNET_TPU_VIT_INT8"] = "1"
    dense_q8_module.all_reduce_max = vit_module.all_reduce_max = recording
    try:
        out = {}
        for kind, prefix in (("mlp", "mlp_"), ("swiglu", "")):
            for state in ("block_state", "off_rank_state"):
                calls.clear()
                split = sharded_block(payload, prefix, state)
                out[kind, state] = {"split": split, "maxima": list(calls),
                                    "whole": sharded_block(payload, prefix, state, whole=True)}
        return out
    finally:
        dense_q8_module.all_reduce_max = vit_module.all_reduce_max = reduce_max
        del os.environ["DINOUNET_TPU_VIT_INT8"]


def dcp_round_trip(payload: dict) -> dict:
    """A narrow 7B-structured backbone's shards and an optimizer state
    written as a sharded checkpoint, then read back onto zeroed shards on
    the same ranks."""
    n = dist.get_world_size()
    mesh = make_mesh(n, "cpu")
    rank = dist.get_rank()
    full = payload["vit_state"]
    mine = shard_state_dict(full, rank, n)
    weights, views = dcp_state_dict(mine, mesh, n)
    checkpoint = dict.fromkeys(CHECKPOINT_KEYS)
    checkpoint.update(network_weights=weights, optimizer_state=payload["optimizer_state"],
                      current_epoch=3, trainer_name="DinoUNetTrainer_7b",
                      logging={"train_losses": [0.5]})
    save_checkpoint(checkpoint, payload["directory"], sharded_views=views)
    fresh = {k: torch.zeros_like(v) for k, v in mine.items()}
    template, _ = dcp_state_dict(fresh, mesh, n)
    back = load_checkpoint(payload["directory"], network_template=template)
    opt = back["optimizer_state"]
    return {"equal": all(torch.equal(fresh[k], mine[k]) for k in mine),
            "sharded": sorted(views),
            "meta": (back["current_epoch"], back["trainer_name"], back["logging"]),
            "optimizer_equal": opt["param_groups"] == payload["optimizer_state"]["param_groups"]
            and all(torch.equal(opt["state"][i]["momentum_buffer"], e["momentum_buffer"])
                    for i, e in payload["optimizer_state"]["state"].items())}


def parallel_checks(device, payload: dict) -> dict:
    """Everything the test file holds on two ranks, in one spawn."""
    torch.set_num_threads(1)
    return {"mesh": mesh_checks(), "ddp": ddp_steps(device, payload),
            "block": sharded_block(payload), "mlp_block": sharded_block(payload, "mlp_"),
            "int8": int8_blocks(payload), "dcp": dcp_round_trip(payload)}


class TinyParallelTrainer(nnUNetTrainer):
    """The plans' plain network (deep supervision on), 1 epoch of 2 steps
    and 1 validation batch: ``run_training(num_gpus=2, device="cpu")``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.seed = 0
        self.num_epochs = 1
        self.num_iterations_per_epoch = 2
        self.num_val_iterations_per_epoch = 1



class Tiny7bParallelTrainer(DinoUNetTrainer_7b):
    """DinoUNetTrainer_7b's build over a depth-4 SwiGLU DinoUNet of the 7B's
    structure at width 64, 1 epoch of 2 steps and 1 validation batch."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.seed = 0
        self.num_epochs = 1
        self.num_iterations_per_epoch = 2
        self.num_val_iterations_per_epoch = 1

    @classmethod
    def build_network_architecture(cls, architecture_class_name, arch_init_kwargs,
                                   arch_init_kwargs_req_import, num_input_channels,
                                   num_output_channels, enable_deep_supervision=True,
                                   shard=None):
        vit = ViTConfig(embed_dim=64, depth=4, num_heads=4, ffn_ratio=2.0,
                        ffn_layer="swiglu", qkv_bias=False)
        cfg = DinoUNetConfig(vit=vit, interaction_indexes=(0, 1, 2, 3),
                             num_classes=num_output_channels,
                             features_per_stage=(8, 16, 32, 64), fapm_rank=8, conv_inplane=8,
                             deform_num_heads=2, deep_supervision=enable_deep_supervision)
        return DinoUNet(cfg, shard=shard)


# the narrow ViT-S-structured backbone of TinySParallelTrainer
TINY_S_VIT = dict(embed_dim=64, depth=4, num_heads=4, ffn_ratio=2.0, ffn_layer="mlp",
                  qkv_bias=True)


class TinySParallelTrainer(DinoUNetTrainer_s):
    """DinoUNetTrainer_s's build and pretrained load over a depth-4 mlp
    DinoUNet of the ViT-S's structure at width 64 (4 heads, hidden 128),
    1 epoch of 2 steps and 1 validation batch; the backbone read from
    ``pretrained`` (a published-layout ``.pth``) where a caller sets it."""
    pretrained = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.seed = 0
        self.num_epochs = 1
        self.num_iterations_per_epoch = 2
        self.num_val_iterations_per_epoch = 1
        self._dinov3_pretrained_path = type(self).pretrained

    @classmethod
    def build_network_architecture(cls, architecture_class_name, arch_init_kwargs,
                                   arch_init_kwargs_req_import, num_input_channels,
                                   num_output_channels, enable_deep_supervision=True,
                                   shard=None):
        cfg = DinoUNetConfig(vit=ViTConfig(**TINY_S_VIT), interaction_indexes=(0, 1, 2, 3),
                             num_classes=num_output_channels,
                             features_per_stage=(8, 16, 32, 64), fapm_rank=8, conv_inplane=8,
                             deform_num_heads=2, deep_supervision=enable_deep_supervision)
        return DinoUNet(cfg, shard=shard)



class TinyPlainModelAxisTrainer(TinyParallelTrainer):
    """TinyParallelTrainer (the plans' PlainConvUNet) under its own name."""


class TinySInt8ParallelTrainer(TinySParallelTrainer):
    """TinySParallelTrainer under its own name, run in the int8 serving mode
    (``DINOUNET_TPU_VIT_INT8=1``: the frozen backbone's projections w8a8)."""


MODEL_AXIS_TRAINERS = {"Tiny7bParallelTrainer": Tiny7bParallelTrainer,
                       "TinySParallelTrainer": TinySParallelTrainer,
                       "TinyPlainModelAxisTrainer": TinyPlainModelAxisTrainer,
                       "TinySInt8ParallelTrainer": TinySInt8ParallelTrainer}
# the trainers run with DINOUNET_TPU_VIT_INT8=1
INT8_TRAINERS = ("TinySInt8ParallelTrainer",)


def train_on_model_axis(device, args: dict) -> dict:
    """``run_training`` of each of MODEL_AXIS_TRAINERS in this rank's process
    group with ``DINOUNET_TPU_MODEL_AXIS=2`` (TinySParallelTrainer's
    backbone read from ``args["pretrained"]``; INT8_TRAINERS in the int8
    serving mode, their validation too); then a fresh trainer reads
    each sharded checkpoint_final back onto its shards. By trainer name: the
    output folder, the epoch read back, the shapes the rank holds, whether
    the read-back network equals the trained one, the logged train losses
    and the trainable parameters (the whole ones: nothing trainable is
    split); for TinySParallelTrainer also whether the backbone's shards
    were the file's before training."""
    from dinounet_tpu_torch.models.convert import backbone_state_dict_from_dinov3
    from dinounet_tpu_torch.run import get_trainer_from_args, run_training
    from dinounet_tpu_torch.utilities import registry

    os.environ["DINOUNET_TPU_MODEL_AXIS"] = "2"
    torch.set_num_threads(2)
    TinySParallelTrainer.pretrained = args["pretrained"]
    out = {}
    for name, cls in MODEL_AXIS_TRAINERS.items():
        registry.trainers.add(name, cls)
        if name in INT8_TRAINERS:
            os.environ["DINOUNET_TPU_VIT_INT8"] = "1"
        try:
            trainer = run_training(args["dataset_id"], "2d", 0, name, num_gpus=2,
                                   device=device)
        finally:
            os.environ.pop("DINOUNET_TPU_VIT_INT8", None)
        final = os.path.join(trainer.output_folder, "checkpoint_final.pth")
        fresh = get_trainer_from_args(args["dataset_id"], "2d", 0, name, device=device)
        fresh.load_checkpoint(final)
        trained = trainer.network.state_dict()
        out[name] = {
            "output_folder": trainer.output_folder, "epoch": fresh.current_epoch,
            "shards": {k: tuple(v.shape) for k, v in trained.items()},
            "resumed_equal": all(torch.equal(v, trained[k])
                                 for k, v in fresh.network.state_dict().items()),
            "train_losses": trainer.logger.my_fantastic_logging["train_losses"],
            "trainable": {n: p.detach().clone()
                          for n, p in trainer.network.named_parameters() if p.requires_grad}}
        if name == "TinySParallelTrainer":
            # a trainer set up afresh holds the file's shards (the trained
            # one's backbone is frozen, so equal to them too)
            shard = trainer.model_shard
            want = shard_state_dict(backbone_state_dict_from_dinov3(
                torch.load(args["pretrained"], weights_only=True), ViTConfig(**TINY_S_VIT)),
                shard.rank, shard.size)
            backbone = trainer.network.encoder.dinov3_adapter.backbone.state_dict()
            out[name]["pretrained_equal"] = (set(backbone) == set(want) and all(
                torch.equal(backbone[k], want[k].to(backbone[k].dtype)) for k in want))
    return out


def jax_orbax_shards(device, payload: dict) -> dict:
    """A DinoUNetTrainer on a model axis of 2 (this rank's process group)
    resuming from the JAX package's orbax directory ``payload["path"]`` with
    the injected ``payload["spec"]`` network: whether its network equals
    this rank's slices of the whole read (``load_jax_checkpoint`` without a
    template, split by ``shard_state_dict``), its momentum the whole read's,
    and, by state-dict name, the elements it asked the zarr arrays for
    beside the elements it holds."""
    from dinounet_tpu_torch.compression import zarr2
    from dinounet_tpu_torch.training.dinounet_trainer import DinoUNetTrainer
    from dinounet_tpu_torch.training.jax_checkpoint import load_jax_checkpoint
    from tests.fixture_network import injected_network

    torch.set_num_threads(1)
    os.environ.update(payload["env"])
    os.environ["DINOUNET_TPU_MODEL_AXIS"] = "2"
    requested = {}
    read_region = zarr2.ZarrArray.read_region

    def recording(self, index):
        n = 1
        for s, size in zip(index, self.shape):
            start, stop, _ = s.indices(size)
            n *= stop - start
        requested[self.prefix] = requested.get(self.prefix, 0) + n
        return read_region(self, index)

    zarr2.ZarrArray.read_region = recording
    with injected_network(payload["spec"]):
        trainer = DinoUNetTrainer(payload["plans"], "2d", 1, payload["dataset_json"],
                                  device=device)
        trainer.seed = 0
        trainer.initialize()
        trainer.load_checkpoint(payload["path"])
    zarr2.ZarrArray.read_region = read_region
    shard = trainer.model_shard
    names = [n for n, p in trainer.network.named_parameters() if p.requires_grad]
    whole = load_jax_checkpoint(payload["path"], trainable_names=names)
    want = shard_state_dict(whole["network_weights"], shard.rank, shard.size)
    held = trainer.network.state_dict()
    params = dict(trainer.network.named_parameters())
    momentum = whole["optimizer_state"]["state"]
    return {
        "rank": shard.rank, "size": shard.size, "epoch": trainer.current_epoch,
        "equal_to_slices": set(held) == set(want) and all(
            torch.equal(held[k], want[k].to(held[k].dtype)) for k in want),
        "momentum_equal": all(
            torch.equal(trainer.optimizer.state[params[n]]["momentum_buffer"],
                        momentum[i]["momentum_buffer"]) for i, n in enumerate(names)),
        "requested": requested,
        "held": {k: v.numel() for k, v in held.items()},
        "split": sorted(k for k, v in held.items() if tuple(v.shape) != tuple(
            whole["network_weights"][k].shape))}
