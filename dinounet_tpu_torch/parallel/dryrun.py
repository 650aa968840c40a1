"""Multi-rank dry runs on CPU ranks: the counterparts of
``__graft_entry__.py``'s ``dryrun_multichip`` and ``dryrun_7b_block``.

    python -m dinounet_tpu_torch.parallel.dryrun [n] [--7b-block]

``dryrun_multichip(n)`` spawns n gloo ranks on a (n / 2, 2) ('data',
'model') mesh (n even and at least 4; else (n, 1)) and runs one train step
of a depth-4 SwiGLU DinoUNet of the 7B's structure at width 64 (bf16
backbone, fp32 elsewhere): the backbone's blocks built as each rank's
shards, the step through the trainer's data-parallel wrapper, the DC+CE
loss, the clipped SGD step. It asserts the shard shapes and a finite loss
on every rank, and that the trainable weights stay equal across ranks.

``dryrun_7b_block(n)`` builds one block of the real ViT-7B (4096 wide, 32
heads, SwiGLU hidden 8192) as a model-axis rank's shard on the ``meta``
device and asserts the shard shapes (those of ``__graft_entry__.py:309-313``
in torch's (out, in) layout); then, on n gloo ranks, a narrow block (width
64, 4 heads) split over the model axis against the same block whole on
each rank, in fp32.

``__graft_entry__.py``'s ``entry()`` has no counterpart: ``chip_smoke.py``
builds and runs that forward on the card.
"""

import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from dinounet_tpu_torch.models.dinounet import DinoUNet, DinoUNetConfig
from dinounet_tpu_torch.models.vit import VIT_CONFIGS, Block, ViTConfig, rope_sincos
from dinounet_tpu_torch.parallel.launch import spawn
from dinounet_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, make_mesh,
                                              wrap_data_parallel)
from dinounet_tpu_torch.parallel.sharding import ModelShard, shard_state_dict

WIDTH, HEADS = 64, 4


def model_axis_for(n: int) -> int:
    return 2 if n % 2 == 0 and n >= 4 else 1


def block_shard_shapes(cfg: ViTConfig, n_model: int) -> dict:
    """The shard shapes a model-axis rank must hold, torch's (out, in)."""
    C, H = cfg.embed_dim, cfg.ffn_hidden
    return {"attn.qkv.weight": (3 * C // n_model, C), "attn.proj.weight": (C, C // n_model),
            "mlp.w1.weight": (H // n_model, C), "mlp.w2.weight": (H // n_model, C),
            "mlp.w3.weight": (C, H // n_model)}


def assert_block_shards(block: Block, cfg: ViTConfig, n_model: int) -> None:
    held = {k: tuple(v.shape) for k, v in block.state_dict().items()}
    for name, shape in block_shard_shapes(cfg, n_model).items():
        if held[name] != shape:
            raise AssertionError(f"{name}: the shard holds {held[name]}, want {shape}")


def stand_in_config() -> DinoUNetConfig:
    vit = ViTConfig(embed_dim=WIDTH, depth=4, num_heads=HEADS, ffn_ratio=2.0,
                    ffn_layer="swiglu", qkv_bias=False, dtype="bfloat16")
    return DinoUNetConfig(vit=vit, interaction_indexes=(0, 1, 2, 3), num_classes=3,
                          features_per_stage=(8, 16, 32, 64), fapm_rank=8,
                          conv_inplane=8, deform_num_heads=2, drop_path_rate=0.0,
                          dtype="float32")


def _multichip_rank(device, n_model: int) -> float:
    from dinounet_tpu_torch.training.losses import dc_and_ce_loss
    from dinounet_tpu_torch.training.trainer import clip_and_step, sgd_nesterov

    mesh = make_mesh(n_model, "cpu")
    rank = dist.get_rank()
    shard = ModelShard(rank % n_model, n_model, mesh.get_group(MODEL_AXIS))
    cfg = stand_in_config()
    model = DinoUNet(cfg, shard=shard).init_weights(0).train()
    for blk in model.encoder.dinov3_adapter.backbone.blocks:
        assert_block_shards(blk, cfg.vit, n_model)
    data_group = mesh.get_group(DATA_AXIS)
    ddp = wrap_data_parallel(model, data_group, device)
    rng = np.random.default_rng(rank // n_model)  # a data rank's batch, its model group's
    x = torch.from_numpy(rng.standard_normal((2, 1, 64, 64)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, 3, (2, 64, 64)))
    opt = sgd_nesterov([p for p in model.parameters() if p.requires_grad], 1e-3, 3e-5)
    loss = dc_and_ce_loss(ddp(x), seg, reduce_group=data_group)
    loss.backward()
    clip_and_step(opt, 12.0)
    loss = float(loss.detach())
    if not np.isfinite(loss):
        raise AssertionError(f"rank {rank}: non-finite loss {loss}")
    flat = torch.cat([p.detach().flatten() for p in model.parameters() if p.requires_grad])
    first = flat.clone()
    dist.broadcast(first, 0)
    if not torch.equal(flat, first):
        raise AssertionError(f"rank {rank}: the trainable weights differ from rank 0's")
    return loss


def dryrun_multichip(n: int = 4) -> list:
    """One train step on n CPU ranks; each rank's loss (its share)."""
    return spawn(_multichip_rank, n, model_axis_for(n), devices="cpu")


def _block_rank(device, n_model: int, state: dict, x: torch.Tensor, rope) -> float:
    mesh = make_mesh(n_model, "cpu")
    cfg = ViTConfig(embed_dim=WIDTH, depth=1, num_heads=HEADS, ffn_ratio=2.0,
                    ffn_layer="swiglu", qkv_bias=False, dtype="float32")
    shard = ModelShard(dist.get_rank() % n_model, n_model, mesh.get_group(MODEL_AXIS))
    whole, split = Block(cfg, torch.float32), Block(cfg, torch.float32, shard)
    whole.load_state_dict(state)
    split.load_state_dict(shard_state_dict(state, shard.rank, n_model))
    assert_block_shards(split, cfg, n_model)
    with torch.no_grad():
        err = float((split(x, rope) - whole(x, rope)).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"the split block is {err} off the whole block")
    return err


def dryrun_7b_block(n: int = 4) -> list:
    """The real 7B block's shard shapes on meta; a narrow split block equal
    to the whole one on n CPU ranks (each rank's largest difference)."""
    n_model = model_axis_for(n)
    cfg7 = dataclasses.replace(VIT_CONFIGS["dinov3_vit7b16"], depth=1, dtype="float32")
    assert cfg7.embed_dim == 4096 and cfg7.num_heads == 32 and cfg7.ffn_hidden == 8192
    with torch.device("meta"):
        for rank in range(n_model):
            assert_block_shards(Block(cfg7, torch.float32, ModelShard(rank, n_model)),
                                cfg7, n_model)
    cfg = ViTConfig(embed_dim=WIDTH, depth=1, num_heads=HEADS, ffn_ratio=2.0,
                    ffn_layer="swiglu", qkv_bias=False, dtype="float32")
    gen = torch.Generator().manual_seed(0)
    state = {k: torch.randn(v.shape, generator=gen) * 0.1
             for k, v in Block(cfg, torch.float32).state_dict().items()}
    np_ = cfg.n_prefix_tokens
    sin, cos = rope_sincos(4, 4, cfg.head_dim, cfg.rope_base)
    rope = (torch.cat([torch.zeros(np_, sin.shape[1]), sin]),
            torch.cat([torch.ones(np_, cos.shape[1]), cos]))
    x = torch.randn((2, 16 + np_, WIDTH), generator=gen)
    return spawn(_block_rank, n, n_model, state, x, rope, devices="cpu")


if __name__ == "__main__":
    n = int(next((a for a in sys.argv[1:] if a.isdigit()), 4))
    if "--7b-block" in sys.argv:
        print(f"dryrun_7b_block({n}): largest difference by rank {dryrun_7b_block(n)}")
    else:
        print(f"dryrun_multichip({n}): loss by rank {dryrun_multichip(n)}")
