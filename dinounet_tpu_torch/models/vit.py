"""DINOv3 Vision Transformer backbone (frozen, inference), PyTorch.

Counterpart of ``dinounet_tpu/models/vit.py``, on the two paths the JAX
package runs by default. The mlp configs (ViT-S/B/L) take its stats-threaded
path: one entry statistics pass, then in every block the attention output
projection and fc2 run as fused dense + LayerScale residual +
next-LayerNorm-statistics ops (``ops/dense_stats.py``), and the attention
itself as the fused RoPE attention op (``ops/attention.py``) over the
Dh-major QKV layout, or with ``DINOUNET_TPU_ATTN_LAYOUT=ndh``
(``configuration.attn_premapped_layout``, ``vit.py:324-360``) over the
(B, 3, M, N, Dh) layout. The SwiGLU config (ViT-7B) takes its unfused path
(``vit.py:512-520``), since the gated FFN has no single dense + residual
tail: each LayerNorm computes its own one-pass statistics, the qkv
projection feeds the row-major fused RoPE attention op
(``ops/attention.py::fused_rope_attention``), and every projection is a
plain dense layer rounded as flax's ``nn.Dense(dtype=bf16)`` rounds (the
product to the compute dtype, then the bias added in it), the FFN
``w3(silu(w1 x) * w2 x)``, the LayerScale residuals in the compute dtype.
The JAX package runs the 40 blocks of the 7B as one ``lax.scan``; the port
loops (``models/convert.py`` reads either parameter layout). Axial RoPE
applies to the patch tokens; the cls and storage tokens carry identity rows
(sin 0, cos 1) in the tables. Parameter names are the reference's
(``blocks.N.attn.qkv.weight``, ``blocks.N.mlp.w1.weight``,
``blocks.N.ls1.gamma``, ...).

In the int8 serving mode (``configuration.vit_int8``, as
``dinounet_tpu/models/vit.py:186-226,276-323,436-452``) the stats-threaded
chain runs its four projections as w8a8 ops (``ops/dense_q8.py``): the qkv
straight into the attention's layout (bf16 with ``DINOUNET_TPU_INT8_QKV=0``),
the attention output projection channel-major with the residual and
statistics, fc1 plain, fc2 with the GELU prologue, the residual and
statistics. The unfused SwiGLU blocks run qkv, proj, w1, w2 and w3 as
``QuantDense`` (``ops/dense_q8.py::quant_dense``). The attention stays bf16
in both. The weights are quantized when first applied and the levels kept
on the weight (``ops/dense_q8.py::quantized_weight``), so the parameters
(and ``models/convert.py``) are the same in both modes.

Under a model axis (``DINOUNET_TPU_MODEL_AXIS``, ``parallel/sharding.py``)
every block is built as one rank's shards: qkv, fc1, w1 and w2 hold the
rank's output rows (whole heads of q, k and v), proj, fc2 and w3 its input
columns, whose partial products are summed over the model group in fp32
before the bias is added, once a matrix pair. In the mlp blocks the rank's
heads go to the fused attention (M / n heads), its output to #3's kernel in
the row-parallel mode (``ops/dense_stats.py::dense_cm_partial``: the fp32
product only), fc1 runs on the rank's columns and fc2 as #4's row-parallel
mode with the GELU prologue; after each fp32 all-reduce one post-reduce pass
(``post_reduce_residual_stats``) adds the bias, LayerScale and residual at
the fused epilogue's rounding points and emits the next LayerNorm's
statistics. The int8 serving mode runs under a model axis too, as GSPMD
splits it in the JAX package: the column-parallel layers (qkv into the
attention's layout, fc1, w1, w2) unchanged on the rank's output rows, whose
scales are already local; the row-parallel ones with their two scales taken
over the model group (the activation's per-token max|x| by a MAX all-reduce
of the rank's maxima, the weight's column max|w| when its levels are cached)
and their int32 partial products summed over it, exact, before the rescale,
bias and epilogue run once (``row_parallel_q8_tail``: #12's and #11's
row-parallel modes and the int8 post-reduce pass; ``quant_dense`` with a
group for the SwiGLU blocks). So the split int8 backbone equals the whole
int8 backbone bit for bit, where the bf16 split reorders fp32 sums.

``DinoViT.hold_weights_`` keeps the frozen backbone's matrices at the
compute dtype (the vectors stay fp32), as the JAX package's bench holds the
7B (``bench.py:83-97``): every use rounds a weight to the compute dtype
anyway, so the results are the same and no per-call cast happens.
"""

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dinounet_tpu_torch.configuration import (COMPUTE_DTYPE, attn_premapped_layout,
                                              int8_qkv, vit_int8)
from dinounet_tpu_torch.models.layers import (Linear, lecun_normal_,
                                              trunc_normal_)
from dinounet_tpu_torch.ops.attention import (fused_rope_attention,
                                              fused_rope_attention_premapped,
                                              fused_rope_attention_premapped_dmaj)
from dinounet_tpu_torch.ops.dense_q8 import (act_amax, all_reduce_max, dense_cm_q8_partial,
                                             dense_cm_q8_residual_stats, dense_q8,
                                             dense_q8_partial, dense_q8_residual_stats,
                                             post_reduce_q8_residual_stats, qkv_q8_dmaj,
                                             qkv_q8_premapped, quant_dense, quantized_weight)
from dinounet_tpu_torch.ops.dense_stats import (dense_cm_partial, dense_cm_residual_stats,
                                                dense_residual_partial, dense_residual_stats,
                                                post_reduce_residual_stats, row_stats)
from dinounet_tpu_torch.parallel.sharding import local_shape, shard_dim, shard_tensor

@dataclasses.dataclass(frozen=True)
class ViTConfig:
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    ffn_ratio: float = 4.0
    ffn_layer: str = "mlp"  # "mlp" | "swiglu"
    swiglu_align: int = 64
    qkv_bias: bool = True
    proj_bias: bool = True
    ffn_bias: bool = True
    layerscale_init: float = 1e-5
    n_storage_tokens: int = 4
    patch_size: int = 16
    norm_eps: float = 1e-5
    rope_base: float = 100.0
    dtype: str = COMPUTE_DTYPE

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def n_prefix_tokens(self) -> int:
        return 1 + self.n_storage_tokens

    @property
    def ffn_hidden(self) -> int:
        if self.ffn_layer == "mlp":
            return int(self.embed_dim * self.ffn_ratio)
        d = int(int(self.embed_dim * self.ffn_ratio) * 2 / 3)
        return d + (-d % self.swiglu_align)


# hyperparameters of the published checkpoints
VIT_CONFIGS = {
    "dinov3_vits16": ViTConfig(embed_dim=384, depth=12, num_heads=6, ffn_ratio=4,
                               ffn_layer="mlp", qkv_bias=True),
    "dinov3_vitb16": ViTConfig(embed_dim=768, depth=12, num_heads=12, ffn_ratio=4,
                               ffn_layer="mlp", qkv_bias=True),
    "dinov3_vitl16": ViTConfig(embed_dim=1024, depth=24, num_heads=16, ffn_ratio=4,
                               ffn_layer="mlp", qkv_bias=True),
    "dinov3_vit7b16": ViTConfig(embed_dim=4096, depth=40, num_heads=32, ffn_ratio=3,
                                ffn_layer="swiglu", swiglu_align=64, qkv_bias=False),
}


def rope_sincos(H: int, W: int, head_dim: int, base: float = 100.0,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Axial RoPE tables for an H x W patch grid -> (sin, cos), each
    [H*W, head_dim] fp32 (normalize_coords='separate', no augmentation)."""
    f32 = torch.float32
    periods = base ** (2 * torch.arange(head_dim // 4, dtype=f32, device=device)
                       / (head_dim // 2))
    coords_h = torch.arange(0.5, H, dtype=f32, device=device) / H * 2.0 - 1.0
    coords_w = torch.arange(0.5, W, dtype=f32, device=device) / W * 2.0 - 1.0
    coords = torch.stack([coords_h[:, None].expand(H, W),
                          coords_w[None, :].expand(H, W)], dim=-1).reshape(H * W, 2)
    angles = 2 * math.pi * coords[:, :, None] / periods[None, None, :]
    angles = angles.reshape(H * W, head_dim // 2).repeat(1, 2)
    return torch.sin(angles), torch.cos(angles)


class LayerNormFp32(nn.Module):
    """LayerNorm in fp32 whatever the input dtype. `stats=(mean, var)` (each
    (..., N) fp32, from the producing fused-dense op) skips the statistics."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, stats=None):
        xf = x.float()
        if stats is None:
            mean, var = row_stats(x)
        else:
            mean, var = stats
        y = (xf - mean[..., None]) * torch.rsqrt(var[..., None] + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding (a stride-p conv, `proj`), fp32
    accumulation, bias added before the round to the compute dtype."""

    def __init__(self, in_ch: int, embed_dim: int, patch_size: int,
                 dtype: torch.dtype):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, embed_dim, patch_size, stride=patch_size)
        self.compute_dtype = dtype

    def init_params(self, gen):
        p = self.proj.kernel_size[0]
        lecun_normal_(self.proj.weight, p * p * self.proj.in_channels, gen)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x):
        """(B, C, H, W) -> (B, H/p * W/p, E)."""
        cdt = self.compute_dtype
        y = torch.nn.functional.conv2d(x.to(cdt), self.proj.weight.to(cdt),
                                       stride=self.proj.stride)
        y = y.flatten(2).transpose(1, 2)
        return (y.float() + self.proj.bias).to(cdt)


def backbone_dense(layer: Linear, x: torch.Tensor) -> torch.Tensor:
    """A dense layer of the unfused blocks as the JAX package's
    ``_backbone_dense`` applies it: flax ``nn.Dense(dtype)`` (the product
    rounded to the compute dtype, then the bias added in it), or
    ``QuantDense`` in the int8 serving mode (a row-parallel shard's summed
    over its model group)."""
    cdt = layer.compute_dtype
    group = getattr(layer, "reduce_group", None)
    if vit_int8():
        return quant_dense(x, layer.weight, layer.bias, cdt, group)
    y = F.linear(x.to(cdt), layer.weight.to(cdt))
    if group is not None:  # row-parallel: sum the ranks' partial products in fp32
        partial = y.float()
        torch.distributed.all_reduce(partial, group=group)
        y = partial.to(cdt)
    return y if layer.bias is None else y + layer.bias.to(cdt)


def row_parallel_tail(partial, group, bias, residual, ls_gamma):
    """The end of a row-parallel projection of the mlp blocks: the ranks'
    fp32 products summed over the model group, then the epilogue and the
    next LayerNorm's statistics (out, mean, var)."""
    torch.distributed.all_reduce(partial, group=group)
    return post_reduce_residual_stats(partial, bias, residual, ls_gamma)


def row_parallel_q8_tail(h, layer, channel_major: bool, prologue: str, bias, residual,
                         ls_gamma):
    """The int8 row-parallel projection of the mlp blocks, on a rank's
    channel-major attention output (#12's mode) or its fc1 output through
    the GELU (#11's): the weight's levels at its column scales over the
    model group (cached on the shard at the first call), the rank's
    per-token maxima all-reduced with MAX, the rank's int32 product at
    those scales summed over the group (exact), then the epilogue and the
    next LayerNorm's statistics once (out, mean, var)."""
    group = layer.reduce_group
    wq, ws = quantized_weight(layer.weight.t(), group=group)
    amax = all_reduce_max(act_amax(h, channel_major, prologue), group)
    if channel_major:
        acc, a = dense_cm_q8_partial(h, wq, amax)
    else:
        acc, a = dense_q8_partial(h, wq, amax, prologue)
    torch.distributed.all_reduce(acc, group=group)
    return post_reduce_q8_residual_stats(acc, a, ws, bias, residual, ls_gamma)


class ShardLinear(Linear):
    """A rank's shard of the block's dense layer `name` (``attn.qkv``,
    ``mlp.fc2``, ...) on a model axis (``parallel/sharding.py``): its init
    draws the whole (out, in) matrix, as one process draws it, and keeps the
    rank's part, so the shard is one process's and the generator's later
    draws (the trainable layers') are one process's too. A row-parallel
    layer sums its ranks' products over ``reduce_group``."""

    def __init__(self, name: str, in_features: int, out_features: int, shard,
                 bias: bool, dtype: torch.dtype):
        self.shard_name, self.rank, self.n_model = name + ".weight", shard.rank, shard.size
        self.full_shape = (out_features, in_features)
        out_local, in_local = local_shape(self.shard_name, self.full_shape, shard.size)
        super().__init__(in_local, out_local, bias=bias, dtype=dtype)
        if shard_dim(self.shard_name) == 1:
            self.reduce_group = shard.group

    def init_params(self, gen):
        full = torch.empty(self.full_shape, device=self.weight.device)
        lecun_normal_(full, self.full_shape[1], gen)
        with torch.no_grad():
            self.weight.copy_(shard_tensor(self.shard_name, full, self.rank, self.n_model))
            if self.bias is not None:
                self.bias.zero_()


def block_dense(name: str, in_features: int, out_features: int, shard, bias: bool,
                dtype: torch.dtype) -> Linear:
    """The block's dense layer `name`: whole, or the rank's shard of it."""
    if shard is None:
        return Linear(in_features, out_features, bias=bias, dtype=dtype)
    return ShardLinear(name, in_features, out_features, shard, bias, dtype)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype: torch.dtype, shard=None):
        super().__init__()
        C = cfg.embed_dim
        self.num_heads = cfg.num_heads // (1 if shard is None else shard.size)
        self.qkv = block_dense("attn.qkv", C, 3 * C, shard, cfg.qkv_bias, dtype)
        self.proj = block_dense("attn.proj", C, C, shard, cfg.proj_bias, dtype)

    def forward(self, x, rope, residual, ls_gamma):
        """x: normed (B, N, C); returns (residual + gamma * proj(attn(x)),
        mean, var) with the next LayerNorm's statistics. The qkv projection
        emits the attention's layout, (B, 3, M, Dh, N) or with
        ``attn_premapped_layout() == "ndh"`` (B, 3, M, N, Dh)."""
        B, N, C = x.shape
        M = self.num_heads  # the rank's heads under a model axis
        Dh = self.qkv.out_features // (3 * M)
        int8 = vit_int8()
        if attn_premapped_layout() == "ndh":
            if int8 and int8_qkv():
                qkv = qkv_q8_premapped(x, self.qkv.weight.t(), self.qkv.bias, M, Dh)
            else:
                qkv = self.qkv(x).view(B, N, 3, M, Dh).permute(0, 2, 3, 1, 4)
            o_t = fused_rope_attention_premapped(qkv.contiguous(), *rope)
        else:
            if int8 and int8_qkv():
                qkv = qkv_q8_dmaj(x, self.qkv.weight.t(), self.qkv.bias, M, Dh)
            else:
                qkv = self.qkv(x).view(B, N, 3, M, Dh).permute(0, 2, 3, 4, 1)
            o_t = fused_rope_attention_premapped_dmaj(qkv.contiguous(), *rope)
        bias = self.proj.bias if self.proj.bias is not None else torch.zeros_like(ls_gamma)
        o_t = o_t.reshape(B, M * Dh, N)
        if isinstance(self.proj, ShardLinear):
            if int8:
                return row_parallel_q8_tail(o_t, self.proj, True, "none", bias, residual,
                                            ls_gamma)
            return row_parallel_tail(dense_cm_partial(o_t, self.proj.weight.t()),
                                     self.proj.reduce_group, bias, residual, ls_gamma)
        dense = dense_cm_q8_residual_stats if int8 else dense_cm_residual_stats
        return dense(o_t, self.proj.weight.t(), bias, residual, ls_gamma)

    def unfused(self, x, rope):
        """x: normed (B, N, C); returns proj(attn(x)) (the residual is the
        block's): the qkv projection, the row-major fused RoPE attention,
        the output projection. Under a model axis the rank's heads only,
        its output projection summed over the axis."""
        B, N, _ = x.shape
        M = self.num_heads
        qkv = backbone_dense(self.qkv, x).view(B, N, 3, M, -1)
        return backbone_dense(self.proj, fused_rope_attention(qkv, *rope).reshape(B, N, -1))


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype: torch.dtype, shard=None):
        super().__init__()
        E, hidden = cfg.embed_dim, cfg.ffn_hidden
        self.fc1 = block_dense("mlp.fc1", E, hidden, shard, cfg.ffn_bias, dtype)
        self.fc2 = block_dense("mlp.fc2", hidden, E, shard, cfg.ffn_bias, dtype)

    def forward(self, x, residual, ls_gamma):
        """Returns (residual + gamma * fc2(gelu(fc1(x))), mean, var)."""
        bias = self.fc2.bias if self.fc2.bias is not None else torch.zeros_like(ls_gamma)
        split = isinstance(self.fc2, ShardLinear)
        if vit_int8():
            b1 = (self.fc1.bias if self.fc1.bias is not None
                  else torch.zeros(self.fc1.out_features, device=x.device))
            h = dense_q8(x, self.fc1.weight.t(), b1)  # a rank's fc1 columns when split
            if split:
                return row_parallel_q8_tail(h, self.fc2, False, "gelu", bias, residual,
                                            ls_gamma)
            return dense_q8_residual_stats(h, self.fc2.weight.t(), bias, residual,
                                           ls_gamma, prologue="gelu")
        if split:
            partial = dense_residual_partial(self.fc1(x), self.fc2.weight.t(), apply_gelu=True)
            return row_parallel_tail(partial, self.fc2.reduce_group, bias, residual, ls_gamma)
        return dense_residual_stats(self.fc1(x), self.fc2.weight.t(), bias,
                                    residual, ls_gamma, apply_gelu=True)


class SwiGLU(nn.Module):
    """w3(silu(w1 x) * w2 x), each product rounded to the compute dtype as
    the JAX package's silu (x * sigmoid(x)) and gate are."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype, shard=None):
        super().__init__()
        E, hidden = cfg.embed_dim, cfg.ffn_hidden
        self.w1 = block_dense("mlp.w1", E, hidden, shard, cfg.ffn_bias, dtype)
        self.w2 = block_dense("mlp.w2", E, hidden, shard, cfg.ffn_bias, dtype)
        self.w3 = block_dense("mlp.w3", hidden, E, shard, cfg.ffn_bias, dtype)

    def forward(self, x):
        x1 = backbone_dense(self.w1, x)
        x2 = backbone_dense(self.w2, x)
        return backbone_dense(self.w3, x1 * torch.sigmoid(x1) * x2)


class Block(nn.Module):
    """Pre-norm attention and FFN, each with a LayerScale residual: the
    stats-threaded chain for the mlp configs, the unfused block for SwiGLU.
    With a `shard` (``parallel/sharding.py``'s ``ModelShard``) the block
    holds the rank's heads and FFN columns only."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype, shard=None):
        super().__init__()
        C = cfg.embed_dim
        self.stats_threaded = cfg.ffn_layer == "mlp"
        self.norm1 = LayerNormFp32(C, cfg.norm_eps)
        self.attn = Attention(cfg, dtype, shard)
        self.ls1 = LayerScale(C, cfg.layerscale_init)
        self.norm2 = LayerNormFp32(C, cfg.norm_eps)
        self.mlp = (Mlp if self.stats_threaded else SwiGLU)(cfg, dtype, shard)
        self.ls2 = LayerScale(C, cfg.layerscale_init)

    def forward(self, x, rope, stats=None):
        """Chain: (x, stats) -> (x, the next LayerNorm's stats). Unfused:
        x -> x."""
        if not self.stats_threaded:
            y = self.attn.unfused(self.norm1(x), rope)
            x = x + y * self.ls1.gamma.to(y.dtype)
            y = self.mlp(self.norm2(x))
            return x + y * self.ls2.gamma.to(y.dtype)
        y = self.norm1(x, stats)
        x2, mu2, var2 = self.attn(y, rope, x, self.ls1.gamma)
        y2 = self.norm2(x2, (mu2, var2))
        x3, mu3, var3 = self.mlp(y2, x2, self.ls2.gamma)
        return x3, (mu3, var3)


class DinoViT(nn.Module):
    """Returns normed (patch_tokens (B, h*w, E), cls_token (B, E)) after the
    blocks in `take_indices` (get_intermediate_layers(norm=True)). With a
    `shard` (a ``ModelShard``) its blocks are that rank's shards."""

    def __init__(self, cfg: ViTConfig, dtype: Optional[torch.dtype] = None, shard=None):
        super().__init__()
        dtype = dtype or getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.compute_dtype = dtype
        if shard is not None and cfg.num_heads % shard.size:
            raise ValueError(f"{cfg.num_heads} heads do not split {shard.size} ways")
        self.shard = shard
        E = cfg.embed_dim
        self.patch_embed = PatchEmbed(3, E, cfg.patch_size, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, E))
        self.storage_tokens = nn.Parameter(torch.zeros(1, cfg.n_storage_tokens, E))
        self.blocks = nn.ModuleList([Block(cfg, dtype, shard) for _ in range(cfg.depth)])
        self.norm = LayerNormFp32(E, cfg.norm_eps)

    def init_params(self, gen):
        trunc_normal_(self.cls_token, 0.02, gen)
        trunc_normal_(self.storage_tokens, 0.02, gen)

    def hold_weights_(self, dtype: torch.dtype) -> "DinoViT":
        """Store every parameter of two or more dims (the matrices, the patch
        conv, the prefix tokens) in `dtype`; the vectors (norms, biases,
        LayerScale) stay as they are. For a frozen backbone at its serving
        dtype: the 7B's matrices take 13.5 GB in bf16 instead of 27 in fp32."""
        for p in self.parameters():
            if p.dim() >= 2:
                p.data = p.data.to(dtype)
        return self

    def forward(self, x: torch.Tensor,
                take_indices: Sequence[int]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        cfg = self.cfg
        cdt = self.compute_dtype
        B, _, H, W = x.shape
        p = cfg.patch_size
        h, w = H // p, W // p
        tokens = self.patch_embed(x)
        prefix = torch.cat([self.cls_token, self.storage_tokens], dim=1).to(cdt)
        tokens = torch.cat([prefix.expand(B, -1, -1), tokens], dim=1)

        sin, cos = rope_sincos(h, w, cfg.head_dim, cfg.rope_base, device=x.device)
        np_ = cfg.n_prefix_tokens
        sin = torch.cat([torch.zeros((np_, sin.shape[1]), device=x.device), sin])
        cos = torch.cat([torch.ones((np_, cos.shape[1]), device=x.device), cos])

        take = set(int(i) for i in take_indices)
        outputs = []
        if cfg.ffn_layer != "mlp":  # unfused blocks, each norm its own statistics
            for i, blk in enumerate(self.blocks):
                tokens = blk(tokens, (sin, cos))
                if i in take:
                    normed = self.norm(tokens)
                    outputs.append((normed[:, np_:], normed[:, 0]))
            return outputs
        stats = row_stats(tokens)
        for i, blk in enumerate(self.blocks):
            tokens, stats = blk(tokens, (sin, cos), stats)
            if i in take:
                normed = self.norm(tokens, stats)
                outputs.append((normed[:, np_:], normed[:, 0]))
        return outputs
