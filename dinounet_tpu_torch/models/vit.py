"""DINOv3 Vision Transformer backbone (frozen, inference), PyTorch.

Counterpart of ``dinounet_tpu/models/vit.py`` on its stats-threaded path, the
one the serving slice runs: one entry statistics pass, then in every block
the attention output projection and fc2 run as fused dense + LayerScale
residual + next-LayerNorm-statistics ops (``ops/dense_stats.py``), and the
attention itself as the fused RoPE attention op (``ops/attention.py``) over
the Dh-major QKV layout. Axial RoPE applies to the patch tokens; the cls and
storage tokens carry identity rows (sin 0, cos 1) in the tables. Parameter
names are the reference's (``blocks.N.attn.qkv.weight``, ``blocks.N.ls1.gamma``,
...). The SwiGLU FFN (ViT-7B) is not ported yet.

In the int8 serving mode (``configuration.vit_int8``, as
``dinounet_tpu/models/vit.py:276-323,436-452``) the same chain runs its four
projections as w8a8 ops (``ops/dense_q8.py``): the qkv straight into the
Dh-major layout (bf16 with ``DINOUNET_TPU_INT8_QKV=0``), the attention output
projection channel-major with the residual and statistics, fc1 plain, fc2
with the GELU prologue, the residual and statistics; the attention stays
bf16. The weights are quantized when applied, so the parameters (and
``models/convert.py``) are the same in both modes.
"""

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from dinounet_tpu_torch.configuration import COMPUTE_DTYPE, int8_qkv, vit_int8
from dinounet_tpu_torch.models.layers import (Linear, lecun_normal_,
                                              trunc_normal_)
from dinounet_tpu_torch.ops.attention import fused_rope_attention_premapped_dmaj
from dinounet_tpu_torch.ops.dense_q8 import (dense_cm_q8_residual_stats, dense_q8,
                                             dense_q8_residual_stats, qkv_q8_dmaj)
from dinounet_tpu_torch.ops.dense_stats import (dense_cm_residual_stats,
                                                dense_residual_stats, row_stats)


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


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype: torch.dtype):
        super().__init__()
        C = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.qkv = Linear(C, 3 * C, bias=cfg.qkv_bias, dtype=dtype)
        self.proj = Linear(C, C, bias=cfg.proj_bias, dtype=dtype)

    def forward(self, x, rope, residual, ls_gamma):
        """x: normed (B, N, C); returns (residual + gamma * proj(attn(x)),
        mean, var) with the next LayerNorm's statistics."""
        B, N, C = x.shape
        M = self.num_heads
        int8 = vit_int8()
        if int8 and int8_qkv():
            qkv = qkv_q8_dmaj(x, self.qkv.weight.t(), self.qkv.bias, M, C // M)
        else:
            qkv = self.qkv(x).view(B, N, 3, M, C // M).permute(0, 2, 3, 4, 1)
        o_t = fused_rope_attention_premapped_dmaj(qkv.contiguous(), *rope)
        bias = self.proj.bias if self.proj.bias is not None else torch.zeros_like(ls_gamma)
        dense = dense_cm_q8_residual_stats if int8 else dense_cm_residual_stats
        return dense(o_t.reshape(B, C, N), self.proj.weight.t(), bias, residual,
                     ls_gamma)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Linear(cfg.embed_dim, cfg.ffn_hidden, bias=cfg.ffn_bias, dtype=dtype)
        self.fc2 = Linear(cfg.ffn_hidden, cfg.embed_dim, bias=cfg.ffn_bias, dtype=dtype)

    def forward(self, x, residual, ls_gamma):
        """Returns (residual + gamma * fc2(gelu(fc1(x))), mean, var)."""
        bias = self.fc2.bias if self.fc2.bias is not None else torch.zeros_like(ls_gamma)
        if vit_int8():
            b1 = (self.fc1.bias if self.fc1.bias is not None
                  else torch.zeros(self.fc1.out_features, device=x.device))
            h = dense_q8(x, self.fc1.weight.t(), b1)
            return dense_q8_residual_stats(h, self.fc2.weight.t(), bias, residual,
                                           ls_gamma, prologue="gelu")
        return dense_residual_stats(self.fc1(x), self.fc2.weight.t(), bias,
                                    residual, ls_gamma, apply_gelu=True)


class Block(nn.Module):
    """Pre-norm attention and MLP, each with a LayerScale residual."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype):
        super().__init__()
        C = cfg.embed_dim
        self.norm1 = LayerNormFp32(C, cfg.norm_eps)
        self.attn = Attention(cfg, dtype)
        self.ls1 = LayerScale(C, cfg.layerscale_init)
        self.norm2 = LayerNormFp32(C, cfg.norm_eps)
        self.mlp = Mlp(cfg, dtype)
        self.ls2 = LayerScale(C, cfg.layerscale_init)

    def forward(self, x, rope, stats):
        y = self.norm1(x, stats)
        x2, mu2, var2 = self.attn(y, rope, x, self.ls1.gamma)
        y2 = self.norm2(x2, (mu2, var2))
        x3, mu3, var3 = self.mlp(y2, x2, self.ls2.gamma)
        return x3, (mu3, var3)


class DinoViT(nn.Module):
    """Returns normed (patch_tokens (B, h*w, E), cls_token (B, E)) after the
    blocks in `take_indices` (get_intermediate_layers(norm=True))."""

    def __init__(self, cfg: ViTConfig, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.ffn_layer != "mlp":
            raise NotImplementedError(
                "the SwiGLU FFN (ViT-7B) is not ported yet; mlp configs only")
        dtype = dtype or getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.compute_dtype = dtype
        E = cfg.embed_dim
        self.patch_embed = PatchEmbed(3, E, cfg.patch_size, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, E))
        self.storage_tokens = nn.Parameter(torch.zeros(1, cfg.n_storage_tokens, E))
        self.blocks = nn.ModuleList([Block(cfg, dtype) for _ in range(cfg.depth)])
        self.norm = LayerNormFp32(E, cfg.norm_eps)

    def init_params(self, gen):
        trunc_normal_(self.cls_token, 0.02, gen)
        trunc_normal_(self.storage_tokens, 0.02, gen)

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
        stats = row_stats(tokens)
        outputs = []
        for i, blk in enumerate(self.blocks):
            tokens, stats = blk(tokens, (sin, cos), stats)
            if i in take:
                normed = self.norm(tokens, stats)
                outputs.append((normed[:, np_:], normed[:, 0]))
        return outputs
