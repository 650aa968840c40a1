"""ViT-Adapter (DINOv3_Adapter), PyTorch.

Counterpart of ``dinounet_tpu/models/adapter.py``. The deformable attention
always runs in the premapped fused-prep form (the projections emit the
kernel's channel-major layouts, the kernel does the offset base add and the
point softmax, ``ops/msda_kernel.py``; differentiable, its backward is the
MSDA backward kernel). In eval mode (serving, validation) both residual
junctions of every extractor run as fused dense + residual + LayerNorm
statistics ops, the statistics threaded from one extractor to the next. In
train mode the extractors run unfused, as the JAX package's train path does
(``adapter.py:440-461``): plain output projections, an exact GELU before the
ConvFFN's fc2, a drop-path on the ConvFFN branch, and every interaction block
recomputed in the backward (``torch.utils.checkpoint``, the JAX ``remat``).
The frozen backbone runs under ``torch.no_grad()`` (``stop_gradient``), and
the SPM's and output BatchNorms use batch statistics.

Token layout (input H x W, patch 16): the conv queries c are the three scale
grids [H/8*W/8, H/16*W/16, H/32*W/32] = 21n tokens, n = H/32*W/32; the values
are the single-level ViT patch grid (H/16 x W/16). Parameter names are the
reference's (``spm.stem.0.weight``, ``interactions.3.extra_extractors.1...``).
"""

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dinounet_tpu_torch.configuration import use_spm_cm
from dinounet_tpu_torch.models.layers import (BatchNorm, Conv2d, Linear,
                                              TransposedConv, bilinear_resize)
from dinounet_tpu_torch.models.vit import DinoViT, LayerNormFp32
from dinounet_tpu_torch.ops.decoder_tail import conv3x3_cm, tail_supported
from dinounet_tpu_torch.ops.dense_stats import (dense_cm_residual_stats,
                                                dense_residual_stats)
from dinounet_tpu_torch.ops.msda_kernel import ms_deform_attn_premapped_fused


def reference_points_for_grids(grids: Sequence[Tuple[int, int]],
                               device=None) -> torch.Tensor:
    """Normalized (x, y) cell centers, concatenated over grids -> (1, L, 1, 2)."""
    pts = []
    for (H, W) in grids:
        ys = (torch.arange(H, dtype=torch.float32, device=device) + 0.5) / H
        xs = (torch.arange(W, dtype=torch.float32, device=device) + 0.5) / W
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1))
    return torch.cat(pts, dim=0)[None, :, None, :]


def sampling_offset_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Grid-direction init of the sampling-offset bias: head m points along
    angle 2*pi*m/M, point p at distance p + 1 (ref ms_deform_attn.py:137-150)."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


class MSDeformAttn(nn.Module):
    """Deformable attention: projections + sampling around reference points."""

    def __init__(self, d_model: int, n_levels: int = 1, n_heads: int = 16,
                 n_points: int = 4, ratio: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.n_heads, self.n_levels, self.n_points = n_heads, n_levels, n_points
        self.d_value = int(d_model * ratio)
        self.value_proj = Linear(d_model, self.d_value, dtype=dtype)
        self.sampling_offsets = Linear(d_model, n_heads * n_levels * n_points * 2,
                                       dtype=dtype)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points,
                                        dtype=dtype)
        self.output_proj = Linear(self.d_value, d_model, dtype=dtype)

    def init_params(self, gen):
        # runs after the Linears' own init (module order): zero kernels, grid bias
        with torch.no_grad():
            nn.init.zeros_(self.sampling_offsets.weight)
            self.sampling_offsets.bias.copy_(torch.from_numpy(sampling_offset_bias(
                self.n_heads, self.n_levels, self.n_points)))
            nn.init.zeros_(self.attention_weights.weight)
            nn.init.zeros_(self.attention_weights.bias)

    def _sample(self, query, reference_points, value_tokens,
                value_spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """The projections and the sampling: (B, M, D, Lq) channel-major."""
        M, L, P = self.n_heads, self.n_levels, self.n_points
        B, Lq, C = query.shape
        S = value_tokens.shape[1]
        D = self.d_value // M
        LP = L * P
        # the base-grid fold assumes batch-constant, single-level reference
        # points (the adapter's constant grid): refuse anything else
        if reference_points.shape[0] != 1 or reference_points.shape[2] != 1:
            raise ValueError("premapped MSDA requires batch-constant level-0 "
                             f"reference points, got {tuple(reference_points.shape)}")
        v_t = self.value_proj(value_tokens).view(B, S, M, D).permute(0, 2, 3, 1)
        off = self.sampling_offsets(query).view(B, Lq, M, 2 * LP).permute(0, 2, 3, 1)
        logits = self.attention_weights(query).view(B, Lq, M, LP).permute(0, 2, 3, 1)

        # pixel space: unnormalize(ref + off / size) = ref * size - 0.5 + off
        sizes = torch.tensor([[w, h] for (h, w) in value_spatial_shapes],
                             dtype=torch.float32, device=query.device)  # (L, 2)
        ref = reference_points[0, :, 0]  # (Lq, 2) normalized (x, y)
        base = (ref[None] * sizes[:, None, :] - 0.5)  # (L, Lq, 2)
        base = base[:, None].expand(L, P, Lq, 2).permute(0, 1, 3, 2)
        base = base.reshape(2 * LP, Lq).contiguous()

        return ms_deform_attn_premapped_fused(
            v_t.contiguous(), tuple(value_spatial_shapes), off.contiguous(),
            logits.contiguous(), base)

    def forward(self, query, reference_points, value_tokens,
                value_spatial_shapes: Sequence[Tuple[int, int]], residual=None):
        """query (B, Lq, C) and value_tokens (B, S, C), both normed;
        reference_points (1, Lq, 1, 2). Without `residual`, returns
        proj(attn) (B, Lq, C), the train path's plain projection. With it,
        returns (residual + proj(attn), mean, var) with the next LayerNorm's
        statistics, from the fused dense op."""
        out_t = self._sample(query, reference_points, value_tokens,
                             value_spatial_shapes)
        B, M, D, Lq = out_t.shape
        if residual is None:
            return self.output_proj(out_t.reshape(B, M * D, Lq).transpose(1, 2))
        C = query.shape[2]
        ones = torch.ones(C, dtype=torch.float32, device=query.device)
        return dense_cm_residual_stats(out_t.reshape(B, M * D, Lq),
                                       self.output_proj.weight.t(),
                                       self.output_proj.bias, residual, ones)


class DWConvMS(nn.Module):
    """Depthwise 3x3 per scale group of the 21n-token sequence: tokens
    [0:16n] on the 2H x 2W grid, [16n:20n] on H x W, [20n:21n] on H/2 x W/2,
    (H, W) the 1/16 grid."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, padding=1, groups=dim, dtype=dtype)

    def forward(self, x, H: int, W: int):
        B, N, C = x.shape
        n = N // 21
        outs = []
        for (start, stop, h, w) in ((0, 16 * n, 2 * H, 2 * W),
                                    (16 * n, 20 * n, H, W),
                                    (20 * n, N, H // 2, W // 2)):
            g = x[:, start:stop].transpose(1, 2).reshape(B, C, h, w)
            outs.append(self.dwconv(g).flatten(2).transpose(1, 2))
        return torch.cat(outs, dim=1)


class ConvFFN(nn.Module):
    """fc1 -> multiscale depthwise conv -> GELU -> fc2. With `residual` the
    last three are fused with the residual and the next LayerNorm's
    statistics; without it fc2 is a plain Linear after an exact GELU (the
    train path)."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.dwconv = DWConvMS(hidden, dtype)
        self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x, H: int, W: int, residual=None):
        h = self.dwconv(self.fc1(x), H, W)
        if residual is None:
            return self.fc2(F.gelu(h))
        ones = torch.ones(residual.shape[-1], dtype=torch.float32, device=x.device)
        return dense_residual_stats(h, self.fc2.weight.t(), self.fc2.bias,
                                    residual, ones, apply_gelu=True)


def drop_path_keep(batch: int, rate: float,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic-depth draw (ref dinov3_adapter.py:18-26):
    (batch,) bool, True where the sample keeps its branch (probability
    1 - rate), drawn on the CPU from `generator` (the default generator when
    None)."""
    return torch.rand(batch, generator=generator) < 1.0 - rate


def drop_path(x: torch.Tensor, keep: Optional[torch.Tensor],
              rate: float) -> torch.Tensor:
    """x / (1 - rate) where the sample keeps its branch, zero where it drops
    it (adapter.py:403-410); `keep` None leaves x as it is."""
    if keep is None or rate == 0.0:
        return x
    mask = keep.to(x.device).view((-1,) + (1,) * (x.ndim - 1))
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


class Extractor(nn.Module):
    """query += MSDeformAttn(query_norm(query), feat_norm(feat));
    query += drop_path(ConvFFN(ffn_norm(query))). In eval mode both junctions
    are fused: `stats` are query_norm's statistics from the previous
    extractor's fc2 junction (None for the first), and the call returns
    (query, next stats). In train mode the junctions are plain residual adds,
    `keep` is this extractor's drop-path draw (None: no drop-path), and the
    returned statistics are None."""

    def __init__(self, dim: int, num_heads: int, n_points: int,
                 deform_ratio: float, cffn_ratio: float, dtype: torch.dtype,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.query_norm = LayerNormFp32(dim, 1e-6)
        self.feat_norm = LayerNormFp32(dim, 1e-6)
        self.attn = MSDeformAttn(dim, 1, num_heads, n_points, deform_ratio, dtype)
        self.ffn = ConvFFN(dim, int(dim * cffn_ratio), dtype)
        self.ffn_norm = LayerNormFp32(dim, 1e-6)

    def forward(self, query, reference_points, feat, value_spatial_shapes,
                H_c: int, W_c: int, stats=None, keep=None):
        q_normed = self.query_norm(query, stats)
        f_normed = self.feat_norm(feat)
        if self.training:
            query = query + self.attn(q_normed, reference_points, f_normed,
                                      value_spatial_shapes)
            ffn_out = self.ffn(self.ffn_norm(query), H_c, W_c)
            return query + drop_path(ffn_out, keep, self.drop_path_rate), None
        query, mu, var = self.attn(q_normed, reference_points, f_normed,
                                   value_spatial_shapes, query)
        query, mu2, var2 = self.ffn(self.ffn_norm(query, (mu, var)), H_c, W_c,
                                    query)
        return query, (mu2, var2)


class InteractionBlock(nn.Module):
    """One extractor, plus two more on the last block (extract-only: the ViT
    tokens pass through untouched on the DinoUNet path)."""

    def __init__(self, dim: int, num_heads: int, n_points: int,
                 deform_ratio: float, cffn_ratio: float, extra_extractor: bool,
                 dtype: torch.dtype, drop_path_rate: float = 0.0):
        super().__init__()
        args = (dim, num_heads, n_points, deform_ratio, cffn_ratio, dtype,
                drop_path_rate)
        self.extractor = Extractor(*args)
        self.extra_extractors = (nn.ModuleList([Extractor(*args), Extractor(*args)])
                                 if extra_extractor else None)

    @property
    def n_extractors(self) -> int:
        return 1 + len(self.extra_extractors or [])

    def forward(self, vit_tokens, c, reference_points, value_spatial_shapes,
                H_c: int, W_c: int, stats=None, keeps=None):
        """`keeps`: one drop-path draw per extractor (train mode), or None."""
        extractors = [self.extractor] + list(self.extra_extractors or [])
        for i, ex in enumerate(extractors):
            c, stats = ex(c, reference_points, vit_tokens, value_spatial_shapes,
                          H_c, W_c, stats, None if keeps is None else keeps[i])
        return c, stats


def _cbr(in_ch: int, out_ch: int, stride: int, dtype) -> List[nn.Module]:
    return [Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, bias=False,
                   dtype=dtype), BatchNorm(out_ch), nn.ReLU()]


class SpatialPriorModule(nn.Module):
    """Conv stem producing 4 scale maps (1/4 .. 1/32), projected to embed_dim.
    Returns c1 as an NCHW map and c2..c4 as (B, n, E) token sequences.

    In eval mode, with DINOUNET_TPU_SPM_CM on (``configuration.py``), stem2
    and stem3 (3x3, stride 1, at half resolution) run through
    ``ops/decoder_tail.py::conv3x3_cm`` where the JAX package takes that route
    (``adapter.py:553-596``): stem2's BatchNorm (running statistics) + ReLU
    rides stem3's prologue as a leaky ReLU of slope 0, and stem3's BatchNorm
    + ReLU is applied on exit in fp32."""

    def __init__(self, inplanes: int = 64, embed_dim: int = 384,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        ip = inplanes
        self.stem = nn.Sequential(*_cbr(3, ip, 2, dtype), *_cbr(ip, ip, 1, dtype),
                                  *_cbr(ip, ip, 1, dtype),
                                  nn.MaxPool2d(3, stride=2, padding=1))
        self.conv2 = nn.Sequential(*_cbr(ip, 2 * ip, 2, dtype))
        self.conv3 = nn.Sequential(*_cbr(2 * ip, 4 * ip, 2, dtype))
        self.conv4 = nn.Sequential(*_cbr(4 * ip, 4 * ip, 2, dtype))
        self.fc1 = Conv2d(ip, embed_dim, 1, dtype=dtype)
        self.fc2 = Conv2d(2 * ip, embed_dim, 1, dtype=dtype)
        self.fc3 = Conv2d(4 * ip, embed_dim, 1, dtype=dtype)
        self.fc4 = Conv2d(4 * ip, embed_dim, 1, dtype=dtype)

    def _use_cm(self, y) -> bool:
        return (not self.training and use_spm_cm(y)
                and tail_supported(tuple(y.shape)))

    def _stem23_cm(self, a1):
        """stem2 -> BN -> ReLU -> stem3 -> BN -> ReLU on stem1's activated
        output a1 (B, ip, H, W); fp32 out, as the stock BatchNorm gives."""
        conv2, bn2, _, conv3, bn3 = list(self.stem)[3:8]
        B, ip = a1.shape[0], a1.shape[1]

        def bn_apply(bn):
            s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            t = bn.bias - bn.running_mean * s
            return s[None].expand(B, ip), t[None].expand(B, ip)

        zeros = torch.zeros(ip, device=a1.device)
        x = a1.to(conv2.compute_dtype)
        y2 = conv3x3_cm(x, conv2.weight, zeros, stats=False)
        y3 = conv3x3_cm(y2, conv3.weight, zeros, prologue=bn_apply(bn2),
                        leaky_slope=0.0, stats=False)
        s3, t3 = bn_apply(bn3)
        return F.relu(y3.float() * s3[:, :, None, None] + t3[:, :, None, None])

    def forward(self, x):
        y = self.stem[:3](x)
        y = self._stem23_cm(y) if self._use_cm(y) else self.stem[3:9](y)
        c1 = self.stem[9](y)
        c2 = self.conv2(c1)
        c3 = self.conv3(c2)
        c4 = self.conv4(c3)
        return (self.fc1(c1),
                self.fc2(c2).flatten(2).transpose(1, 2),
                self.fc3(c3).flatten(2).transpose(1, 2),
                self.fc4(c4).flatten(2).transpose(1, 2))


class DINOv3Adapter(nn.Module):
    """Backbone + SPM + 4 interaction blocks + scale assembly + BatchNorm.
    forward(x (B, 3, H, W)) -> 4 fp32 NCHW maps at 1/4, 1/8, 1/16, 1/32.

    Train mode: the drop-path draws of all extractors are taken from
    `drop_path_generator` (a CPU torch.Generator; None uses the default
    generator) before the interaction blocks run, so that the checkpointed
    recompute of a block (`remat`) sees the same draws."""

    def __init__(self, backbone: DinoViT, interaction_indexes: Sequence[int],
                 embed_dim: int, conv_inplane: int = 64, n_points: int = 4,
                 deform_num_heads: int = 16, cffn_ratio: float = 0.25,
                 deform_ratio: float = 0.5, patch_size: int = 16,
                 dtype: torch.dtype = torch.bfloat16, drop_path_rate: float = 0.0,
                 remat: bool = False):
        super().__init__()
        self.backbone = backbone
        self.interaction_indexes = tuple(interaction_indexes)
        self.patch_size = patch_size
        self.drop_path_rate = drop_path_rate
        self.remat = remat
        self.drop_path_generator: Optional[torch.Generator] = None
        E = embed_dim
        self.level_embed = nn.Parameter(torch.zeros(3, E))
        self.spm = SpatialPriorModule(conv_inplane, E, dtype)
        n = len(self.interaction_indexes)
        self.interactions = nn.ModuleList([
            InteractionBlock(E, deform_num_heads, n_points, deform_ratio,
                             cffn_ratio, i == n - 1, dtype, drop_path_rate)
            for i in range(n)])
        self.up = TransposedConv(E, E, (2, 2), dtype=dtype)
        self.norm1 = BatchNorm(E)
        self.norm2 = BatchNorm(E)
        self.norm3 = BatchNorm(E)
        self.norm4 = BatchNorm(E)

    def init_params(self, gen):
        with torch.no_grad():
            self.level_embed.normal_(0.0, 1.0, generator=gen)

    def forward(self, x):
        B, _, H, W = x.shape
        E = self.level_embed.shape[1]
        H_c, W_c = H // 16, W // 16
        H_t, W_t = H // self.patch_size, W // self.patch_size
        # the frozen backbone: no graph, outputs detached (stop_gradient)
        with torch.no_grad():
            backbone_outputs = self.backbone(x, self.interaction_indexes)

        c1, c2, c3, c4 = self.spm(x)
        le = self.level_embed.to(c2.dtype)
        n2, n3 = c2.shape[1], c3.shape[1]
        c = torch.cat([c2 + le[0], c3 + le[1], c4 + le[2]], dim=1)

        ref_points = reference_points_for_grids(
            [(H // 8, W // 8), (H // 16, W // 16), (H // 32, W // 32)], x.device)
        value_shapes = ((H_t, W_t),)
        outs, stats = [], None
        for block, (vit_tokens, _cls) in zip(self.interactions, backbone_outputs):
            if not self.training:
                c, stats = block(vit_tokens, c, ref_points, value_shapes, H_c,
                                 W_c, stats)
            else:
                keeps = None
                if self.drop_path_rate > 0:
                    keeps = [drop_path_keep(B, self.drop_path_rate,
                                            self.drop_path_generator)
                             for _ in range(block.n_extractors)]
                if self.remat and torch.is_grad_enabled():
                    c, _ = checkpoint(block, vit_tokens, c, ref_points,
                                      value_shapes, H_c, W_c, None, keeps,
                                      use_reentrant=False)
                else:
                    c, _ = block(vit_tokens, c, ref_points, value_shapes, H_c,
                                 W_c, None, keeps)
            outs.append(vit_tokens.transpose(1, 2).reshape(B, E, H_t, W_t))

        def spatial(t, h, w):
            return t.transpose(1, 2).reshape(B, E, h, w)

        c2 = spatial(c[:, :n2], 2 * H_c, 2 * W_c)
        c3 = spatial(c[:, n2:n2 + n3], H_c, W_c)
        c4 = spatial(c[:, n2 + n3:], H_c // 2, W_c // 2)
        c1 = self.up(c2) + c1
        c1 = c1 + bilinear_resize(outs[0], (4 * H_c, 4 * W_c))
        c2 = c2 + bilinear_resize(outs[1], (2 * H_c, 2 * W_c))
        c3 = c3 + bilinear_resize(outs[2], (H_c, W_c))
        c4 = c4 + bilinear_resize(outs[3], (H_c // 2, W_c // 2))
        return [self.norm1(c1), self.norm2(c2), self.norm3(c3), self.norm4(c4)]
