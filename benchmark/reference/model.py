"""Plain PyTorch reference of DinoUNet: frozen DINOv3 ViT, ViT-Adapter, FAPM,
nnU-Net decoder, in float32, with no kernel and no fused path.

It imports nothing of the program. Module nesting and parameter names are
those of the published reference (``encoder.dinov3_adapter.backbone.blocks.0
.attn.qkv.weight``, ``decoder.seg_layers.2.bias``, ...), which the program
keeps, so the benchmark's weight draw (``benchmark/weights.py``) fills both
alike by name. Each layer follows the published description:

- ViT (DINOv3): a stride-16 patch conv, a cls and 4 storage tokens, pre-norm
  blocks with LayerScale residuals, axial RoPE (``normalize_coords=
  "separate"``, base 100) on the patch tokens, an exact-GELU MLP or, for the
  7B, a SwiGLU ``w3(silu(w1 x) * w2 x)``; the patch tokens of the blocks in
  ``interaction_indexes`` after the final LayerNorm.
- ViT-Adapter: the spatial prior module (a conv stem and three stride-2
  stages with BatchNorm and ReLU, 1x1 projections), extractors of multi-scale
  deformable attention (``F.grid_sample``, bilinear, zero padding,
  ``align_corners=False``, one value level, 4 points) and a ConvFFN with a
  depthwise 3x3 per scale group, drop-path on the ConvFFN branch in training,
  the last interaction with two extra extractors; the four maps assembled
  with a 2x transposed conv, bilinear resizes of the ViT tokens and
  BatchNorm.
- FAPM: shared and per-scale 1x1 bases, FiLM, a refinement (1x1, norm, leaky
  ReLU, depthwise-separable 3x3, 1x1, squeeze-excitation) plus a projected
  shortcut; learnable 2x upsampling to each skip's size.
- Decoder: per stage a 2x transposed conv, concatenation with the skip, two
  3x3 conv + InstanceNorm + leaky ReLU blocks; a 1x1 head on the top stage.

The frozen backbone's matrices may be held in bfloat16 (the type the
program serves them in, so both sides hold the same numbers); every product
upcasts them to float32. Departures from the published models: none in the
arithmetic; the adapter's deformable attention has one value level, as the
DinoUNet reference builds it.
"""

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


@dataclass(frozen=True)
class RefConfig:
    embed_dim: int
    depth: int
    num_heads: int
    ffn_layer: str
    ffn_hidden: int
    qkv_bias: bool
    proj_bias: bool
    ffn_bias: bool
    n_storage_tokens: int
    patch_size: int
    rope_base: float
    interaction_indexes: Tuple[int, ...]
    features: Tuple[int, ...]
    n_conv_decoder: Tuple[int, ...]
    num_classes: int
    conv_bias: bool
    fapm_rank: int
    conv_inplane: int
    n_points: int
    deform_heads: int
    deform_ratio: float
    cffn_ratio: float
    drop_path_rate: float
    leaky_slope: float = 0.01

    @classmethod
    def from_bench(cls, cfg: dict) -> "RefConfig":
        vit, ad, dec = cfg["backbone"], cfg["adapter"], cfg["decoder"]
        return cls(embed_dim=vit["embed_dim"], depth=vit["depth"], num_heads=vit["num_heads"],
                   ffn_layer=vit["ffn_layer"], ffn_hidden=vit["ffn_hidden"],
                   qkv_bias=vit["qkv_bias"], proj_bias=vit["proj_bias"],
                   ffn_bias=vit["ffn_bias"], n_storage_tokens=vit["n_storage_tokens"],
                   patch_size=vit["patch_size"], rope_base=vit["rope_base"],
                   interaction_indexes=tuple(vit["interaction_indexes"]),
                   features=tuple(dec["features_per_stage"]),
                   n_conv_decoder=tuple(dec["n_conv_per_stage_decoder"]),
                   num_classes=cfg["assumed"]["num_classes"], conv_bias=dec["conv_bias"],
                   fapm_rank=dec["fapm_rank"], conv_inplane=ad["conv_inplane"],
                   n_points=ad["n_points"], deform_heads=ad["deform_num_heads"],
                   deform_ratio=ad["deform_ratio"], cffn_ratio=ad["cffn_ratio"],
                   drop_path_rate=ad["drop_path_rate"])


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float()


class Lin(nn.Linear):
    def forward(self, x):
        return F.linear(x.float(), self.weight.float(), _f32(self.bias))


class Conv(nn.Conv2d):
    def forward(self, x):
        return F.conv2d(x.float(), self.weight.float(), _f32(self.bias), self.stride,
                        self.padding, self.dilation, self.groups)


class ConvT(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(x.float(), self.weight.float(), _f32(self.bias),
                                  self.stride)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps)


class BatchNorm(nn.BatchNorm2d):
    """Batch statistics in training (the biased variance), running
    statistics otherwise."""

    def forward(self, x):
        return F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                            self.bias, self.training, 0.1, self.eps)


class InstanceNorm(nn.Module):
    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.instance_norm(x.float(), weight=self.weight, bias=self.bias, eps=self.eps)


class LeakyReLU(nn.Module):
    def __init__(self, slope: float):
        super().__init__()
        self.slope = slope

    def forward(self, x):
        return F.leaky_relu(x, self.slope)


# ----------------------------------------------------------------- backbone


def rope_tables(h: int, w: int, head_dim: int, base: float, device):
    """Axial RoPE angles of an h x w patch grid: coordinates at the cell
    centres in [-1, 1] per axis, head_dim / 4 periods base^(2i / (head_dim /
    2)), the (y, x) angles concatenated and repeated for the two halves."""
    periods = base ** (2 * torch.arange(head_dim // 4, dtype=torch.float64, device=device)
                       / (head_dim // 2))
    ys = (torch.arange(h, dtype=torch.float64, device=device) + 0.5) / h * 2 - 1
    xs = (torch.arange(w, dtype=torch.float64, device=device) + 0.5) / w * 2 - 1
    coords = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), -1).reshape(h * w, 2)
    angles = (2 * math.pi * coords[:, :, None] / periods).reshape(h * w, head_dim // 2)
    angles = angles.repeat(1, 2)
    return torch.sin(angles).float(), torch.cos(angles).float()


def apply_rope(x, sin, cos):
    """x (B, M, N, Dh): x cos + rotate_half(x) sin, rotate_half = (-x2, x1)."""
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class Attention(nn.Module):
    def __init__(self, cfg: RefConfig):
        super().__init__()
        E = cfg.embed_dim
        self.heads = cfg.num_heads
        self.qkv = Lin(E, 3 * E, bias=cfg.qkv_bias)
        self.proj = Lin(E, E, bias=cfg.proj_bias)

    def forward(self, x, sin, cos):
        B, N, E = x.shape
        M = self.heads
        qkv = self.qkv(x).view(B, N, 3, M, E // M).permute(2, 0, 3, 1, 4)
        q, k, v = apply_rope(qkv[0], sin, cos), apply_rope(qkv[1], sin, cos), qkv[2]
        s = torch.einsum("bmnd,bmkd->bmnk", q, k) / math.sqrt(E // M)
        o = torch.einsum("bmnk,bmkd->bmnd", torch.softmax(s, dim=-1), v)
        return self.proj(o.transpose(1, 2).reshape(B, N, E))


class Mlp(nn.Module):
    def __init__(self, cfg: RefConfig):
        super().__init__()
        self.fc1 = Lin(cfg.embed_dim, cfg.ffn_hidden, bias=cfg.ffn_bias)
        self.fc2 = Lin(cfg.ffn_hidden, cfg.embed_dim, bias=cfg.ffn_bias)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwiGLU(nn.Module):
    def __init__(self, cfg: RefConfig):
        super().__init__()
        self.w1 = Lin(cfg.embed_dim, cfg.ffn_hidden, bias=cfg.ffn_bias)
        self.w2 = Lin(cfg.embed_dim, cfg.ffn_hidden, bias=cfg.ffn_bias)
        self.w3 = Lin(cfg.ffn_hidden, cfg.embed_dim, bias=cfg.ffn_bias)

    def forward(self, x):
        return self.w3(F.silu(self.w1(x)) * self.w2(x))


class Block(nn.Module):
    def __init__(self, cfg: RefConfig):
        super().__init__()
        E = cfg.embed_dim
        self.norm1 = LayerNorm(E, eps=1e-5)
        self.attn = Attention(cfg)
        self.ls1 = LayerScale(E)
        self.norm2 = LayerNorm(E, eps=1e-5)
        self.mlp = Mlp(cfg) if cfg.ffn_layer == "mlp" else SwiGLU(cfg)
        self.ls2 = LayerScale(E)

    def forward(self, x, sin, cos):
        x = x + self.ls1.gamma * self.attn(self.norm1(x), sin, cos)
        return x + self.ls2.gamma * self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: RefConfig):
        super().__init__()
        self.proj = Conv(3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class ViT(nn.Module):
    def __init__(self, cfg: RefConfig):
        super().__init__()
        self.cfg = cfg
        E = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, E))
        self.storage_tokens = nn.Parameter(torch.zeros(1, cfg.n_storage_tokens, E))
        self.blocks = nn.ModuleList([Block(cfg) for _ in range(cfg.depth)])
        self.norm = LayerNorm(E, eps=1e-5)

    def forward(self, x) -> List[torch.Tensor]:
        cfg = self.cfg
        B, _, H, W = x.shape
        h, w = H // cfg.patch_size, W // cfg.patch_size
        prefix = torch.cat([self.cls_token, self.storage_tokens], 1).float()
        t = torch.cat([prefix.expand(B, -1, -1), self.patch_embed(x)], 1)
        sin, cos = rope_tables(h, w, cfg.embed_dim // cfg.num_heads, cfg.rope_base, x.device)
        n_pre = 1 + cfg.n_storage_tokens
        sin = torch.cat([torch.zeros_like(sin[:n_pre]), sin])
        cos = torch.cat([torch.ones_like(cos[:n_pre]), cos])
        outs = []
        for i, blk in enumerate(self.blocks):
            t = blk(t, sin, cos)
            if i in cfg.interaction_indexes:
                outs.append(self.norm(t)[:, n_pre:])
        return outs


# ------------------------------------------------------------------ adapter


def msda(value, ref, offsets, logits, hw: Tuple[int, int], heads: int, points: int):
    """One-level multi-scale deformable attention as the published
    ``ms_deform_attn_core_pytorch``: value (B, S, C), ref (Lq, 2) normalised
    (x, y), offsets (B, Lq, M * P * 2) in pixels, logits (B, Lq, M * P)."""
    B, S, C = value.shape
    Lq = ref.shape[0]
    H, W = hw
    D = C // heads
    off = offsets.view(B, Lq, heads, points, 2)
    size = torch.tensor([W, H], dtype=torch.float32, device=value.device)
    loc = ref[None, :, None, None, :] + off / size  # (B, Lq, M, P, 2)
    grid = (2 * loc - 1).permute(0, 2, 1, 3, 4).reshape(B * heads, Lq, points, 2)
    v = value.view(B, S, heads, D).permute(0, 2, 3, 1).reshape(B * heads, D, H, W)
    sampled = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=False)  # (B*M, D, Lq, P)
    a = torch.softmax(logits.view(B, Lq, heads, points), -1)
    a = a.permute(0, 2, 1, 3).reshape(B * heads, 1, Lq, points)
    out = (sampled * a).sum(-1).view(B, heads * D, Lq)
    return out.transpose(1, 2)


class MSDeformAttn(nn.Module):
    def __init__(self, dim: int, heads: int, points: int, ratio: float):
        super().__init__()
        self.heads, self.points = heads, points
        dv = int(dim * ratio)
        self.value_proj = Lin(dim, dv)
        self.sampling_offsets = Lin(dim, heads * points * 2)
        self.attention_weights = Lin(dim, heads * points)
        self.output_proj = Lin(dv, dim)

    def forward(self, query, ref, feat, hw):
        out = msda(self.value_proj(feat), ref, self.sampling_offsets(query),
                   self.attention_weights(query), hw, self.heads, self.points)
        return self.output_proj(out)


class DWConvMS(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x, H: int, W: int):
        B, N, C = x.shape
        n = N // 21
        outs = []
        for lo, hi, h, w in ((0, 16 * n, 2 * H, 2 * W), (16 * n, 20 * n, H, W),
                             (20 * n, N, H // 2, W // 2)):
            g = x[:, lo:hi].transpose(1, 2).reshape(B, C, h, w)
            outs.append(self.dwconv(g).flatten(2).transpose(1, 2))
        return torch.cat(outs, 1)


class ConvFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Lin(dim, hidden)
        self.dwconv = DWConvMS(hidden)
        self.fc2 = Lin(hidden, dim)

    def forward(self, x, H, W):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), H, W)))


class Extractor(nn.Module):
    def __init__(self, cfg: RefConfig):
        super().__init__()
        E = cfg.embed_dim
        self.query_norm = LayerNorm(E, eps=1e-6)
        self.feat_norm = LayerNorm(E, eps=1e-6)
        self.attn = MSDeformAttn(E, cfg.deform_heads, cfg.n_points, cfg.deform_ratio)
        self.ffn = ConvFFN(E, int(E * cfg.cffn_ratio))
        self.ffn_norm = LayerNorm(E, eps=1e-6)

    def forward(self, c, ref, feat, hw, H, W, keep, rate):
        c = c + self.attn(self.query_norm(c), ref, self.feat_norm(feat), hw)
        f = self.ffn(self.ffn_norm(c), H, W)
        if keep is not None:
            f = torch.where(keep.to(f.device)[:, None, None], f / (1 - rate),
                            torch.zeros_like(f))
        return c + f


class InteractionBlock(nn.Module):
    def __init__(self, cfg: RefConfig, extra: bool):
        super().__init__()
        self.extractor = Extractor(cfg)
        self.extra_extractors = (nn.ModuleList([Extractor(cfg), Extractor(cfg)])
                                 if extra else None)

    def extractors(self):
        return [self.extractor] + list(self.extra_extractors or [])


def _cbr(cin, cout, stride):
    return [Conv(cin, cout, 3, stride=stride, padding=1, bias=False), BatchNorm(cout),
            nn.ReLU()]


class SPM(nn.Module):
    def __init__(self, ip: int, E: int):
        super().__init__()
        self.stem = nn.Sequential(*_cbr(3, ip, 2), *_cbr(ip, ip, 1), *_cbr(ip, ip, 1),
                                  nn.MaxPool2d(3, stride=2, padding=1))
        self.conv2 = nn.Sequential(*_cbr(ip, 2 * ip, 2))
        self.conv3 = nn.Sequential(*_cbr(2 * ip, 4 * ip, 2))
        self.conv4 = nn.Sequential(*_cbr(4 * ip, 4 * ip, 2))
        self.fc1 = Conv(ip, E, 1)
        self.fc2 = Conv(2 * ip, E, 1)
        self.fc3 = Conv(4 * ip, E, 1)
        self.fc4 = Conv(4 * ip, E, 1)

    def forward(self, x):
        c1 = self.stem(x)
        c2 = self.conv2(c1)
        c3 = self.conv3(c2)
        c4 = self.conv4(c3)

        def tokens(t):
            return t.flatten(2).transpose(1, 2)

        return self.fc1(c1), tokens(self.fc2(c2)), tokens(self.fc3(c3)), tokens(self.fc4(c4))


def reference_points(grids, device):
    pts = []
    for h, w in grids:
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], -1))
    return torch.cat(pts)


def resize(x, size):
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


class Adapter(nn.Module):
    def __init__(self, cfg: RefConfig):
        super().__init__()
        self.cfg = cfg
        E = cfg.embed_dim
        self.backbone = ViT(cfg)
        self.level_embed = nn.Parameter(torch.zeros(3, E))
        self.spm = SPM(cfg.conv_inplane, E)
        n = len(cfg.interaction_indexes)
        self.interactions = nn.ModuleList([InteractionBlock(cfg, i == n - 1)
                                           for i in range(n)])
        self.up = ConvT(E, E, 2, stride=2)
        self.norm1, self.norm2, self.norm3, self.norm4 = (BatchNorm(E) for _ in range(4))

    def forward(self, x, keeps=None):
        """keeps: per interaction block, per extractor, a (B,) bool drop-path
        draw (training), or None."""
        cfg = self.cfg
        B, _, H, W = x.shape
        E = cfg.embed_dim
        Hc, Wc = H // 16, W // 16
        ht, wt = H // cfg.patch_size, W // cfg.patch_size
        with torch.no_grad():
            vit_outs = self.backbone(x)
        c1, c2, c3, c4 = self.spm(x)
        n2, n3 = c2.shape[1], c3.shape[1]
        c = torch.cat([c2 + self.level_embed[0], c3 + self.level_embed[1],
                       c4 + self.level_embed[2]], 1)
        ref = reference_points([(H // 8, W // 8), (Hc, Wc), (H // 32, W // 32)], x.device)
        maps = []
        for bi, (block, tok) in enumerate(zip(self.interactions, vit_outs)):
            for ei, ex in enumerate(block.extractors()):
                keep = None if keeps is None else keeps[bi][ei]
                args = (c, ref, tok, (ht, wt), Hc, Wc, keep, cfg.drop_path_rate)
                # in training each extractor's activations are recomputed in
                # the backward, so that the 7B's adapter fits beside its backbone
                c = (checkpoint(ex, *args, use_reentrant=False)
                     if self.training and torch.is_grad_enabled() else ex(*args))
            maps.append(tok.transpose(1, 2).reshape(B, E, ht, wt))

        def spatial(t, h, w):
            return t.transpose(1, 2).reshape(B, E, h, w)

        c2 = spatial(c[:, :n2], 2 * Hc, 2 * Wc)
        c3 = spatial(c[:, n2:n2 + n3], Hc, Wc)
        c4 = spatial(c[:, n2 + n3:], Hc // 2, Wc // 2)
        c1 = self.up(c2) + c1
        c1 = c1 + resize(maps[0], (4 * Hc, 4 * Wc))
        c2 = c2 + resize(maps[1], (2 * Hc, 2 * Wc))
        c3 = c3 + resize(maps[2], (Hc, Wc))
        c4 = c4 + resize(maps[3], (Hc // 2, Wc // 2))
        return [self.norm1(c1), self.norm2(c2), self.norm3(c3), self.norm4(c4)]


# --------------------------------------------------------- FAPM and decoder


class SE(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        r = max(1, c // 16)
        self.fc = nn.Sequential(Conv(c, r, 1), nn.ReLU(), Conv(r, c, 1))

    def forward(self, x):
        return x * torch.sigmoid(self.fc(x.mean(dim=(2, 3), keepdim=True)))


class DSConv(nn.Module):
    def __init__(self, c: int, bias: bool, slope: float):
        super().__init__()
        self.depthwise = Conv(c, c, 3, padding=1, groups=c, bias=bias)
        self.pointwise = Conv(c, c, 1, bias=bias)
        self.bn = InstanceNorm(c)
        self.act = LeakyReLU(slope)

    def forward(self, x):
        return self.act(self.bn(self.pointwise(self.depthwise(x))))


class FAPM(nn.Module):
    def __init__(self, cfg: RefConfig):
        super().__init__()
        E, r, b, s = cfg.embed_dim, cfg.fapm_rank, cfg.conv_bias, cfg.leaky_slope
        self.rank = r
        self.shared_basis = Conv(E, r, 1, bias=b)
        self.specific_bases = nn.ModuleList([Conv(E, r, 1, bias=b) for _ in cfg.features])
        self.film_generators = nn.ModuleList([Conv(r, 2 * r, 1, bias=b) for _ in cfg.features])
        self.refinement_blocks = nn.ModuleList([
            nn.Sequential(Conv(r, oc, 1, bias=b), InstanceNorm(oc), LeakyReLU(s),
                          DSConv(oc, b, s), Conv(oc, oc, 1, bias=b), SE(oc))
            for oc in cfg.features])
        self.shortcut_projections = nn.ModuleList([
            Conv(r, oc, 1, bias=b) if oc != r else nn.Identity() for oc in cfg.features])

    def forward(self, xs):
        outs = []
        for i, x in enumerate(xs):
            gamma, beta = torch.split(self.film_generators[i](self.shared_basis(x)),
                                      self.rank, 1)
            z = gamma * self.specific_bases[i](x) + beta
            outs.append(self.refinement_blocks[i](z) + self.shortcut_projections[i](z))
        return outs


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.up2 = ConvT(c, c, 2, stride=2)

    def forward(self, x, size):
        while x.shape[2] * 2 <= size[0] and x.shape[3] * 2 <= size[1]:
            x = self.up2(x)
        return resize(x, size)


class Encoder(nn.Module):
    def __init__(self, cfg: RefConfig):
        super().__init__()
        self.dinov3_adapter = Adapter(cfg)
        self.fapm = FAPM(cfg)
        self.ups = nn.ModuleList([Upsample(c) for c in cfg.features])

    def forward(self, x, keeps=None):
        H, W = x.shape[2:]
        feats = self.fapm(self.dinov3_adapter(x, keeps))
        return [up(f, (H // 2 ** i, W // 2 ** i)) for i, (up, f) in enumerate(zip(self.ups, feats))]


class ConvNormAct(nn.Module):
    def __init__(self, cin, cout, bias, slope):
        super().__init__()
        self.conv = Conv(cin, cout, 3, padding=1, bias=bias)
        self.norm = InstanceNorm(cout)
        self.nonlin = LeakyReLU(slope)

    def forward(self, x):
        return self.nonlin(self.norm(self.conv(x)))


class Stage(nn.Module):
    def __init__(self, n, cin, cout, bias, slope):
        super().__init__()
        self.convs = nn.Sequential(*[ConvNormAct(cin if i == 0 else cout, cout, bias, slope)
                                     for i in range(n)])

    def forward(self, x):
        return self.convs(x)


class Decoder(nn.Module):
    def __init__(self, cfg: RefConfig):
        super().__init__()
        f, b, s = cfg.features, cfg.conv_bias, cfg.leaky_slope
        self.transpconvs = nn.ModuleList()
        self.stages = nn.ModuleList()
        self.seg_layers = nn.ModuleList()
        for i in range(1, len(f)):
            below, skip = f[-i], f[-(i + 1)]
            self.transpconvs.append(ConvT(below, skip, 2, stride=2, bias=b))
            self.stages.append(Stage(cfg.n_conv_decoder[i - 1], 2 * skip, skip, b, s))
            self.seg_layers.append(Conv(skip, cfg.num_classes, 1))

    def forward(self, skips):
        x = skips[-1]
        for i, (up, stage) in enumerate(zip(self.transpconvs, self.stages)):
            x = stage(torch.cat([up(x), skips[-(i + 2)]], 1))
        return self.seg_layers[-1](x)


class DinoUNetRef(nn.Module):
    """forward(x (B, C, H, W)) -> float32 logits (B, classes, H, W)."""

    def __init__(self, cfg: RefConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.encoder.dinov3_adapter.backbone.requires_grad_(False)

    @staticmethod
    def three_channels(x):
        """The backbone's three input channels from the case's C."""
        C = x.shape[1]
        if C == 1:
            return x.expand(-1, 3, -1, -1).float()
        if C == 2:
            return torch.cat([x, x[:, :1]], 1).float()
        return x[:, :3].float()

    def forward(self, x, keeps=None):
        return self.decoder(self.encoder(self.three_channels(x), keeps))


def build(cfg: dict, device, backbone_dtype=torch.bfloat16) -> DinoUNetRef:
    """The reference on `device`, its backbone's matrices held in
    `backbone_dtype` (the type the program serves them in), every other
    parameter float32. The parameters are left unset, for the benchmark's
    weight draw; the BatchNorms' running statistics start at (0, 1)."""
    with torch.device("meta"):
        model = DinoUNetRef(RefConfig.from_bench(cfg))
    for p in model.encoder.dinov3_adapter.backbone.parameters():
        if p.dim() >= 2:
            p.data = p.data.to(backbone_dtype)
    model.to_empty(device=device)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_running_stats()
    return model


def n_extractors(cfg: dict) -> Sequence[int]:
    n = len(cfg["backbone"]["interaction_indexes"])
    return [3 if i == n - 1 else 1 for i in range(n)]
