"""2-D and 3-D training augmentation on the device, PyTorch.

Counterpart of ``dinounet_tpu/training/augmentation.py``
(ref: nnUNetTrainer.py:683-805 and training/data_augmentation/*): rotation and
scaling with a centre crop from the enlarged loader patch, Gaussian noise,
Gaussian blur, multiplicative brightness, range-preserving contrast,
low-resolution simulation, inverted and plain gamma (statistics-retaining),
mirroring, nonzero-mask zeroing and the -1 -> 0 label cleanup. The warp is
bilinear for the data and nearest for the labels, as in the JAX package
(a Catmull-Rom cubic warp with ``data_interp_order=3``).

Each sample is split into its random draws (``draw_augment``: every coin flip
and every random value the JAX ``_augment_one`` takes from its key, drawn
here on the host from a CPU ``torch.Generator``) and a deterministic function
of the draws (``apply_augment``, on the tensors' device). The two packages'
generators give different numbers, so the tests feed ``apply_augment`` the
draws recomputed from a JAX key and compare with JAX's ``_augment_one``.
Arithmetic is fp32 in the JAX function's order.

The 3-D augmentation (``draw_augment_3d`` / ``apply_augment_3d``, JAX
``augmentation.py:340-543``) is the same split: rotation about the three axes
(R = Rx Ry Rz) and scaling (in-plane only for dummy-2D), trilinear for the
data and nearest for the labels, noise, a separable blur over the three
axes, brightness, contrast, both gammas and mirroring. The deep-supervision
targets come from ``downsample_seg_for_ds``.

Layout is the port's: data (C, H, W) or (C, D, H, W) float32 per sample,
(B, C, ...) per batch; labels (H, W) / (D, H, W) or (S, ...) integers per
sample (extra channels, as the cascade's previous-stage map, follow the same
spatial transform).

The cascade's one-hot input (``draw_cascade`` / ``cascade_onehot_augment``,
JAX ``augmentation.py:541-700``) keeps the same split: the host draws each
channel's binary-operator coin, operator and radius, the sample's
remove-component coin and each channel's seed as a uniform number, which
picks the foreground voxel of that rank; the device computes the rest.
"""

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def get_enlarged_patch_size(final_patch_size, rot_max_rad: float,
                            scale_range=(0.85, 1.25)) -> np.ndarray:
    """Initial loader patch so that rotation + scaling never sample out of
    bounds (ref compute_initial_patch_size.py:4-24, the 2-D case)."""
    rot = min(90 / 360 * 2 * np.pi, abs(rot_max_rad))
    coords = np.array(final_patch_size[-2:], dtype=float)
    rotated = np.abs(np.array([
        coords[0] * np.cos(rot) + coords[1] * np.sin(rot),
        coords[0] * np.sin(rot) + coords[1] * np.cos(rot),
    ]))
    final_shape = np.maximum(rotated, coords)
    final_shape /= min(scale_range)
    return final_shape.astype(int)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    patch_size: Tuple[int, int] = (512, 512)  # final (network) patch size
    rotation_range: Tuple[float, float] = (-np.pi, np.pi)
    p_rotation: float = 0.2
    scale_range: Tuple[float, float] = (0.7, 1.4)
    p_scale: float = 0.2
    p_noise: float = 0.1
    noise_variance: Tuple[float, float] = (0.0, 0.1)
    p_blur: float = 0.2
    p_blur_per_channel: float = 0.5
    blur_sigma: Tuple[float, float] = (0.5, 1.0)
    p_brightness: float = 0.15
    brightness_range: Tuple[float, float] = (0.75, 1.25)
    p_contrast: float = 0.15
    contrast_range: Tuple[float, float] = (0.75, 1.25)
    p_lowres: float = 0.25
    p_lowres_per_channel: float = 0.5
    lowres_zoom: Tuple[float, float] = (0.5, 1.0)
    p_gamma_invert: float = 0.1
    p_gamma: float = 0.3
    gamma_range: Tuple[float, float] = (0.7, 1.5)
    mirror_axes: Tuple[int, ...] = (0, 1)
    use_mask_for_norm: Tuple[bool, ...] = ()
    data_interp_order: int = 1  # 1 bilinear, 3 cubic (Catmull-Rom)


@dataclasses.dataclass
class AugmentDraws:
    """The random part of one sample's augmentation. None (or 0 / 1 for the
    affine) means the transform is not applied."""
    angle: float = 0.0
    scale: float = 1.0
    noise: Optional[torch.Tensor] = None  # (C, H_out, W_out), std applied
    blur_sigmas: Tuple[Optional[float], ...] = ()  # per channel
    brightness: Optional[Tuple[float, ...]] = None  # per-channel factors
    contrast: Optional[Tuple[float, ...]] = None  # per-channel factors
    lowres_zooms: Tuple[Optional[float], ...] = ()  # per channel
    gamma_invert: Optional[float] = None
    gamma: Optional[float] = None
    flips: Tuple[bool, bool] = (False, False)  # (H axis, W axis)


def draw_augment(gen: torch.Generator, C: int, cfg: AugmentConfig) -> AugmentDraws:
    """One sample's draws from a CPU generator, with the JAX function's
    probabilities and ranges."""
    def u() -> float:
        return float(torch.rand((), generator=gen))

    def uniform(lo: float, hi: float, n: Optional[int] = None):
        if n is None:
            return lo + (hi - lo) * u()
        return tuple(lo + (hi - lo) * float(t) for t in torch.rand(n, generator=gen))

    d = AugmentDraws()
    if u() < cfg.p_rotation:
        d.angle = uniform(*cfg.rotation_range)
    if u() < cfg.p_scale:
        d.scale = uniform(*cfg.scale_range)
    if u() < cfg.p_noise:
        std = uniform(*cfg.noise_variance)
        d.noise = torch.randn((C, *cfg.patch_size), generator=gen) * std
    do_blur = u() < cfg.p_blur
    d.blur_sigmas = tuple(uniform(*cfg.blur_sigma) if do_blur and u() < cfg.p_blur_per_channel
                          else None for _ in range(C))
    if u() < cfg.p_brightness:
        d.brightness = uniform(*cfg.brightness_range, n=C)
    if u() < cfg.p_contrast:
        d.contrast = uniform(*cfg.contrast_range, n=C)
    do_lowres = u() < cfg.p_lowres
    d.lowres_zooms = tuple(uniform(*cfg.lowres_zoom)
                           if do_lowres and u() < cfg.p_lowres_per_channel else None
                           for _ in range(C))
    for name, p in (("gamma_invert", cfg.p_gamma_invert), ("gamma", cfg.p_gamma)):
        if u() < p:
            g0, g1 = cfg.gamma_range
            setattr(d, name, uniform(g0, 1.0) if u() < 0.5 else uniform(1.0, g1))
    d.flips = tuple(axis in cfg.mirror_axes and u() < 0.5 for axis in (0, 1))
    return d


def _affine_coords(angle: float, scale: float, in_hw, out_hw, device):
    """Source coordinates (h, w) of every output pixel: rotation by `angle`
    and scaling of the sampling grid about the centres (scale > 1 zooms
    out, as batchgenerators does)."""
    f32 = torch.float32
    H_in, W_in = in_hw
    H_out, W_out = out_hw
    cos = torch.cos(torch.tensor(angle, dtype=f32, device=device))
    sin = torch.sin(torch.tensor(angle, dtype=f32, device=device))
    scale = torch.tensor(scale, dtype=f32, device=device)
    yy = (torch.arange(H_out, dtype=f32, device=device) - (H_out - 1) / 2.0)[:, None]
    xx = (torch.arange(W_out, dtype=f32, device=device) - (W_out - 1) / 2.0)[None, :]
    src_y = (cos * yy - sin * xx) * scale + (H_in - 1) / 2.0
    src_x = (sin * yy + cos * xx) * scale + (W_in - 1) / 2.0
    return src_y, src_x


def _gather(img: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor, cval):
    """img (..., H, W) at integer (yy, xx) (h, w); cval outside."""
    H, W = img.shape[-2:]
    valid = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
    v = img.reshape(*img.shape[:-2], H * W)[..., idx]
    return torch.where(valid, v, torch.full_like(v, cval))


def _bilinear_sample(img: torch.Tensor, src_y, src_x, cval: float = 0.0):
    """img (C, H, W) float; src coords (h, w) -> (C, h, w)."""
    y0 = torch.floor(src_y)
    x0 = torch.floor(src_x)
    fy = src_y - y0
    fx = src_x - x0
    y0 = y0.long()
    x0 = x0.long()
    out = 0.0
    for dy, dx, w in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                      (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        out = out + _gather(img, y0 + dy, x0 + dx, cval) * w
    return out


def _cubic_sample(img: torch.Tensor, src_y, src_x, cval: float = 0.0):
    """Separable Catmull-Rom (a = -0.5) warp of img (C, H, W), 16 taps;
    outside taps contribute cval."""
    a = -0.5
    y0 = torch.floor(src_y)
    x0 = torch.floor(src_x)
    fy = src_y - y0
    fx = src_x - x0
    y0 = y0.long()
    x0 = x0.long()

    def cubic_w(d):
        ad = d.abs()
        w_near = (a + 2.0) * ad ** 3 - (a + 3.0) * ad ** 2 + 1.0
        w_far = a * ad ** 3 - 5.0 * a * ad ** 2 + 8.0 * a * ad - 4.0 * a
        return torch.where(ad <= 1.0, w_near,
                           torch.where(ad < 2.0, w_far, torch.zeros_like(ad)))

    taps = (-1, 0, 1, 2)
    wy = [cubic_w(fy - t) for t in taps]
    wx = [cubic_w(fx - t) for t in taps]
    out = 0.0
    for iy, dy in enumerate(taps):
        for ix, dx in enumerate(taps):
            out = out + _gather(img, y0 + dy, x0 + dx, cval) * (wy[iy] * wx[ix])
    return out


def _nearest_sample(img: torch.Tensor, src_y, src_x, cval):
    """img (..., H, W) integer labels; nearest neighbour (round half to
    even), cval outside."""
    return _gather(img, torch.round(src_y).long(), torch.round(src_x).long(), cval)


def _gaussian_kernel(sigma: float, device, radius: int = 4) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    s = torch.clamp(torch.tensor(sigma, dtype=torch.float32, device=device), min=1e-6)
    k = torch.exp(-0.5 * (x / s) ** 2)
    return k / k.sum()


def _blur_channel(img2d: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of one (H, W) channel, edge-padded: along H,
    then along W."""
    k = _gaussian_kernel(sigma, img2d.device)
    r = (k.shape[0] - 1) // 2
    x = F.pad(img2d[None, None], (0, 0, r, r), mode="replicate")
    x = F.conv2d(x, k.view(1, 1, -1, 1))
    x = F.pad(x, (r, r, 0, 0), mode="replicate")
    return F.conv2d(x, k.view(1, 1, 1, -1))[0, 0]


def _lowres_channel(img2d: torch.Tensor, zoom: float) -> torch.Tensor:
    """Nearest 'pixelation' to a 1/zoom grid, sampled back bilinearly."""
    H, W = img2d.shape
    f32 = torch.float32
    step = 1.0 / torch.tensor(zoom, dtype=f32, device=img2d.device)
    ys = torch.arange(H, dtype=f32, device=img2d.device)
    xs = torch.arange(W, dtype=f32, device=img2d.device)
    snap_y = torch.floor(ys / step) * step + step / 2
    snap_x = torch.floor(xs / step) * step + step / 2
    yy = snap_y[:, None].expand(H, W)
    xx = snap_x[None, :].expand(H, W)
    return _bilinear_sample(img2d[None], yy, xx, 0.0)[0]


def _gamma(x: torch.Tensor, gamma: float, invert: bool) -> torch.Tensor:
    """Statistics-retaining gamma over the whole sample: rescale to [0, 1],
    power, back to the range, then restore mean and std."""
    xin = -x if invert else x
    mean, std = xin.mean(), xin.std(correction=0)
    mn = xin.min()
    rng = xin.max() - mn
    y = ((xin - mn) / torch.clamp(rng, min=1e-7)) ** gamma * rng + mn
    y = (y - y.mean()) / torch.clamp(y.std(correction=0), min=1e-8) * std + mean
    return -y if invert else y


def apply_augment(data: torch.Tensor, seg: torch.Tensor, d: AugmentDraws,
                  cfg: AugmentConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """data (C, H_in, W_in) float32; seg (H_in, W_in) or (S, H_in, W_in)
    integers -> the final patch, labels with -1 (outside) cleaned to 0."""
    H_out, W_out = cfg.patch_size
    dev = data.device

    # 1. spatial: rotation + scale + centre crop to the final patch
    src_y, src_x = _affine_coords(d.angle, d.scale, data.shape[-2:], (H_out, W_out), dev)
    sample = _cubic_sample if cfg.data_interp_order == 3 else _bilinear_sample
    x = sample(data.float(), src_y, src_x, 0.0)
    seg = _nearest_sample(seg, src_y, src_x, -1)

    # 2. gaussian noise
    if d.noise is not None:
        x = x + d.noise.to(dev)

    # 3. gaussian blur, 4. brightness, 5. contrast, 6. low resolution: per channel
    if any(s is not None for s in d.blur_sigmas):
        x = torch.stack([_blur_channel(x[c], s) if s is not None else x[c]
                         for c, s in enumerate(d.blur_sigmas)])
    if d.brightness is not None:
        x = x * torch.tensor(d.brightness, dtype=torch.float32, device=dev)[:, None, None]
    if d.contrast is not None:
        f = torch.tensor(d.contrast, dtype=torch.float32, device=dev)[:, None, None]
        mean = x.mean(dim=(1, 2), keepdim=True)
        mn = x.amin(dim=(1, 2), keepdim=True)
        mx = x.amax(dim=(1, 2), keepdim=True)
        x = torch.minimum(torch.maximum((x - mean) * f + mean, mn), mx)
    if any(z is not None for z in d.lowres_zooms):
        x = torch.stack([_lowres_channel(x[c], z) if z is not None else x[c]
                         for c, z in enumerate(d.lowres_zooms)])

    # 7. gamma (inverted, then plain), over the whole sample
    if d.gamma_invert is not None:
        x = _gamma(x, d.gamma_invert, True)
    if d.gamma is not None:
        x = _gamma(x, d.gamma, False)

    # 8. mirroring
    for axis, flip in zip((-2, -1), d.flips):
        if flip:
            x = torch.flip(x, (axis,))
            seg = torch.flip(seg, (axis,))

    # 9. nonzero-mask zeroing (MaskTransform) + label cleanup (-1 -> 0)
    if any(cfg.use_mask_for_norm):
        outside = (seg[0] if seg.ndim == 3 else seg) < 0
        x = torch.stack([torch.where(outside, torch.zeros_like(x[c]), x[c]) if use
                         else x[c] for c, use in enumerate(cfg.use_mask_for_norm)])
    seg = torch.where(seg < 0, torch.zeros_like(seg), seg)
    return x, seg


def augment_batch_2d(data: torch.Tensor, seg: torch.Tensor, cfg: AugmentConfig,
                     gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """data (B, C, H_in, W_in) float32, seg (B, H_in, W_in) or
    (B, S, H_in, W_in) integers -> the same ranks at cfg.patch_size; draws
    from the CPU generator `gen`, compute on the tensors' device."""
    outs: List[Tuple[torch.Tensor, torch.Tensor]] = [
        apply_augment(data[b], seg[b], draw_augment(gen, data.shape[1], cfg), cfg)
        for b in range(data.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])



def downsample_seg_for_ds(seg: torch.Tensor,
                          scales: Sequence[Tuple[float, ...]]) -> List[torch.Tensor]:
    """Nearest-neighbour label pyramids for deep supervision (ref
    deep_supervision_donwsampling.py:8): seg (B, *spatial) -> one map per
    scale, each spatial size round(size * scale). Nearest picks source index
    floor((i + 0.5) * in / out) in fp32, as ``jax.image.resize(method=
    "nearest")`` does."""
    outs = []
    for scale in scales:
        if all(s == 1 for s in scale):
            outs.append(seg)
            continue
        out = seg
        for axis, (n, sc) in enumerate(zip(seg.shape[1:], scale)):
            m = int(round(n * sc))
            idx = torch.floor((torch.arange(m, dtype=torch.float32) + 0.5) * n / m)
            idx = idx.long().to(seg.device)
            out = out.index_select(axis + 1, idx)
        outs.append(out)
    return outs


# --------------------------------------------------------------------------- 3-D


def get_enlarged_patch_size_3d(final_patch_size, rot_rad_per_axis,
                               scale_range=(0.85, 1.25)) -> np.ndarray:
    """3-D loader patch: per rotation axis, the two other dims grow by the
    rotated-corner bound, then all divide by the smallest scale (ref
    compute_initial_patch_size.py:4-24, the 3-D case)."""
    rots = [min(90 / 360 * 2 * np.pi, abs(r)) for r in (
        rot_rad_per_axis if isinstance(rot_rad_per_axis, (tuple, list))
        else (rot_rad_per_axis,) * 3)]
    coords = np.array(final_patch_size[-3:], dtype=float)
    final_shape = coords.copy()
    for k, rot in enumerate(rots[:3]):
        i, j = [a for a in range(3) if a != k]
        ci, cj = coords[i], coords[j]
        final_shape[i] = max(final_shape[i], abs(ci * np.cos(rot) + cj * np.sin(rot)))
        final_shape[j] = max(final_shape[j], abs(ci * np.sin(rot) + cj * np.cos(rot)))
    final_shape /= min(scale_range)
    return final_shape.astype(int)


@dataclasses.dataclass(frozen=True)
class AugmentConfig3D:
    """The JAX package's 3-D configuration (ref nnUNetTrainer.py:391-446:
    +-30 degrees about each axis for near-isotropic patches, in-plane only
    for dummy-2D)."""
    patch_size: Tuple[int, int, int] = (64, 128, 128)
    rotation_ranges: Tuple[Tuple[float, float], ...] = (
        (-0.5236, 0.5236),) * 3  # 30 deg
    p_rotation: float = 0.2
    scale_range: Tuple[float, float] = (0.7, 1.4)
    p_scale: float = 0.2
    p_noise: float = 0.1
    noise_variance: Tuple[float, float] = (0.0, 0.1)
    p_blur: float = 0.2
    p_blur_per_channel: float = 0.5
    blur_sigma: Tuple[float, float] = (0.5, 1.0)
    p_brightness: float = 0.15
    brightness_range: Tuple[float, float] = (0.75, 1.25)
    p_contrast: float = 0.15
    contrast_range: Tuple[float, float] = (0.75, 1.25)
    p_gamma_invert: float = 0.1
    p_gamma: float = 0.3
    gamma_range: Tuple[float, float] = (0.7, 1.5)
    mirror_axes: Tuple[int, ...] = (0, 1, 2)
    use_mask_for_norm: Tuple[bool, ...] = ()
    scale_in_plane_only: bool = False  # dummy-2D: never scale through-plane


@dataclasses.dataclass
class AugmentDraws3D:
    """The random part of one 3-D sample's augmentation (see AugmentDraws)."""
    angles: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    scale: float = 1.0
    noise: Optional[torch.Tensor] = None  # (C, D_out, H_out, W_out), std applied
    blur_sigmas: Tuple[Optional[float], ...] = ()
    brightness: Optional[Tuple[float, ...]] = None
    contrast: Optional[Tuple[float, ...]] = None
    gamma_invert: Optional[float] = None
    gamma: Optional[float] = None
    flips: Tuple[bool, bool, bool] = (False, False, False)  # (D, H, W)


def draw_augment_3d(gen: torch.Generator, C: int, cfg: AugmentConfig3D) -> AugmentDraws3D:
    """One 3-D sample's draws from a CPU generator, with the JAX function's
    probabilities and ranges."""
    def u() -> float:
        return float(torch.rand((), generator=gen))

    def uniform(lo: float, hi: float, n: Optional[int] = None):
        if n is None:
            return lo + (hi - lo) * u()
        return tuple(lo + (hi - lo) * float(t) for t in torch.rand(n, generator=gen))

    d = AugmentDraws3D()
    if u() < cfg.p_rotation:
        d.angles = tuple(uniform(lo, hi) for lo, hi in cfg.rotation_ranges)
    if u() < cfg.p_scale:
        d.scale = uniform(*cfg.scale_range)
    if u() < cfg.p_noise:
        std = uniform(*cfg.noise_variance)
        d.noise = torch.randn((C, *cfg.patch_size), generator=gen) * std
    do_blur = u() < cfg.p_blur
    d.blur_sigmas = tuple(uniform(*cfg.blur_sigma) if do_blur and u() < cfg.p_blur_per_channel
                          else None for _ in range(C))
    if u() < cfg.p_brightness:
        d.brightness = uniform(*cfg.brightness_range, n=C)
    if u() < cfg.p_contrast:
        d.contrast = uniform(*cfg.contrast_range, n=C)
    for name, p in (("gamma_invert", cfg.p_gamma_invert), ("gamma", cfg.p_gamma)):
        if u() < p:
            g0, g1 = cfg.gamma_range
            setattr(d, name, uniform(g0, 1.0) if u() < 0.5 else uniform(1.0, g1))
    d.flips = tuple(axis in cfg.mirror_axes and u() < 0.5 for axis in (0, 1, 2))
    return d


def _rotation_matrix_3d(angles, device) -> torch.Tensor:
    """R = Rx(ax) @ Ry(ay) @ Rz(az) (batchgenerators' order), fp32."""
    a = torch.tensor(angles, dtype=torch.float32, device=device)
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(c[0]), torch.zeros_like(c[0])
    rx = torch.stack([torch.stack([one, zero, zero]), torch.stack([zero, c[0], -s[0]]),
                      torch.stack([zero, s[0], c[0]])])
    ry = torch.stack([torch.stack([c[1], zero, s[1]]), torch.stack([zero, one, zero]),
                      torch.stack([-s[1], zero, c[1]])])
    rz = torch.stack([torch.stack([c[2], -s[2], zero]), torch.stack([s[2], c[2], zero]),
                      torch.stack([zero, zero, one])])
    return rx @ ry @ rz


def _affine_coords_3d(angles, scale: float, in_shape, out_shape,
                      scale_in_plane_only: bool, device):
    """Source coordinates (z, y, x) of every output voxel: the grid about
    its centre rotated by R, scaled (the through-plane axis kept at 1 for
    dummy-2D) and moved to the input's centre."""
    f32 = torch.float32
    R = _rotation_matrix_3d(angles, device)
    sc = torch.tensor(scale, dtype=f32, device=device)
    if scale_in_plane_only:
        scale_vec = (torch.tensor([1.0, 0.0, 0.0], dtype=f32, device=device)
                     + sc * torch.tensor([0.0, 1.0, 1.0], dtype=f32, device=device))
    else:
        scale_vec = torch.ones(3, dtype=f32, device=device) * sc
    centers_in = torch.tensor([(n - 1) / 2.0 for n in in_shape], dtype=f32, device=device)
    grids = torch.meshgrid(*[torch.arange(n, dtype=f32, device=device) - (n - 1) / 2.0
                             for n in out_shape], indexing="ij")
    coords = torch.stack(grids, dim=-1)
    src = coords @ R.T * scale_vec + centers_in
    return src[..., 0], src[..., 1], src[..., 2]


def _gather_3d(vol: torch.Tensor, zz, yy, xx, cval):
    """vol (..., D, H, W) at integer (zz, yy, xx); cval outside."""
    D, H, W = vol.shape[-3:]
    valid = (zz >= 0) & (zz < D) & (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    idx = (zz.clamp(0, D - 1) * H + yy.clamp(0, H - 1)) * W + xx.clamp(0, W - 1)
    v = vol.reshape(*vol.shape[:-3], D * H * W)[..., idx]
    return torch.where(valid, v, torch.full_like(v, cval))


def _trilinear_sample(vol: torch.Tensor, sz, sy, sx, cval: float = 0.0):
    """vol (C, D, H, W) float; src coords (*out) -> (C, *out), the eight
    taps in the JAX function's order."""
    z0, y0, x0 = torch.floor(sz), torch.floor(sy), torch.floor(sx)
    fz, fy, fx = sz - z0, sy - y0, sx - x0
    z0, y0, x0 = z0.long(), y0.long(), x0.long()
    out = 0.0
    for dz in (0, 1):
        wz = (1 - fz) if dz == 0 else fz
        for dy in (0, 1):
            wy = (1 - fy) if dy == 0 else fy
            for dx in (0, 1):
                wx = (1 - fx) if dx == 0 else fx
                out = out + _gather_3d(vol, z0 + dz, y0 + dy, x0 + dx, cval) * (wz * wy * wx)
    return out


def _nearest_sample_3d(vol: torch.Tensor, sz, sy, sx, cval):
    """vol (..., D, H, W) integer labels; nearest (round half to even),
    cval outside."""
    return _gather_3d(vol, torch.round(sz).long(), torch.round(sy).long(),
                      torch.round(sx).long(), cval)


def _blur_volume(vol3d: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of one (D, H, W) channel, edge-padded: along
    W, then H, then D, as the JAX function does."""
    k = _gaussian_kernel(sigma, vol3d.device)
    r = (k.shape[0] - 1) // 2
    x = vol3d[None, None]
    x = F.conv3d(F.pad(x, (r, r, 0, 0, 0, 0), mode="replicate"), k.view(1, 1, 1, 1, -1))
    x = F.conv3d(F.pad(x, (0, 0, r, r, 0, 0), mode="replicate"), k.view(1, 1, 1, -1, 1))
    x = F.conv3d(F.pad(x, (0, 0, 0, 0, r, r), mode="replicate"), k.view(1, 1, -1, 1, 1))
    return x[0, 0]


def apply_augment_3d(data: torch.Tensor, seg: torch.Tensor, d: AugmentDraws3D,
                     cfg: AugmentConfig3D) -> Tuple[torch.Tensor, torch.Tensor]:
    """data (C, D_in, H_in, W_in) float32; seg (D_in, H_in, W_in) or
    (S, D_in, H_in, W_in) integers -> the final patch, labels with -1
    (outside) cleaned to 0."""
    dev = data.device
    sz, sy, sx = _affine_coords_3d(d.angles, d.scale, data.shape[-3:], cfg.patch_size,
                                   cfg.scale_in_plane_only, dev)
    x = _trilinear_sample(data.float(), sz, sy, sx, 0.0)
    seg = _nearest_sample_3d(seg, sz, sy, sx, -1)

    if d.noise is not None:
        x = x + d.noise.to(dev)
    if any(s is not None for s in d.blur_sigmas):
        x = torch.stack([_blur_volume(x[c], s) if s is not None else x[c]
                         for c, s in enumerate(d.blur_sigmas)])
    if d.brightness is not None:
        x = x * torch.tensor(d.brightness, dtype=torch.float32,
                             device=dev)[:, None, None, None]
    if d.contrast is not None:
        f = torch.tensor(d.contrast, dtype=torch.float32, device=dev)[:, None, None, None]
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        mn = x.amin(dim=(1, 2, 3), keepdim=True)
        mx = x.amax(dim=(1, 2, 3), keepdim=True)
        x = torch.minimum(torch.maximum((x - mean) * f + mean, mn), mx)
    if d.gamma_invert is not None:
        x = _gamma(x, d.gamma_invert, True)
    if d.gamma is not None:
        x = _gamma(x, d.gamma, False)
    for axis, flip in zip((-3, -2, -1), d.flips):
        if flip:
            x = torch.flip(x, (axis,))
            seg = torch.flip(seg, (axis,))

    if any(cfg.use_mask_for_norm):
        outside = (seg[0] if seg.ndim == 4 else seg) < 0
        x = torch.stack([torch.where(outside, torch.zeros_like(x[c]), x[c]) if use
                         else x[c] for c, use in enumerate(cfg.use_mask_for_norm)])
    seg = torch.where(seg < 0, torch.zeros_like(seg), seg)
    return x, seg


def augment_batch_3d(data: torch.Tensor, seg: torch.Tensor, cfg: AugmentConfig3D,
                     gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """data (B, C, D_in, H_in, W_in) float32, seg (B, D_in, H_in, W_in) or
    (B, S, D_in, H_in, W_in) integers -> the same ranks at cfg.patch_size;
    draws from the CPU generator `gen`, compute on the tensors' device."""
    outs = [apply_augment_3d(data[b], seg[b], draw_augment_3d(gen, data.shape[1], cfg), cfg)
            for b in range(data.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


# ------------------------------------------------------------------- cascade


def _max_pool_axis(x: torch.Tensor, axis: int, radius: int) -> torch.Tensor:
    """Max over a window of 2 * radius + 1 along spatial `axis` of x
    (N, *spatial), -inf outside (lax.reduce_window's padding for a max)."""
    nd = x.dim() - 1
    kernel, pad = [1] * nd, [0] * nd
    kernel[axis], pad[axis] = 2 * radius + 1, radius
    pool = F.max_pool2d if nd == 2 else F.max_pool3d
    return pool(x[:, None], tuple(kernel), stride=1, padding=tuple(pad))[:, 0]


def _box_max(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Max over a cube of side 2 * radius + 1: one axis at a time (a max is
    exact, so equal to the cube's)."""
    for axis in range(x.dim() - 1):
        x = _max_pool_axis(x, axis, radius)
    return x


def _box_min(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Min over the cube, +inf outside: -max(-x)."""
    return -_box_max(-x, radius)


def _morph(ch: torch.Tensor, op: int, radius: int) -> torch.Tensor:
    """Binary operator `op` of (N, *spatial) maps: 0 dilation, 1 erosion,
    2 opening, 3 closing, with a cube of the given radius."""
    if op == 0:
        return _box_max(ch, radius)
    if op == 1:
        return _box_min(ch, radius)
    if op == 2:
        return _box_max(_box_min(ch, radius), radius)
    return _box_min(_box_max(ch, radius), radius)


def _dilate_in_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One cross-shaped growth step of x (N, *spatial), bool, within mask:
    each voxel ORed with its two neighbours along one axis at a time,
    ANDed with the mask after each axis, so a diagonal neighbour is reached
    only through the mask: 4- (6-)connectivity, scipy.ndimage.label's
    default (JAX ``:544-558``, its 3-wide max pool and clamp on 0/1 maps)."""
    for axis in range(1, x.dim()):
        n = x.shape[axis]
        grown = x.clone()
        grown.narrow(axis, 1, n - 1).logical_or_(x.narrow(axis, 0, n - 1))
        grown.narrow(axis, 0, n - 1).logical_or_(x.narrow(axis, 1, n - 1))
        x = grown.logical_and_(mask)
    return x


# Growth steps between the flood fill's reads of whether anything grew: each
# read syncs the host with the device.
_FILL_CHECK_EVERY = 16


def component_of_seed(mask: torch.Tensor, seed: torch.Tensor,
                      max_iters: int = 512) -> torch.Tensor:
    """The connected component of each mask (N, *spatial), float 0/1, that
    holds its seed (a 0/1 map of one voxel), as a float 0/1 map: growth
    steps on bool maps to the fixpoint, at most `max_iters` (JAX
    ``component_of_seed``'s while_loop). The host reads whether anything
    grew every `_FILL_CHECK_EVERY` steps only: steps past the fixpoint
    change nothing, and a fill that has not converged stops after exactly
    `max_iters` steps, as JAX's does."""
    inside = mask > 0.5
    comp = (seed > 0.5) & inside
    done = 0
    while done < max_iters:
        start = comp
        steps = min(_FILL_CHECK_EVERY, max_iters - done)
        for _ in range(steps):
            comp = _dilate_in_mask(comp, inside)
        done += steps
        if torch.equal(comp, start):
            break
    return comp.to(mask.dtype)


def _seed_maps(mask: torch.Tensor, seed_u: Sequence[float]) -> torch.Tensor:
    """0/1 maps (N, *spatial) of one foreground voxel each: the
    floor(u * n)-th of the n foreground voxels of each mask in flat order,
    u drawn uniform in [0, 1) (the same distribution as JAX's argmax of a
    uniform score field over the foreground). A mask without foreground gets
    a voxel outside it, which its component then drops."""
    flat = mask.reshape(mask.shape[0], -1)
    csum = torch.cumsum(flat > 0, dim=1)
    u = torch.tensor(seed_u, dtype=torch.float64, device=mask.device)
    rank = torch.floor(u * csum[:, -1]).long()
    idx = torch.searchsorted(csum, rank[:, None] + 1).clamp_(max=flat.shape[1] - 1)
    return torch.zeros_like(flat).scatter_(1, idx, 1.0).reshape(mask.shape)


@dataclasses.dataclass
class RemoveDraws:
    """The random part of remove_random_component for one sample: the
    sample's coin, and per channel the seed's uniform number, whether the
    removed region is marked in another channel, and which."""
    apply: bool = False
    seed_u: Tuple[float, ...] = ()
    fill: Tuple[bool, ...] = ()
    other: Tuple[int, ...] = ()


@dataclasses.dataclass
class CascadeDraws:
    """The random part of cascade_onehot_augment for one sample: per channel
    (operator, radius) of a binary operator or None, and the removal's
    draws."""
    morph: Tuple[Optional[Tuple[int, int]], ...] = ()
    remove: RemoveDraws = dataclasses.field(default_factory=RemoveDraws)


def draw_remove_component(gen: torch.Generator, n_channels: int,
                          p_per_sample: float = 0.2,
                          fill_with_other_class_p: float = 0.0) -> RemoveDraws:
    """One sample's removal draws from a CPU generator, with the JAX
    function's probabilities."""
    def u() -> float:
        return float(torch.rand((), generator=gen))

    if not u() < p_per_sample:
        return RemoveDraws()
    seed_u = tuple(u() for _ in range(n_channels))
    fill, other = [], []
    for c in range(n_channels):
        marks = (n_channels > 1 and fill_with_other_class_p > 0
                 and u() < fill_with_other_class_p)
        o = int(torch.randint(0, n_channels - 1, (), generator=gen)) if marks else 0
        fill.append(marks)
        other.append(o + 1 if marks and o >= c else o)
    return RemoveDraws(True, seed_u, tuple(fill), tuple(other))


def draw_cascade(gen: torch.Generator, n_channels: int, p_binary_op: float = 0.4,
                 strel_radii: Tuple[int, ...] = (1, 2, 3),
                 p_remove_component: float = 0.2) -> CascadeDraws:
    """One sample's cascade draws from a CPU generator (the JAX function's
    probabilities: an operator of the four, a radius of strel_radii)."""
    morph = []
    for _ in range(n_channels):
        if float(torch.rand((), generator=gen)) < p_binary_op:
            op = int(torch.randint(0, 4, (), generator=gen))
            radius = strel_radii[int(torch.randint(0, len(strel_radii), (), generator=gen))]
            morph.append((op, radius))
        else:
            morph.append(None)
    remove = (draw_remove_component(gen, n_channels, p_remove_component)
              if p_remove_component > 0 else RemoveDraws())
    return CascadeDraws(tuple(morph), remove)


def remove_random_component(onehot: torch.Tensor, d: RemoveDraws,
                            max_covered_frac: float = 0.15,
                            max_iters: int = 512) -> torch.Tensor:
    """RemoveRandomConnectedComponentFromOneHotEncodingTransform (JAX
    ``remove_random_component``; ref cascade_transforms.py:99-125): onehot
    (F, *spatial) float 0/1. Where the sample's coin says so, each channel
    loses the connected component of its seed if that covers less than
    `max_covered_frac` of the patch, and the region may be marked in another
    channel. Without marking the channels are independent and filled at
    once; with it they go in order, each on the channels as the ones before
    left them. No coin, no fill: the output is the input either way."""
    if not d.apply:
        return onehot
    n_vox = float(np.prod(onehot.shape[1:]))

    def components(chans: torch.Tensor, channels) -> torch.Tensor:
        mask = (chans > 0.5).float()
        comp = component_of_seed(mask, _seed_maps(mask, [d.seed_u[c] for c in channels]),
                                 max_iters)
        keep = (comp.flatten(1).sum(1) < max_covered_frac * n_vox) & mask.flatten(1).any(1)
        return comp * keep.view(-1, *[1] * (comp.dim() - 1))

    if not any(d.fill):
        return onehot * (1.0 - components(onehot, range(onehot.shape[0])))
    chans = list(onehot.unbind(0))
    for c in range(len(chans)):
        comp = components(chans[c][None], [c])[0]
        chans[c] = chans[c] * (1.0 - comp)
        if d.fill[c]:
            chans[d.other[c]] = torch.maximum(chans[d.other[c]], comp)
    return torch.stack(chans)


def cascade_onehot_augment(prev: torch.Tensor, foreground_labels: Sequence[int],
                           d: CascadeDraws) -> torch.Tensor:
    """Previous-stage label map (*spatial) integers -> augmented one-hot
    input channels (F, *spatial) float32 (JAX ``cascade_onehot_augment``;
    ref cascade_transforms.py:10-125, wired at nnUNetTrainer.py:743-759): a
    channel per foreground label, each given its binary operator where drawn
    (max / min pools over a cube), then a connected component removed where
    drawn."""
    onehot = torch.stack([(prev == label) for label in foreground_labels]).float()
    out = torch.stack([ch if m is None else _morph(ch[None], *m)[0]
                       for ch, m in zip(onehot, d.morph)])
    return remove_random_component(out, d.remove)


def cascade_augment_batch(prev: torch.Tensor, foreground_labels: Sequence[int],
                          gen: torch.Generator) -> torch.Tensor:
    """prev (B, *spatial) integers -> (B, F, *spatial) float32; draws from
    the CPU generator `gen`, compute on prev's device."""
    return torch.stack([
        cascade_onehot_augment(prev[b], foreground_labels,
                               draw_cascade(gen, len(foreground_labels)))
        for b in range(prev.shape[0])])
