"""Channel-major decoder-tail ops: 3x3 conv with an InstanceNorm-apply
prologue and statistics epilogue, the k2s2 transposed conv, the 1x1 seg head,
and the decoder chain built from them.

Counterparts of ``dinounet_tpu/ops/decoder_tail_pallas.py``, with its
signatures and its channel-major (B, C, H, W) layout; weights come in the
port's torch layouts (Conv2d (Cout, Cin, kh, kw), ConvTranspose2d
(Cin, Cout, 2, 2), biases (Cout,)). Each kernel op rounds where the JAX
package's kernel rounds: a prologue ``leaky(x * s + t)`` in fp32 rounded to
the compute dtype, the conv's zero padding applied after it, an fp32 product
plus an fp32 bias rounded once, and statistics of the rounded output.

For CUDA tensors ``conv3x3_cm``, ``transpconv2x2_cm`` and ``seg_head_cm``
launch ``csrc/conv3x3_stats.cu``, ``csrc/transpconv2x2.cu`` and
``csrc/seg_head.cu`` (each file's header says which TPU kernel it replaces
and what bounds it); for CPU tensors they run the plain versions below. The
ops are inference-only, as in the JAX package: no gradients.
"""

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from dinounet_tpu_torch.ops import _build

Prologue = Optional[Tuple[torch.Tensor, torch.Tensor]]

# Cout values the conv kernel is instantiated for (wgmma widths 16 to 128)
_CONV_COUT = (16, 32, 64, 128)
_PACK_ATTR = "_dinounet_conv3x3_packed"


def _pick_stripe(h: int, vmem_rows: int = 32) -> Optional[int]:
    """The JAX kernel's stripe height: the largest multiple-of-8 divisor of h
    <= vmem_rows, or None. Only its existence matters here: the routes
    engage where the JAX package's do."""
    for r in range(min(vmem_rows, h), 7, -8):
        if h % r == 0 and r % 8 == 0:
            return r
    return None


def tail_supported(shape: Tuple[int, ...]) -> bool:
    """Whether the JAX package runs its fused tail on a (B, C, H, W) map:
    H splits into multiple-of-8 stripes and W fills whole 128-lane tiles."""
    H, W = shape[-2], shape[-1]
    return _pick_stripe(H) is not None and W % 128 == 0


def apply_prologue(x: torch.Tensor, prologue: Prologue, slope: float) -> torch.Tensor:
    """leaky(x * s + t) per (sample, channel) in fp32, rounded to x's dtype;
    x unchanged without a prologue."""
    if prologue is None:
        return x
    s, t = prologue
    xf = x.float() * s[:, :, None, None] + t[:, :, None, None]
    return torch.where(xf >= 0, xf, xf * slope).to(x.dtype)


def instance_norm_apply_params(ssum, ssq, n: int, gamma, beta, eps: float = 1e-5):
    """(s, t), each (B, C) fp32, with InstanceNorm(y) = y * s + t, from the
    sums of y and y^2 over n = H * W (biased variance, clamped at 0)."""
    mu = ssum / n
    var = torch.clamp(ssq / n - mu * mu, min=0.0)
    s = gamma.float()[None, :] * torch.rsqrt(var + eps)
    return s, beta.float()[None, :] - mu * s


# --------------------------------------------------------------- plain versions


def _stats(y: torch.Tensor):
    yf = y.float()
    return yf.sum(dim=(2, 3)), (yf * yf).sum(dim=(2, 3))


def conv3x3_cm_plain(x_cm, w, b, prologue: Prologue = None, leaky_slope: float = 0.01,
                     stats: bool = True, x2=None):
    x = x_cm if x2 is None else torch.cat([x_cm, x2], dim=1)
    x = apply_prologue(x, prologue, leaky_slope)
    y = F.conv2d(x.float(), w.to(x.dtype).float(), padding=1)
    y = (y + b.float()[:, None, None]).to(x_cm.dtype)
    return (y, *_stats(y)) if stats else y


def transpconv2x2_cm_plain(x_cm, w, b, prologue: Prologue = None,
                           leaky_slope: float = 0.01):
    x = apply_prologue(x_cm, prologue, leaky_slope)
    y = F.conv_transpose2d(x.float(), w.to(x.dtype).float(), stride=2)
    return (y + b.float()[:, None, None]).to(x_cm.dtype)


def seg_head_cm_plain(x_cm, w, b, prologue: Prologue, leaky_slope: float = 0.01):
    x = apply_prologue(x_cm, prologue, leaky_slope)
    K, C = w.shape[0], w.shape[1]
    y = torch.einsum("bchw,kc->bkhw", x.float(), w.reshape(K, C).to(x.dtype).float())
    return y + b.float()[:, None, None]


# --------------------------------------------------------------- kernel launches


def _device_of(x: torch.Tensor, op: str) -> Optional[torch.device]:
    """None for a CPU tensor (the plain version runs); the CUDA device, else
    raise."""
    if x.device.type == "cpu":
        return None
    if x.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {x.device}")
    return x.device


def _prologue_ptrs(op, prologue: Prologue, B: int, C: int, dev):
    if prologue is None:
        return None, 0, 0
    s, t = (p.float().contiguous() for p in prologue)
    _build.check_inputs(op, dev, s=(s, torch.float32, (B, C)),
                        t=(t, torch.float32, (B, C)))
    return (s, t), s.data_ptr(), t.data_ptr()


def pack_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the kernel's B operand, (Cin / 8, 9, Cout, 8)
    bf16: for each group of 8 input channels and tap ky * 3 + kx, Cout rows
    of that group's 8 weights (16 bytes each), wgmma's no-swizzle K-major
    layout; the 16 channels of a chunk are one contiguous slice."""
    cout, cin = w.shape[0], w.shape[1]
    return (w.to(torch.bfloat16).reshape(cout, cin // 8, 8, 9).permute(1, 3, 0, 2)
            .contiguous())


def packed_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """``pack_conv_weight(w)``, computed once per weight version and kept on
    the tensor that owns w's storage (``_build.cached_on_storage``)."""
    return _build.cached_on_storage(w, _PACK_ATTR, lambda: pack_conv_weight(w))


def conv3x3_launch(op: str, x, x2, w, b, prologue: Prologue, slope: float,
                   stats: bool, y) -> Optional[torch.Tensor]:
    """Launch csrc/conv3x3_stats.cu on (B, C, H, W) views of any strides:
    x (and x2, concatenated after it along C), writing y, a (B, Cout, H, W)
    view. Returns the (2, B, Cout) fp32 sums of y and y^2 with `stats`. The
    weight goes in packed (``packed_conv_weight``, once per weight version);
    a call is one memset of the sums (the C entry's) and the conv kernel."""
    dev = x.device
    bf16, f32 = torch.bfloat16, torch.float32
    B, C1, H, W = x.shape
    C2 = 0 if x2 is None else x2.shape[1]
    Cout = w.shape[0]
    for name, t in (("x", x), ("x2", x2), ("y", y)):
        if t is not None and (t.dtype != bf16 or t.device != dev):
            raise ValueError(f"{op}: {name} must be bfloat16 on {dev}, got "
                             f"{t.dtype} on {t.device}")
    if x2 is not None and (x2.shape[0], x2.shape[2], x2.shape[3]) != (B, H, W):
        raise ValueError(f"{op}: x2 {tuple(x2.shape)} does not match x {tuple(x.shape)}")
    if C1 % 16 or C2 % 16 or Cout not in _CONV_COUT:
        raise ValueError(f"{op}: the kernel takes input channels in multiples of 16 "
                         f"and Cout in {_CONV_COUT}; got {C1} + {C2} -> {Cout}")
    if tuple(w.shape) != (Cout, C1 + C2, 3, 3) or tuple(y.shape) != (B, Cout, H, W):
        raise ValueError(f"{op}: weight {tuple(w.shape)} / output {tuple(y.shape)} "
                         f"do not fit input channels {C1 + C2}")
    wp = packed_conv_weight(w)
    bias = b.to(f32).contiguous()
    _build.check_inputs(op, dev, bias=(bias, f32, (Cout,)))
    _st, ps, pt = _prologue_ptrs(op, prologue, B, C1 + C2, dev)
    sums = torch.empty((2, B, Cout), dtype=f32, device=dev) if stats else None
    s2 = x2.stride() if x2 is not None else (0, 0, 0, 0)
    err = _build.lib().conv3x3_stats(
        x.data_ptr(), 0 if x2 is None else x2.data_ptr(), C1, C2,
        *x.stride(), *s2, wp.data_ptr(), bias.data_ptr(), ps, pt, float(slope),
        y.data_ptr(), *y.stride(),
        0 if sums is None else sums[0].data_ptr(),
        0 if sums is None else sums[1].data_ptr(),
        B, H, W, Cout, _build.stream_of(dev))
    _build.check(err, op)
    return sums


# --------------------------------------------------------------- public ops


def conv3x3_cm(x_cm, w, b, prologue: Prologue = None, leaky_slope: float = 0.01,
               stats: bool = True, x2=None):
    """conv3x3 (SAME, bias) over channel-major (B, Cin, H, W) input with the
    optional fused prologue leaky(x * s + t) (s, t (B, Cin) fp32: the previous
    InstanceNorm's or BatchNorm's apply). Returns (y (B, Cout, H, W) in x's
    dtype, sum (B, Cout), sumsq (B, Cout)) over H * W of y, or y alone with
    stats=False. w: (Cout, Cin, 3, 3); b: (Cout,). ``x2``, when given, is
    concatenated after x along the channels without being materialised (the
    kernel splits its reduction over the two inputs)."""
    dev = _device_of(x_cm, "conv3x3_cm")
    if dev is None:
        return conv3x3_cm_plain(x_cm, w, b, prologue, leaky_slope, stats, x2)
    B, _, H, W = x_cm.shape
    y = torch.empty((B, w.shape[0], H, W), dtype=x_cm.dtype, device=dev)
    sums = conv3x3_launch("conv3x3_cm", x_cm, x2, w, b, prologue, leaky_slope,
                          stats, y)
    conv3x3_cm.launches += 1
    return (y, sums[0], sums[1]) if stats else y


def transpconv2x2_cm(x_cm, w, b, prologue: Prologue = None, leaky_slope: float = 0.01):
    """ConvTranspose(kernel = stride = 2) over channel-major (B, Cin, H, W)
    with the optional fused prologue: (B, Cout, 2H, 2W) in x's dtype,
    out[c, 2j+p, 2x+q] = sum_cin x'[cin, j, x] w[cin, c, p, q] + b[c].
    w: (Cin, Cout, 2, 2) (torch ConvTranspose2d layout); b: (Cout,). The
    kernel runs at every width (the JAX package computes maps with
    W % 128 != 0 outside its kernel, at the same rounding points) and reads x
    through its strides; the output is contiguous NCHW."""
    dev = _device_of(x_cm, "transpconv2x2_cm")
    if dev is None:
        return transpconv2x2_cm_plain(x_cm, w, b, prologue, leaky_slope)
    op = "transpconv2x2_cm"
    bf16, f32 = torch.bfloat16, torch.float32
    B, Cin, H, W = x_cm.shape
    Cout = w.shape[1]
    if Cin % 16 or Cout % 4:
        raise ValueError(f"{op}: the kernel takes Cin in multiples of 16 and Cout "
                         f"in multiples of 4; got {Cin} -> {Cout}")
    wk = w.to(bf16).contiguous()
    bias = b.to(f32).contiguous()
    if x_cm.dtype != bf16:
        raise ValueError(f"{op}: x must be bfloat16, got {x_cm.dtype}")
    _build.check_inputs(op, dev, w=(wk, bf16, (Cin, Cout, 2, 2)),
                        bias=(bias, f32, (Cout,)))
    _st, ps, pt = _prologue_ptrs(op, prologue, B, Cin, dev)
    y = torch.empty((B, Cout, 2 * H, 2 * W), dtype=bf16, device=dev)
    err = _build.lib().transpconv2x2(
        x_cm.data_ptr(), *x_cm.stride(), wk.data_ptr(), bias.data_ptr(), ps, pt,
        float(leaky_slope),
        y.data_ptr(), B, Cin, H, W, Cout, _build.stream_of(dev))
    _build.check(err, op)
    transpconv2x2_cm.launches += 1
    return y


def seg_head_cm(x_cm, w, b, prologue: Prologue, leaky_slope: float = 0.01):
    """1x1 seg head over channel-major (B, C, H, W) features with the fused
    leaky(x * s + t) prologue: fp32 logits (B, K, H, W). w: (K, C, 1, 1)
    (or (K, C)); b: (K,)."""
    dev = _device_of(x_cm, "seg_head_cm")
    if dev is None:
        return seg_head_cm_plain(x_cm, w, b, prologue, leaky_slope)
    op = "seg_head_cm"
    bf16, f32 = torch.bfloat16, torch.float32
    B, C, H, W = x_cm.shape
    K = w.shape[0]
    if K > 32 or C > 512:
        raise ValueError(f"{op}: the kernel takes up to 32 classes and 512 channels; "
                         f"got {C} -> {K}")
    wk = w.reshape(K, C).t().to(bf16).float().contiguous()  # (C, K), bf16 values
    bias = b.to(f32).contiguous()
    _build.check_inputs(op, dev, x=(x_cm, bf16, (B, C, H, W)), bias=(bias, f32, (K,)))
    _st, ps, pt = _prologue_ptrs(op, prologue, B, C, dev)
    out = torch.empty((B, K, H, W), dtype=f32, device=dev)
    err = _build.lib().seg_head(
        x_cm.data_ptr(), wk.data_ptr(), bias.data_ptr(), ps, pt, float(leaky_slope),
        out.data_ptr(), B, C, H * W, K, _build.stream_of(dev))
    _build.check(err, op)
    seg_head_cm.launches += 1
    return out


conv3x3_cm.launches = 0
transpconv2x2_cm.launches = 0
seg_head_cm.launches = 0


# --------------------------------------------------------------- the chain


StageParams = Tuple[torch.Tensor, ...]  # kt, bt, w0, b0, g0, be0, w1, b1, g1, be1


def decoder_chain_cm(lres_cm, skips_cm: Sequence[torch.Tensor],
                     stage_params: Sequence[StageParams],
                     seg_params: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                     deep_supervision: bool, eps: float = 1e-5,
                     slope: float = 0.01) -> List[Optional[torch.Tensor]]:
    """Consecutive decoder stages channel-major: per stage
    transpconv(leaky(IN(x))) -> [up, skip] -> conv0 -> IN -> leaky -> conv1 ->
    IN statistics, each InstanceNorm apply in the next op's prologue, so the
    activated maps never exist. lres_cm: the raw lowest-resolution map;
    skips_cm: one skip per stage, in decoding order; stage_params: per stage
    (kt, bt, w0, b0, g0, be0, w1, b1, g1, be1) in the port's layouts;
    seg_params: per stage (w (K, C, 1, 1), b (K,)). Returns one entry per
    stage: fp32 logits (B, K, H, W) where a head is computed (every stage
    under deep supervision, else the last), None elsewhere."""
    x, prologue, outs = lres_cm, None, []
    last = len(stage_params) - 1
    for i, ((kt, bt, w0, b0, g0, be0, w1, b1, g1, be1), skip) in enumerate(
            zip(stage_params, skips_cm)):
        up = transpconv2x2_cm(x, kt, bt, prologue=prologue, leaky_slope=slope)
        n = skip.shape[2] * skip.shape[3]
        y0, s0, q0 = conv3x3_cm(up, w0, b0, x2=skip)
        p0 = instance_norm_apply_params(s0, q0, n, g0, be0, eps)
        y1, s1, q1 = conv3x3_cm(y0, w1, b1, prologue=p0, leaky_slope=slope)
        prologue = instance_norm_apply_params(s1, q1, n, g1, be1, eps)
        if deep_supervision or i == last:
            wseg, bseg = seg_params[i]
            outs.append(seg_head_cm(y1, wseg, bseg, prologue, leaky_slope=slope))
        else:
            outs.append(None)
        x = y1
    return outs


def decoder_tail_cm(up_skip_cm, w0, b0, g0, be0, w1, b1, g1, be1, wseg, bseg,
                    eps: float = 1e-5, slope: float = 0.01):
    """The fused tail over the concatenated (B, Cin, H, W) input: conv0 -> IN
    -> leaky -> conv1 -> IN -> leaky -> 1x1 seg. Returns fp32 logits."""
    n = up_skip_cm.shape[2] * up_skip_cm.shape[3]
    y0, s0, q0 = conv3x3_cm(up_skip_cm, w0, b0)
    p0 = instance_norm_apply_params(s0, q0, n, g0, be0, eps)
    y1, s1, q1 = conv3x3_cm(y0, w1, b1, prologue=p0, leaky_slope=slope)
    p1 = instance_norm_apply_params(s1, q1, n, g1, be1, eps)
    return seg_head_cm(y1, wseg, bseg, p1, leaky_slope=slope)
