"""Smoke run of the PyTorch/CUDA port's serving and training paths on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the exit code is
not 0:

1. build   -- compile the CUDA kernels from dinounet_tpu_torch/csrc/.
2. kernels -- each kernel against its plain PyTorch version on the card, at
              the shapes the dinounet_b tile forward gives it (tile batch 8;
              the MSDA backward at the train step's batch 2), within its
              stated tolerance; kernel, plain and library times (CUDA events,
              median of 20) and the bound (the larger of the bytes each call
              must move over 3.35 TB/s and its operations over the peak rate
              of their type). The library call is one PyTorch op computing
              the same function or, for the convs, the same conv alone (cuDNN
              on channels-last bf16, no prologue or statistics), timed as a
              yardstick and never called by the port.
3. serve   -- dinounet_b at full width with seeded random weights, behind the
              port's nnUNetPredictor (2d, 512 x 512 patches, step 0.5, tile
              batch 8, bf16): one 1 x 1280 x 1280 case = 16 tiles in 2
              batches. Checks the fp16 logits' shape and finiteness and that
              the kernels ran the path (per tile-batch forward: attention 12,
              cm-dense 18, row-dense 18, MSDA 6 launches). Tiles/s for
              information.
4. parity  -- one 512 x 512 tile through DinoUNet on the card in bf16 (the
              kernels) and on the CPU in fp32 (the plain versions), the same
              weights: relative L2 error of the logits <= PARITY_BOUND.
5. serve routes -- the same case served again with each inference conv
              route on (ROUTES: the channel-major decoder chain, upsampling
              and SPM stem; the HWBC decoder stages): launch counts per
              tile-batch forward (PER_FORWARD_ROUTE on top of the serve
              counts), finite fp16 logits, and the parity tile (in a batch of
              8, as the HWBC stages need) against the same CPU fp32 logits
              within PARITY_BOUND. Tiles/s and the SPM, upsampling and decoder
              CUDA-event times per tile batch, beside the default route's.
              The environment is restored after each route.
6. train   -- a synthetic preprocessed 2-D dataset (6 cases of 640 x 640, a
              bright disk and a dark ring) in a temporary nnUNet_preprocessed;
              DinoUNetTrainer_b through run.get_trainer_from_args on cuda:0
              (512 x 512 patches, batch 2, bf16, random frozen backbone),
              run_training() for 2 epochs of TRAIN_ITERS steps and 2
              validation iterations. Checks: every logged loss finite, the
              launch counts of the run (per train step: attention 12, dense
              12 + 12 in the frozen backbone, MSDA forward 6 + 6 in the
              checkpointed recompute, MSDA backward 6; per validation
              forward the serve counts), checkpoint_final.pth written and
              loaded back by a fresh trainer with equal weights, and over
              LEARN_STEPS further steps on the same loader the mean loss of
              the last 10 below that of the first 10. Step time, steps/s and
              peak device memory for information.
7. train parity -- one train step's loss and trainable gradients on the card
              (bf16, the kernels) against the CPU (fp32, the plain
              versions): same dinounet_b weights and 256 x 256 batch of 1,
              no augmentation, drop-path 0; relative L2 of the concatenated
              gradients <= TRAIN_GRAD_BOUND (those of the projections in
              front of the MSDA kernels, alone, <= TRAIN_MSDA_GRAD_BOUND),
              loss within TRAIN_LOSS_BOUND;
              an optimizer step on the card leaves every backbone parameter
              as it was.

Then the card's name and power limit, one JSON line of kernel results
(launches: the counts of the serve, serve_cm, serve_hwbc and train paths),
and as the last line {"ok": true, "device": {...}}. Without a CUDA device the
script raises before printing any result.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from dinounet_tpu_torch.inference.predictor import nnUNetPredictor
from dinounet_tpu_torch.models.dinounet import DinoUNet, DinoUNetConfig
from dinounet_tpu_torch.models.vit import rope_sincos
from dinounet_tpu_torch.ops import _build
from dinounet_tpu_torch.ops.attention import (fused_rope_attention_premapped_dmaj,
                                              rope_attention_dmaj_plain,
                                              rope_tables_dmaj)
from dinounet_tpu_torch.ops.conv_hwbc import conv3x3_hwbc, conv3x3_hwbc_plain
from dinounet_tpu_torch.ops.decoder_tail import (conv3x3_cm, conv3x3_cm_plain,
                                                 seg_head_cm, seg_head_cm_plain,
                                                 transpconv2x2_cm,
                                                 transpconv2x2_cm_plain)
from dinounet_tpu_torch.ops.dense_stats import (dense_cm_residual_stats,
                                                dense_cm_residual_stats_plain,
                                                dense_residual_stats,
                                                dense_residual_stats_plain)
from dinounet_tpu_torch.ops.kernel_check import (KERNEL_TOLERANCES, STATS_TOLERANCE,
                                                 max_abs_err, max_excess, median_ms)
from dinounet_tpu_torch.ops.msda import (ms_deform_attn_premapped_backward_plain,
                                         ms_deform_attn_premapped_fused_plain,
                                         premapped_fused_prep)
from dinounet_tpu_torch.ops.msda_kernel import (ms_deform_attn_premapped_backward,
                                                ms_deform_attn_premapped_fused)
from dinounet_tpu_torch.run import get_trainer_from_args
from dinounet_tpu_torch.training.losses import dc_and_ce_loss
from dinounet_tpu_torch.training.trainer import clip_and_step, sgd_nesterov
from dinounet_tpu_torch.utilities.plans_handler import PlansManager
from dinounet_tpu_torch.utilities.synthetic_dataset import (disk_ring_case,
                                                            write_disk_ring_dataset)

TILE_BATCH = 8
PATCH = 512
CASE = (1, 1, 1280, 1280)
N_CLASSES = 3
# bf16 on the card vs fp32 on the CPU, relative L2 of the logits; the JAX
# package holds its own bf16 path to 0.15 (tests/test_vit_parity.py)
PARITY_BOUND = 0.05
# kernel launches per tile-batch forward of dinounet_b
PER_FORWARD = {"rope_attention": 12, "dense_cm_stats": 18, "dense_rm_stats": 18,
               "msda_fwd": 6, "msda_bwd": 0, "conv3x3_cm": 0, "transpconv2x2_cm": 0,
               "seg_head_cm": 0, "conv3x3_hwbc": 0}
# the inference conv routes, as environment settings, and the launches each
# adds per tile-batch forward. serve_cm: conv3x3_cm 2 per decoder stage at
# 128^2, 256^2, 512^2 and the 2 SPM stem convs at 256^2; transpconv2x2_cm the
# 3 decoder upsamplings and the 4 LearnableUpsamples' 2 doublings each; one
# seg head (no deep supervision). serve_hwbc: the 64-channel stage at 256^2
# and the 32-channel stage at 512^2, 2 convs each (the 128-channel stage is
# not eligible).
ROUTES = {
    "serve_cm": {"DINOUNET_TPU_DECODER_TAIL": "pallas", "DINOUNET_TPU_SPM_CM": "pallas"},
    "serve_hwbc": {"DINOUNET_TPU_DECODER_HWBC": "auto", "DINOUNET_TPU_DECODER_TAIL": "jax"},
}
PER_FORWARD_ROUTE = {
    "serve_cm": {"conv3x3_cm": 8, "transpconv2x2_cm": 11, "seg_head_cm": 1},
    "serve_hwbc": {"conv3x3_hwbc": 4},
}
# kernel launches per train step: the backbone's 12 blocks (attention, the
# channel-major attention projection, the row-major fc2); the adapter trains
# unfused, so its 6 extractors launch only the MSDA forward (twice: the
# checkpointed interaction blocks run it again in the backward) and backward
PER_TRAIN_STEP = {"rope_attention": 12, "dense_cm_stats": 12, "dense_rm_stats": 12,
                  "msda_fwd": 12, "msda_bwd": 6, "conv3x3_cm": 0, "transpconv2x2_cm": 0,
                  "seg_head_cm": 0, "conv3x3_hwbc": 0}
TRAIN_ITERS, TRAIN_EPOCHS, VAL_ITERS, LEARN_STEPS = 5, 2, 2, 40
TRAIN_DATASET = "Dataset998_SmokeTrain"
# one train step, card bf16 (kernels) vs CPU fp32 (plain versions), relative
# L2. bf16 keeps 8 significant bits and the ~60 layers of forward and
# backward each round activations and gradients at 2^-9 relative: the whole
# trainable gradient is held to 0.15, the JAX package's bound for its own
# bf16 forward (tests/test_vit_parity.py). The MSDA projections' gradients
# also go through the sampling position: bf16 offsets place a point only to
# ~1/64 pixel and the bilinear derivative jumps at pixel edges, so they are
# noisier (0.12 measured between the CPU's bf16 and fp32 plain versions at
# 64^2); they are held to 0.3 -- a dropped or zeroed MSDA gradient gives 1.0
TRAIN_GRAD_BOUND = 0.15
TRAIN_MSDA_GRAD_BOUND = 0.3
TRAIN_LOSS_BOUND = 0.02
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "rope_attention": ("dinounet_tpu_torch/csrc/rope_attention.cu",
                       "dinounet_tpu/ops/attention_pallas.py:110"),
    "dense_cm_stats": ("dinounet_tpu_torch/csrc/dense_stats.cu",
                       "dinounet_tpu/ops/dense_stats_pallas.py:241"),
    "dense_rm_stats": ("dinounet_tpu_torch/csrc/dense_stats.cu",
                       "dinounet_tpu/ops/dense_stats_pallas.py:71"),
    "msda_fwd": ("dinounet_tpu_torch/csrc/msda_fwd.cu",
                 "dinounet_tpu/ops/msda_pallas.py:251"),
    "msda_bwd": ("dinounet_tpu_torch/csrc/msda_bwd.cu",
                 "dinounet_tpu/ops/msda_pallas.py:582"),
    "conv3x3_cm": ("dinounet_tpu_torch/csrc/conv3x3_stats.cu",
                   "dinounet_tpu/ops/decoder_tail_pallas.py:141"),
    "transpconv2x2_cm": ("dinounet_tpu_torch/csrc/transpconv2x2.cu",
                         "dinounet_tpu/ops/decoder_tail_pallas.py:399"),
    "seg_head_cm": ("dinounet_tpu_torch/csrc/seg_head.cu",
                    "dinounet_tpu/ops/decoder_tail_pallas.py:207"),
    "conv3x3_hwbc": ("dinounet_tpu_torch/csrc/conv3x3_stats.cu",
                     "dinounet_tpu/ops/conv_hwbc_pallas.py:78"),
}
# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s, dense
# bf16 tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores
HBM_BYTES_S, BF16_FLOP_S, FP32_FLOP_S = 3.35e12, 989e12, 67e12
ARCH = {  # the plans' architecture of a 2d dinounet_b configuration
    "n_stages": 4, "features_per_stage": [32, 64, 128, 256],
    "kernel_sizes": [[3, 3]] * 4, "strides": [[1, 1], [2, 2], [2, 2], [2, 2]],
    "n_conv_per_stage": [2, 2, 2, 2], "n_conv_per_stage_decoder": [2, 2, 2],
    "conv_bias": True,
    "norm_op": "torch.nn.modules.instancenorm.InstanceNorm2d",
    "norm_op_kwargs": {"eps": 1e-05, "affine": True},
    "nonlin": "torch.nn.LeakyReLU", "nonlin_kwargs": {"inplace": True},
}
PLANS = {"dataset_name": "Dataset999_Smoke", "plans_name": "nnUNetPlans",
         "configurations": {"2d": {"patch_size": [PATCH, PATCH],
                                   "architecture": {"network_class_name": "DinoUNet",
                                                    "arch_kwargs": ARCH,
                                                    "_kw_requires_import": []}}}}
DATASET_JSON = {"labels": {"background": 0, "a": 1, "b": 2},
                "channel_names": {"0": "CT"}}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.lib()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"({_build.library_path().parent})")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _bound(nbytes: int, flops: float, peak: float):
    """The least time (ms) the card could take: bytes over the HBM rate or
    operations over their type's peak, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _compare(name, shape_desc, kernel_fn, plain_fn, inputs, flops, peak,
             library_fn=None, tols=None, library_label="library"):
    """Kernel vs plain version on the same inputs; `inputs` are the tensors
    the function reads (each counted once in the bound, with the outputs);
    `tols` optionally one (atol, rtol) per output (default: the kernel's)."""
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    tols = tols or [KERNEL_TOLERANCES[name]] * len(got)
    excess = max(max_excess(g, w, tol) for g, w, tol in zip(got, want, tols))
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    rel = max(max_abs_err(g, w) / max(float(w.float().abs().max()), 1e-30)
              for g, w in zip(got, want))
    bound_ms, bound_by = _bound(_nbytes(*inputs, *got), flops, peak)
    ms, plain_ms = median_ms(kernel_fn), median_ms(plain_fn)
    library_ms = median_ms(library_fn) if library_fn is not None else None
    lib_txt = f", {library_label} {library_ms:.4f} ms" if library_ms is not None else ""
    log(f"[kernels] {name} {shape_desc}: max abs err {err:.3e} (max rel "
        f"{rel:.3e}; bound atol {tols[0][0]} + rtol {tols[0][1]}*|ref|, excess "
        f"{excess:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib_txt}; "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    if not excess <= 0:
        raise AssertionError(f"{name} {shape_desc}: kernel disagrees with its "
                             f"plain version (excess {excess})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def _conv_case(g, dev, B, C1, C2, H, W, Cout, prologue, slope=0.01):
    """Random bf16 inputs, (Cout, Cin, 3, 3) weights and an optional prologue
    (as an InstanceNorm apply gives it) for one 3x3 conv of the path."""
    bf = torch.bfloat16
    x = torch.randn((B, C1, H, W), generator=g, device=dev).to(bf)
    x2 = torch.randn((B, C2, H, W), generator=g, device=dev).to(bf) if C2 else None
    cin = C1 + C2
    w = torch.randn((Cout, cin, 3, 3), generator=g, device=dev) * (9 * cin) ** -0.5
    b = torch.randn((Cout,), generator=g, device=dev) * 0.1
    pro = None
    if prologue:
        pro = (torch.rand((B, cin), generator=g, device=dev) + 0.5,
               torch.randn((B, cin), generator=g, device=dev) * 0.3)
    return x, x2, w, b, pro, slope


def _conv_library(x, x2, w, b):
    """cuDNN's conv alone on channels-last bf16 (the concat made beforehand)."""
    xin = x if x2 is None else torch.cat([x, x2], dim=1)
    xin = xin.contiguous(memory_format=torch.channels_last)
    wl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bl = b.to(torch.bfloat16)
    return lambda: F.conv2d(xin, wl, bl, padding=1)


CUDNN_LABEL = "library (cuDNN conv alone, channels-last bf16)"


def _normalized(out, n):
    """(y, sum, ssq) -> (y, sum / n, ssq / n): statistics compared as means."""
    return (out[0], out[1] / n, out[2] / n) if isinstance(out, tuple) else out


def phase_kernels(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    B = TILE_BATCH

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    results = {}
    # attention: ViT-B, 12 heads of 64 over 5 + 32 * 32 tokens; library:
    # scaled_dot_product_attention on the rotated q, k and v
    N, M, Dh = 1029, 12, 64
    qkv = randn(B, 3, M, Dh, N).to(bf)
    sin, cos = rope_sincos(32, 32, Dh, device=dev)
    sin = torch.cat([torch.zeros((5, Dh), device=dev), sin])
    cos = torch.cat([torch.ones((5, Dh), device=dev), cos])
    tables = rope_tables_dmaj(sin, cos, N, Dh, dev)

    def rotated(x):
        xf = x.float()
        r = xf * tables[1] + torch.roll(xf, Dh // 2, dims=-2) * tables[0]
        return r.to(bf).transpose(-1, -2).contiguous()  # (B, M, N, Dh)

    q, k, v = rotated(qkv[:, 0]), rotated(qkv[:, 1]), qkv[:, 2].transpose(-1, -2).contiguous()
    results["rope_attention"] = _compare(
        "rope_attention", f"qkv {tuple(qkv.shape)}",
        lambda: fused_rope_attention_premapped_dmaj(qkv, sin, cos),
        lambda: rope_attention_dmaj_plain(qkv, *tables),
        (qkv, sin, cos), 4.0 * B * M * N * N * Dh, BF16_FLOP_S,
        lambda: F.scaled_dot_product_attention(q, k, v))

    # dense + residual + stats: (K, N) of the ViT and of the adapter, D = 768;
    # library: the cuBLAS GEMM alone (a lower yardstick: no epilogue)
    D = 768
    for K, N, where in ((768, 1029, "vit proj"), (384, 5376, "msda output proj")):
        h = randn(B, K, N).to(bf)
        w, b = randn(K, D, scale=K ** -0.5), randn(D, scale=0.1)
        res, gamma = randn(B, N, D).to(bf), randn(D, scale=0.5)
        wb, ht = w.to(bf), h.transpose(1, 2)
        r = _compare("dense_cm_stats", f"{where} K={K} N={N}",
                     lambda: dense_cm_residual_stats(h, w, b, res, gamma),
                     lambda: dense_cm_residual_stats_plain(h, w, b, res, gamma),
                     (h, w, b, res, gamma), 2.0 * B * N * K * D, BF16_FLOP_S,
                     lambda: torch.matmul(ht, wb))
        results.setdefault("dense_cm_stats", r)
    for K, N, where in ((3072, 1029, "vit fc2"), (192, 5376, "convffn fc2")):
        h = randn(B, N, K).to(bf)
        w, b = randn(K, D, scale=K ** -0.5), randn(D, scale=0.1)
        res, gamma = randn(B, N, D).to(bf), randn(D, scale=0.5)
        wb = w.to(bf)
        r = _compare("dense_rm_stats", f"{where} +GELU K={K} N={N}",
                     lambda: dense_residual_stats(h, w, b, res, gamma, apply_gelu=True),
                     lambda: dense_residual_stats_plain(h, w, b, res, gamma, True),
                     (h, w, b, res, gamma), 2.0 * B * N * K * D, BF16_FLOP_S,
                     lambda: torch.matmul(h, wb))
        results.setdefault("dense_rm_stats", r)

    # MSDA: 16 heads of 24 channels over the 32 x 32 ViT grid, 5376 queries
    # around the adapter's reference grid, 4 points; no library op computes
    # it. Operations: 4 corners x 2 FLOP per channel and point (fp32 FMA).
    Mq, Dv, Hv, P, Lq = 16, 24, 32, 4, 5376
    v = randn(B, Mq, Dv, Hv * Hv).to(bf)
    off = randn(B, Mq, 2 * P, Lq, scale=2.0).to(bf)
    logits = randn(B, Mq, P, Lq).to(bf)
    base = torch.rand((2 * P, Lq), generator=g, device=dev) * Hv - 0.5
    results["msda_fwd"] = _compare(
        "msda_fwd", f"value {tuple(v.shape)} Lq={Lq}",
        lambda: ms_deform_attn_premapped_fused(v, ((Hv, Hv),), off, logits, base),
        lambda: ms_deform_attn_premapped_fused_plain(v, ((Hv, Hv),), off, logits, base),
        (v, off, logits, base), 8.0 * B * Mq * Lq * P * Dv, FP32_FLOP_S)

    # MSDA backward at the train step's shapes (batch 2): the prepped
    # coordinates and weights of the forward's inputs, an fp32 cotangent.
    # Operations: per corner and channel the value-gradient scatter, the
    # attention-weight product and the two coordinate derivatives (8 FLOP).
    Bt = 2
    xs, ys, aw = (t.contiguous() for t in premapped_fused_prep(
        off[:Bt], logits[:Bt], base))
    cot = randn(Bt, Mq, Dv, Lq)
    vt = v[:Bt].contiguous()
    results["msda_bwd"] = _compare(
        "msda_bwd", f"value {tuple(vt.shape)} Lq={Lq}",
        lambda: ms_deform_attn_premapped_backward(vt, ((Hv, Hv),), xs, ys, aw, cot),
        lambda: ms_deform_attn_premapped_backward_plain(vt, ((Hv, Hv),), xs, ys, aw, cot),
        (vt, xs, ys, aw, cot), 32.0 * Bt * Mq * Lq * P * Dv, FP32_FLOP_S)

    # the decoder/SPM conv family at the dinounet_b serve shapes (tile batch
    # 8, 512^2 tiles). The first of each kernel's shapes is the one its JSON
    # entry reports.
    conv_cases = [  # (where, C1, C2, H, Cout, prologue, slope, stats)
        ("decoder conv0 512^2", 32, 32, 512, 32, False, 0.01, True),
        ("decoder conv1 512^2", 32, 0, 512, 32, True, 0.01, True),
        ("decoder conv0 256^2", 64, 64, 256, 64, False, 0.01, True),
        ("decoder conv1 256^2", 64, 0, 256, 64, True, 0.01, True),
        ("decoder conv0 128^2", 128, 128, 128, 128, False, 0.01, True),
        ("decoder conv1 128^2", 128, 0, 128, 128, True, 0.01, True),
        ("SPM stem3 256^2", 64, 0, 256, 64, True, 0.0, False),
    ]
    for where, C1, C2, H, Cout, pro, slope, stats in conv_cases:
        x, x2, w, b, p, slope = _conv_case(g, dev, B, C1, C2, H, H, Cout, pro, slope)
        n = H * H
        tols = [KERNEL_TOLERANCES["conv3x3_cm"]] + [STATS_TOLERANCE] * (2 if stats else 0)
        r = _compare(
            "conv3x3_cm", f"{where} ({C1}+{C2} -> {Cout})",
            lambda: _normalized(conv3x3_cm(x, w, b, p, slope, stats, x2), n),
            lambda: _normalized(conv3x3_cm_plain(x, w, b, p, slope, stats, x2), n),
            (x, x2, w, b, *(p or ())), 2.0 * B * n * 9 * (C1 + C2) * Cout, BF16_FLOP_S,
            _conv_library(x, x2, w, b), tols, CUDNN_LABEL)
        results.setdefault("conv3x3_cm", r)
    # the HWBC route's convs on (H, W, B, C) views of NCHW maps, as the
    # decoder calls them
    for where, C1, C2, H, Cout, pro in (("conv0 512^2", 32, 32, 512, 32, False),
                                        ("conv1 512^2", 32, 0, 512, 32, True),
                                        ("conv0 256^2", 64, 64, 256, 64, False),
                                        ("conv1 256^2", 64, 0, 256, 64, True)):
        x, x2, w, b, p, slope = _conv_case(g, dev, B, C1, C2, H, H, Cout, pro)
        xv, x2v = x.permute(2, 3, 0, 1), None if x2 is None else x2.permute(2, 3, 0, 1)
        n = H * H
        tols = [KERNEL_TOLERANCES["conv3x3_hwbc"], STATS_TOLERANCE, STATS_TOLERANCE]
        r = _compare(
            "conv3x3_hwbc", f"{where} ({C1}+{C2} -> {Cout})",
            lambda: _normalized(conv3x3_hwbc(xv, w, b, x2v, p, slope), n),
            lambda: _normalized(conv3x3_hwbc_plain(xv, w, b, x2v, p, slope), n),
            (x, x2, w, b, *(p or ())), 2.0 * B * n * 9 * (C1 + C2) * Cout, BF16_FLOP_S,
            _conv_library(x, x2, w, b), tols, CUDNN_LABEL)
        results.setdefault("conv3x3_hwbc", r)
    # transposed convs: the decoder's three (with the previous stage's
    # InstanceNorm apply after the first) and LearnableUpsample doublings
    for where, Cin, Cout, H, pro in (("decoder 256^2", 64, 32, 256, True),
                                     ("decoder 128^2", 128, 64, 128, True),
                                     ("decoder 64^2", 256, 128, 64, False),
                                     ("upsample 256^2", 32, 32, 256, False),
                                     ("upsample 32^2", 256, 256, 32, False)):
        x = randn(B, Cin, H, H).to(bf)
        w, b = randn(Cin, Cout, 2, 2, scale=Cin ** -0.5), randn(Cout, scale=0.1)
        p = (torch.rand((B, Cin), generator=g, device=dev) + 0.5,
             randn(B, Cin, scale=0.3)) if pro else None
        xl = x.contiguous(memory_format=torch.channels_last)
        wl, bl = w.to(bf), b.to(bf)
        r = _compare(
            "transpconv2x2_cm", f"{where} ({Cin} -> {Cout})",
            lambda: transpconv2x2_cm(x, w, b, p), lambda: transpconv2x2_cm_plain(x, w, b, p),
            (x, w, b, *(p or ())), 2.0 * B * H * H * Cin * 4 * Cout, BF16_FLOP_S,
            lambda: F.conv_transpose2d(xl, wl, bl, stride=2), library_label=CUDNN_LABEL)
        results.setdefault("transpconv2x2_cm", r)
    # the seg head over the last stage: (8, 32, 512, 512) -> 3 fp32 logits
    C, K, H = 32, N_CLASSES, PATCH
    x = randn(B, C, H, H).to(bf)
    w, b = randn(K, C, 1, 1, scale=C ** -0.5), randn(K, scale=0.1)
    p = (torch.rand((B, C), generator=g, device=dev) + 0.5, randn(B, C, scale=0.3))
    xl, wl = x.contiguous(memory_format=torch.channels_last), w.to(bf)
    results["seg_head_cm"] = _compare(
        "seg_head_cm", f"({B}, {C}, {H}, {H}) -> {K}",
        lambda: seg_head_cm(x, w, b, p), lambda: seg_head_cm_plain(x, w, b, p),
        (x, w, b, *p), 2.0 * B * H * H * C * K, FP32_FLOP_S,
        lambda: F.conv2d(xl, wl), library_label=CUDNN_LABEL)
    return results


def build_model() -> DinoUNet:
    pm = PlansManager(PLANS)
    arch = pm.get_configuration("2d").network_arch_init_kwargs
    cfg = DinoUNetConfig.from_plans_arch(arch, N_CLASSES, model_name="dinounet_b")
    return DinoUNet(cfg).init_weights(seed=0).eval()


@contextlib.contextmanager
def route_env(settings: dict):
    """Set the route variables for the block, then restore what was there."""
    saved = {k: os.environ.get(k) for k in settings}
    os.environ.update(settings)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_serve(dev, model: DinoUNet, path: str = "serve") -> dict:
    pm = PlansManager(PLANS)
    predictor = nnUNetPredictor(tile_step_size=0.5, use_mirroring=False,
                                device=dev, tile_batch=TILE_BATCH)
    predictor.manual_initialization(model, pm, pm.get_configuration("2d"), None,
                                    DATASET_JSON, "nnUNetTrainer", None)
    case = np.random.default_rng(0).standard_normal(CASE).astype(np.float32)
    n_tiles, n_batches = 16, 2
    tag = f"[{path}]" if path == "serve" else f"[serve routes: {path}]"

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    logits = predictor.predict_logits_from_preprocessed_data(case)
    first_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    log(f"{tag} first case {first_s:.2f} s; launches {counts}")
    per_forward = {k: n + PER_FORWARD_ROUTE.get(path, {}).get(k, 0)
                   for k, n in PER_FORWARD.items()}
    want = {k: n * n_batches for k, n in per_forward.items()}
    if counts != want:
        raise AssertionError(f"{path}: kernel launches {counts}, the path makes {want}")
    if logits.shape != (N_CLASSES,) + CASE[1:] or logits.dtype != np.float16:
        raise AssertionError(f"{path}: logits {logits.shape} {logits.dtype}")
    if not np.all(np.isfinite(logits)):
        raise AssertionError(f"{path}: non-finite logits")
    log(f"{tag} logits {logits.shape} {logits.dtype}, all finite, "
        f"mean {float(logits.astype(np.float32).mean()):.4f} "
        f"std {float(logits.astype(np.float32).std()):.4f}")

    torch.cuda.reset_peak_memory_stats(dev)
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        predictor.predict_logits_from_preprocessed_data(case)
        rates.append(n_tiles / (time.perf_counter() - t0))
    log(f"{tag} tiles/s over 3 repeats: {', '.join(f'{r:.2f}' for r in rates)} "
        f"(median {sorted(rates)[1]:.2f}); peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return counts


def phase_layer_times(dev, model: DinoUNet, path: str, iters: int = 5) -> dict:
    """CUDA-event times of the layers the routes change (the SPM, the four
    LearnableUpsamples, the decoder) per tile-batch forward, from forward
    pre/post hooks, mean of `iters` forwards after one warm-up."""
    layers = {"spm": [model.encoder.dinov3_adapter.spm],
              "upsample": list(model.encoder.ups), "decoder": [model.decoder]}
    events = {name: [] for name in layers}
    handles = []
    for name, mods in layers.items():
        def pre(mod, args, name=name):
            events[name].append([torch.cuda.Event(enable_timing=True), None])
            events[name][-1][0].record()

        def post(mod, args, out, name=name):
            events[name][-1][1] = torch.cuda.Event(enable_timing=True)
            events[name][-1][1].record()
        for m in mods:
            handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (TILE_BATCH, 1, PATCH, PATCH)).astype(np.float32)).to(dev)
    try:
        with torch.inference_mode():
            model(x)
            torch.cuda.synchronize()
            for v in events.values():
                v.clear()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(iters):
                model(x)
            end.record()
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    ms = {name: sum(a.elapsed_time(b) for a, b in v) / iters for name, v in events.items()}
    ms["forward"] = start.elapsed_time(end) / iters
    log(f"[layers: {path}] per tile-batch forward ({TILE_BATCH} x {PATCH}^2, CUDA "
        f"events, mean of "
        f"{iters}): " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))
    return ms


def phase_parity(dev, model: DinoUNet):
    """Card bf16 vs CPU fp32 on one tile; returns the tile and the CPU logits
    for the routes' parity checks."""
    tile = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 1, PATCH, PATCH)).astype(np.float32))
    with torch.inference_mode():
        got = model.to(dev)(tile.to(dev)).float().cpu()
        ref_model = DinoUNet(dataclasses.replace(model.cfg, dtype="float32")).eval()
        ref_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        t0 = time.perf_counter()
        want = ref_model(tile)
        cpu_s = time.perf_counter() - t0
    rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    log(f"[parity] 512x512 tile, card bf16 vs CPU fp32 ({cpu_s:.1f} s): relative "
        f"L2 error {rel:.4e} (bound {PARITY_BOUND}); max abs "
        f"{float((got - want).abs().max()):.4e} of max |ref| "
        f"{float(want.abs().max()):.4e}")
    if not rel <= PARITY_BOUND:
        raise AssertionError(f"parity {rel} over {PARITY_BOUND}")
    return tile, want


def phase_route_parity(dev, model: DinoUNet, tile, want, path: str) -> float:
    """The parity tile as the first of a tile batch of 8 (the HWBC stages
    need batch 8) on the card with the route on, against the CPU fp32 logits
    of the stock model; the batch must launch the route's kernels."""
    others = np.random.default_rng(2).standard_normal(
        (TILE_BATCH - 1, 1, PATCH, PATCH)).astype(np.float32)
    batch = torch.cat([tile, torch.from_numpy(others)]).to(dev)
    _build.reset_launch_counts()
    with torch.inference_mode():
        got = model(batch)[:1].float().cpu()
    counts = _build.launch_counts()
    for k, n in PER_FORWARD_ROUTE[path].items():
        if counts[k] != n:
            raise AssertionError(f"{path} parity batch launched {counts}")
    rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    log(f"[parity: {path}] 512x512 tile, card bf16 with the route vs CPU fp32 "
        f"stock: relative L2 error {rel:.4e} (bound {PARITY_BOUND}); max abs "
        f"{float((got - want).abs().max()):.4e}")
    if not rel <= PARITY_BOUND:
        raise AssertionError(f"{path} parity {rel} over {PARITY_BOUND}")
    return rel


def _train_env(root: str) -> None:
    for sub in ("preprocessed", "results"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    os.environ["nnUNet_preprocessed"] = os.path.join(root, "preprocessed")
    os.environ["nnUNet_results"] = os.path.join(root, "results")
    write_disk_ring_dataset(os.environ["nnUNet_preprocessed"], TRAIN_DATASET, 6,
                            (640, 640), (PATCH, PATCH), 2, ARCH, seed=0)


def _trainer(dev):
    trainer = get_trainer_from_args(TRAIN_DATASET, "2d", 0, "DinoUNetTrainer_b",
                                    device=dev)
    trainer.seed = 0
    trainer.num_epochs = TRAIN_EPOCHS
    trainer.num_iterations_per_epoch = TRAIN_ITERS
    trainer.num_val_iterations_per_epoch = VAL_ITERS
    return trainer


def phase_train(dev) -> dict:
    trainer = _trainer(dev)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.run_training()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    n_steps = TRAIN_EPOCHS * TRAIN_ITERS
    n_val = TRAIN_EPOCHS * VAL_ITERS
    want = {k: n_steps * PER_TRAIN_STEP[k] + n_val * PER_FORWARD[k] for k in PER_FORWARD}
    log(f"[train] run_training: {TRAIN_EPOCHS} epochs x {TRAIN_ITERS} steps + "
        f"{VAL_ITERS} validation batches in {run_s:.1f} s; launches {counts}")
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, the path makes {want}")
    logged = trainer.logger.my_fantastic_logging
    losses = logged["train_losses"] + logged["val_losses"]
    log(f"[train] train losses {logged['train_losses']}, val losses "
        f"{logged['val_losses']}, pseudo dice {logged['dice_per_class_or_region']}")
    if len(losses) != 2 * TRAIN_EPOCHS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"logged losses {losses}")

    final = os.path.join(trainer.output_folder, "checkpoint_final.pth")
    if not os.path.isfile(final):
        raise AssertionError("no checkpoint_final.pth")
    fresh = _trainer(dev)
    fresh.load_checkpoint(final)
    trained = trainer.network.state_dict()
    for name, t in fresh.network.state_dict().items():
        if not torch.equal(t, trained[name]):
            raise AssertionError(f"checkpoint_final.pth restores {name} differently")
    if fresh.current_epoch != TRAIN_EPOCHS:
        raise AssertionError(f"resumed at epoch {fresh.current_epoch}")
    log(f"[train] checkpoint_final.pth ({os.path.getsize(final) / 2**20:.0f} MiB) "
        f"loaded into a fresh trainer: {len(trained)} tensors equal")
    del fresh

    _build.reset_launch_counts()
    trainer.train_step_host(trainer.dataloader_train.generate_train_batch())
    torch.cuda.synchronize()
    one = _build.launch_counts()
    if one != PER_TRAIN_STEP:
        raise AssertionError(f"one train step launched {one}, the path makes "
                             f"{PER_TRAIN_STEP}")

    torch.cuda.reset_peak_memory_stats(dev)
    step_losses, step_ms, load_ms = [], [], []
    for _ in range(LEARN_STEPS):
        t0 = time.perf_counter()
        batch = trainer.dataloader_train.generate_train_batch()
        t1 = time.perf_counter()
        step_losses.append(float(trainer.train_step_host(batch)))  # synchronises
        step_ms.append((time.perf_counter() - t1) * 1e3)
        load_ms.append((t1 - t0) * 1e3)
    first, last = float(np.mean(step_losses[:10])), float(np.mean(step_losses[-10:]))
    med = float(np.median(step_ms))
    log(f"[train] {LEARN_STEPS} more steps: mean loss of the first 10 {first:.4f}, "
        f"of the last 10 {last:.4f} (margin {first - last:.4f}); step "
        f"{med:.1f} ms median ({1e3 / med:.2f} steps/s, batch 2 x {PATCH}^2, "
        f"augmentation included; the host loader, which run_training overlaps "
        f"in a thread, {float(np.median(load_ms)):.1f} ms a batch); peak device "
        f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    if not np.all(np.isfinite(step_losses)) or not last < first:
        raise AssertionError(f"the loss did not fall: {step_losses}")
    for k, n in one.items():
        counts[k] += n
    return counts


def phase_train_parity(dev) -> None:
    pm = PlansManager(PLANS)
    arch = pm.get_configuration("2d").network_arch_init_kwargs
    cfg = DinoUNetConfig.from_plans_arch(arch, N_CLASSES, model_name="dinounet_b",
                                         drop_path_rate=0.0)
    card = DinoUNet(cfg).init_weights(seed=1).train()
    ref = DinoUNet(dataclasses.replace(cfg, dtype="float32")).train()
    ref.load_state_dict(card.state_dict())
    card.to(dev)
    img, seg = disk_ring_case(np.random.default_rng(2), 256, 256)
    x = torch.from_numpy(img)  # (1, 1, 256, 256)
    y = torch.from_numpy(seg[:, 0]).long()  # (1, 256, 256)

    def step(model, x, y):
        loss = dc_and_ce_loss(model(x), y, batch_dice=True, smooth=1e-5, do_bg=False)
        loss.backward()
        grads = {n: p.grad.float().flatten().cpu()
                 for n, p in model.named_parameters() if p.grad is not None}
        return float(loss.detach()), grads

    def rel_l2(got, want, names):
        g = torch.cat([got[n] for n in names])
        w = torch.cat([want[n] for n in names])
        return float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))

    backbone_before = [p.detach().clone() for p in
                       card.encoder.dinov3_adapter.backbone.parameters()]
    got_loss, got = step(card, x.to(dev), y.to(dev))
    t0 = time.perf_counter()
    want_loss, want = step(ref, x, y)
    cpu_s = time.perf_counter() - t0
    if got.keys() != want.keys():
        raise AssertionError("card and CPU steps give gradients to different parameters")
    names = sorted(want)
    # the projections in front of the MSDA kernels: their gradients are the
    # ones the MSDA backward kernel produces (checked on their own, since
    # they are a small part of the whole gradient's norm)
    msda = [n for n in names if ".attn." in n and "dinov3_adapter.interactions" in n]
    rel, rel_msda = rel_l2(got, want, names), rel_l2(got, want, msda)
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    log(f"[train parity] 256x256 step, card bf16 vs CPU fp32 ({cpu_s:.1f} s): loss "
        f"{got_loss:.5f} vs {want_loss:.5f} (rel {loss_rel:.3e}, bound "
        f"{TRAIN_LOSS_BOUND}); relative L2 of the {len(names)} trainable gradient "
        f"tensors {rel:.4e} (bound {TRAIN_GRAD_BOUND}), of the {len(msda)} MSDA "
        f"projections' {rel_msda:.4e} (bound {TRAIN_MSDA_GRAD_BOUND})")
    if not (rel <= TRAIN_GRAD_BOUND and rel_msda <= TRAIN_MSDA_GRAD_BOUND
            and loss_rel <= TRAIN_LOSS_BOUND):
        raise AssertionError(f"train parity: gradients {rel}, MSDA projections "
                             f"{rel_msda}, loss {loss_rel}")
    opt = sgd_nesterov([p for p in card.parameters() if p.requires_grad], 1e-2, 3e-5)
    clip_and_step(opt, 12.0)
    torch.cuda.synchronize()
    backbone = list(card.encoder.dinov3_adapter.backbone.parameters())
    if not all(torch.equal(a, b) for a, b in zip(backbone_before, backbone)):
        raise AssertionError("the optimizer step changed a backbone parameter")
    log(f"[train parity] an optimizer step left all {len(backbone)} backbone "
        "tensors unchanged")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"[env] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; python {sys.version.split()[0]}")
    phase_build()
    kernel_results = phase_kernels(dev)
    model = build_model()
    counts = {"serve": phase_serve(dev, model)}
    phase_layer_times(dev, model, "serve")
    tile, want = phase_parity(dev, model)
    for path, settings in ROUTES.items():
        with route_env(settings):
            counts[path] = phase_serve(dev, model, path)
            phase_layer_times(dev, model, path)
            phase_route_parity(dev, model, tile, want, path)
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        _train_env(root)
        counts["train"] = phase_train(dev)
    phase_train_parity(dev)

    log(card_line())
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": sum(c[name] for c in counts.values()),
         "launches_by_path": {path: c[name] for path, c in counts.items()},
         **kernel_results[name]}
        for name, (src, tpu) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
