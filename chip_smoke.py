"""Smoke run of the PyTorch/CUDA port's serving path on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the exit code is
not 0:

1. build   -- compile the CUDA kernels from dinounet_tpu_torch/csrc/.
2. kernels -- each kernel against its plain PyTorch version on the card, at
              the shapes the dinounet_b tile forward gives it (tile batch 8),
              within its stated tolerance; kernel and plain times (CUDA
              events, median of 20).
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

Then the card's name and power limit, one JSON line of kernel results, and
as the last line {"ok": true, "device": {...}}. Without a CUDA device the
script raises before printing any result.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from dinounet_tpu_torch.inference.predictor import nnUNetPredictor
from dinounet_tpu_torch.models.dinounet import DinoUNet, DinoUNetConfig
from dinounet_tpu_torch.models.vit import rope_sincos
from dinounet_tpu_torch.ops import _build
from dinounet_tpu_torch.ops.attention import (fused_rope_attention_premapped_dmaj,
                                              rope_attention_dmaj_plain,
                                              rope_tables_dmaj)
from dinounet_tpu_torch.ops.dense_stats import (dense_cm_residual_stats,
                                                dense_cm_residual_stats_plain,
                                                dense_residual_stats,
                                                dense_residual_stats_plain)
from dinounet_tpu_torch.ops.kernel_check import (KERNEL_TOLERANCES, max_abs_err,
                                                 max_excess, median_ms)
from dinounet_tpu_torch.ops.msda import ms_deform_attn_premapped_fused_plain
from dinounet_tpu_torch.ops.msda_kernel import ms_deform_attn_premapped_fused
from dinounet_tpu_torch.utilities.plans_handler import PlansManager

TILE_BATCH = 8
PATCH = 512
CASE = (1, 1, 1280, 1280)
N_CLASSES = 3
# bf16 on the card vs fp32 on the CPU, relative L2 of the logits; the JAX
# package holds its own bf16 path to 0.15 (tests/test_vit_parity.py)
PARITY_BOUND = 0.05
# kernel launches per tile-batch forward of dinounet_b
PER_FORWARD = {"rope_attention": 12, "dense_cm_stats": 18, "dense_rm_stats": 18,
               "msda_fwd": 6}
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "rope_attention": ("dinounet_tpu_torch/csrc/rope_attention.cu",
                       "dinounet_tpu/ops/attention_pallas.py:110"),
    "dense_cm_stats": ("dinounet_tpu_torch/csrc/dense_stats.cu",
                       "dinounet_tpu/ops/dense_stats_pallas.py:241"),
    "dense_rm_stats": ("dinounet_tpu_torch/csrc/dense_stats.cu",
                       "dinounet_tpu/ops/dense_stats_pallas.py:71"),
    "msda_fwd": ("dinounet_tpu_torch/csrc/msda_fwd.cu",
                 "dinounet_tpu/ops/msda_pallas.py:251"),
}
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


def _compare(name, shape_desc, kernel_fn, plain_fn):
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    tol = KERNEL_TOLERANCES[name]
    excess = max(max_excess(g, w, tol) for g, w in zip(got, want))
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    rel = max(max_abs_err(g, w) / max(float(w.float().abs().max()), 1e-30)
              for g, w in zip(got, want))
    ms, plain_ms = median_ms(kernel_fn), median_ms(plain_fn)
    log(f"[kernels] {name} {shape_desc}: max abs err {err:.3e} (max rel "
        f"{rel:.3e}; bound atol {tol[0]} + rtol {tol[1]}*|ref|, excess "
        f"{excess:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if not excess <= 0:
        raise AssertionError(f"{name} {shape_desc}: kernel disagrees with its "
                             f"plain version (excess {excess})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_kernels(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    B = TILE_BATCH

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    results = {}
    # attention: ViT-B, 12 heads of 64 over 5 + 32 * 32 tokens
    N, M, Dh = 1029, 12, 64
    qkv = randn(B, 3, M, Dh, N).to(bf)
    sin, cos = rope_sincos(32, 32, Dh, device=dev)
    sin = torch.cat([torch.zeros((5, Dh), device=dev), sin])
    cos = torch.cat([torch.ones((5, Dh), device=dev), cos])
    tables = rope_tables_dmaj(sin, cos, N, Dh, dev)
    results["rope_attention"] = _compare(
        "rope_attention", f"qkv {tuple(qkv.shape)}",
        lambda: fused_rope_attention_premapped_dmaj(qkv, sin, cos),
        lambda: rope_attention_dmaj_plain(qkv, *tables))

    # dense + residual + stats: (K, N) of the ViT and of the adapter, D = 768
    D = 768
    for K, N, where in ((768, 1029, "vit proj"), (384, 5376, "msda output proj")):
        h = randn(B, K, N).to(bf)
        w, b = randn(K, D, scale=K ** -0.5), randn(D, scale=0.1)
        res, gamma = randn(B, N, D).to(bf), randn(D, scale=0.5)
        r = _compare("dense_cm_stats", f"{where} K={K} N={N}",
                     lambda: dense_cm_residual_stats(h, w, b, res, gamma),
                     lambda: dense_cm_residual_stats_plain(h, w, b, res, gamma))
        results.setdefault("dense_cm_stats", r)
    for K, N, where in ((3072, 1029, "vit fc2"), (192, 5376, "convffn fc2")):
        h = randn(B, N, K).to(bf)
        w, b = randn(K, D, scale=K ** -0.5), randn(D, scale=0.1)
        res, gamma = randn(B, N, D).to(bf), randn(D, scale=0.5)
        r = _compare("dense_rm_stats", f"{where} +GELU K={K} N={N}",
                     lambda: dense_residual_stats(h, w, b, res, gamma, apply_gelu=True),
                     lambda: dense_residual_stats_plain(h, w, b, res, gamma, True))
        results.setdefault("dense_rm_stats", r)

    # MSDA: 16 heads of 24 channels over the 32 x 32 ViT grid, 5376 queries
    # around the adapter's reference grid, 4 points
    Mq, Dv, Hv, P, Lq = 16, 24, 32, 4, 5376
    v = randn(B, Mq, Dv, Hv * Hv).to(bf)
    off = randn(B, Mq, 2 * P, Lq, scale=2.0).to(bf)
    logits = randn(B, Mq, P, Lq).to(bf)
    base = torch.rand((2 * P, Lq), generator=g, device=dev) * Hv - 0.5
    results["msda_fwd"] = _compare(
        "msda_fwd", f"value {tuple(v.shape)} Lq={Lq}",
        lambda: ms_deform_attn_premapped_fused(v, ((Hv, Hv),), off, logits, base),
        lambda: ms_deform_attn_premapped_fused_plain(v, ((Hv, Hv),), off, logits, base))
    return results


def build_model() -> DinoUNet:
    pm = PlansManager(PLANS)
    arch = pm.get_configuration("2d").network_arch_init_kwargs
    cfg = DinoUNetConfig.from_plans_arch(arch, N_CLASSES, model_name="dinounet_b")
    return DinoUNet(cfg).init_weights(seed=0).eval()


def phase_serve(dev, model: DinoUNet) -> dict:
    pm = PlansManager(PLANS)
    predictor = nnUNetPredictor(tile_step_size=0.5, use_mirroring=False,
                                device=dev, tile_batch=TILE_BATCH)
    predictor.manual_initialization(model, pm, pm.get_configuration("2d"), None,
                                    DATASET_JSON, "nnUNetTrainer", None)
    case = np.random.default_rng(0).standard_normal(CASE).astype(np.float32)
    n_tiles, n_batches = 16, 2

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    logits = predictor.predict_logits_from_preprocessed_data(case)
    first_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    log(f"[serve] first case {first_s:.2f} s; launches {counts}")
    want = {k: n * n_batches for k, n in PER_FORWARD.items()}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, the path makes {want}")
    if logits.shape != (N_CLASSES,) + CASE[1:] or logits.dtype != np.float16:
        raise AssertionError(f"logits {logits.shape} {logits.dtype}")
    if not np.all(np.isfinite(logits)):
        raise AssertionError("non-finite logits")
    log(f"[serve] logits {logits.shape} {logits.dtype}, all finite, "
        f"mean {float(logits.astype(np.float32).mean()):.4f} "
        f"std {float(logits.astype(np.float32).std()):.4f}")

    torch.cuda.reset_peak_memory_stats(dev)
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        predictor.predict_logits_from_preprocessed_data(case)
        rates.append(n_tiles / (time.perf_counter() - t0))
    log(f"[serve] tiles/s over 3 repeats: {', '.join(f'{r:.2f}' for r in rates)} "
        f"(median {sorted(rates)[1]:.2f}); peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return counts


def phase_parity(dev, model: DinoUNet) -> float:
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
    return rel


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
    counts = phase_serve(dev, model)
    phase_parity(dev, model)

    log(card_line())
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": counts[name], **kernel_results[name]}
        for name, (src, tpu) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
