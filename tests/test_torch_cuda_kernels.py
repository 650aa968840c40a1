"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where no CUDA device is present (as on a
CPU-only machine). The file imports no JAX, so it also runs on a GPU machine
without JAX: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py``.
Shapes are small and ragged (no multiple of the kernels' tiles) plus one at the
dinounet_b widths; tolerances are the kernels' own (see ``KERNEL_TOLERANCES``).
"""

import pytest
import torch

from dinounet_tpu_torch.ops import _build
from dinounet_tpu_torch.ops.attention import (fused_rope_attention_premapped_dmaj,
                                              rope_attention_dmaj_plain,
                                              rope_tables_dmaj)
from dinounet_tpu_torch.ops.dense_stats import (dense_cm_residual_stats,
                                                dense_cm_residual_stats_plain,
                                                dense_residual_stats,
                                                dense_residual_stats_plain)
from dinounet_tpu_torch.ops.kernel_check import KERNEL_TOLERANCES, max_excess
from dinounet_tpu_torch.ops.msda import ms_deform_attn_premapped_fused_plain
from dinounet_tpu_torch.ops.msda_kernel import ms_deform_attn_premapped_fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(gen, shape, dev, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(dev)


@pytest.mark.parametrize("B,M,D,H,W,P,Lq", [(2, 3, 8, 5, 7, 4, 37),
                                            (1, 16, 24, 32, 32, 4, 5376)])
def test_msda_kernel_matches_plain(dev, B, M, D, H, W, P, Lq):
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    v = _randn(g, (B, M, D, H * W), dev).to(bf)
    off = _randn(g, (B, M, 2 * P, Lq), dev, 2.0).to(bf)
    logits = _randn(g, (B, M, P, Lq), dev).to(bf)
    base = (torch.rand((2 * P, Lq), generator=g) * (max(H, W) + 2) - 1.5).to(dev)
    got = ms_deform_attn_premapped_fused(v, ((H, W),), off, logits, base)
    want = ms_deform_attn_premapped_fused_plain(v, ((H, W),), off, logits, base)
    torch.cuda.synchronize()
    assert max_excess(got, want, KERNEL_TOLERANCES["msda_fwd"]) <= 0


@pytest.mark.parametrize("B,M,Dh,N", [(2, 2, 64, 37), (1, 3, 128, 130),
                                      (1, 12, 64, 1029)])
def test_attention_kernel_matches_plain(dev, B, M, Dh, N):
    g = torch.Generator().manual_seed(1)
    qkv = _randn(g, (B, 3, M, Dh, N), dev).to(torch.bfloat16)
    ang = torch.rand((N, Dh), generator=g) * 6.0
    sin, cos = torch.sin(ang).to(dev), torch.cos(ang).to(dev)
    got = fused_rope_attention_premapped_dmaj(qkv, sin, cos)
    want = rope_attention_dmaj_plain(qkv, *rope_tables_dmaj(sin, cos, N, Dh, dev))
    torch.cuda.synchronize()
    assert max_excess(got, want, KERNEL_TOLERANCES["rope_attention"]) <= 0


# the channel-major op has no GELU prologue
@pytest.mark.parametrize("channel_major,gelu", [(False, False), (False, True),
                                                (True, False)])
@pytest.mark.parametrize("B,N,K,D", [(2, 21, 40, 24),      # ragged N and D
                                     (2, 64, 37, 136),     # K not a multiple of 8
                                     (1, 1029, 768, 768)])
def test_dense_kernel_matches_plain(dev, channel_major, gelu, B, N, K, D):
    g = torch.Generator().manual_seed(2)
    bf = torch.bfloat16
    h = _randn(g, (B, K, N) if channel_major else (B, N, K), dev).to(bf)
    w = _randn(g, (K, D), dev, K ** -0.5)
    b = _randn(g, (D,), dev, 0.1)
    res = _randn(g, (B, N, D), dev).to(bf)
    gamma = _randn(g, (D,), dev, 0.5)
    if channel_major:
        got = dense_cm_residual_stats(h, w, b, res, gamma)
        want = dense_cm_residual_stats_plain(h, w, b, res, gamma)
        name = "dense_cm_stats"
    else:
        got = dense_residual_stats(h, w, b, res, gamma, apply_gelu=gelu)
        want = dense_residual_stats_plain(h, w, b, res, gamma, gelu)
        name = "dense_rm_stats"
    torch.cuda.synchronize()
    for gt, wt in zip(got, want):
        assert max_excess(gt, wt, KERNEL_TOLERANCES[name]) <= 0


def test_launches_are_counted(dev):
    _build.reset_launch_counts()
    qkv = torch.zeros((1, 3, 1, 64, 8), dtype=torch.bfloat16, device=dev)
    fused_rope_attention_premapped_dmaj(qkv, None, None)
    torch.cuda.synchronize()
    assert _build.launch_counts()["rope_attention"] == 1


def test_bad_inputs_raise(dev):
    qkv = torch.zeros((1, 3, 1, 48, 8), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        fused_rope_attention_premapped_dmaj(qkv, None, None)  # Dh 48
    qkv64 = torch.zeros((1, 3, 1, 64, 8), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        fused_rope_attention_premapped_dmaj(qkv64, None, None)  # fp32
