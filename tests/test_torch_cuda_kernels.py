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
from dinounet_tpu_torch.ops.conv_hwbc import conv3x3_hwbc, conv3x3_hwbc_plain
from dinounet_tpu_torch.ops.decoder_tail import (conv3x3_cm, conv3x3_cm_plain,
                                                 seg_head_cm, seg_head_cm_plain,
                                                 transpconv2x2_cm,
                                                 transpconv2x2_cm_plain)
from dinounet_tpu_torch.ops.attention import (fused_rope_attention_premapped_dmaj,
                                              rope_attention_dmaj_plain,
                                              rope_tables_dmaj)
from dinounet_tpu_torch.ops.dense_stats import (dense_cm_residual_stats,
                                                dense_cm_residual_stats_plain,
                                                dense_residual_stats,
                                                dense_residual_stats_plain)
from dinounet_tpu_torch.ops.kernel_check import (KERNEL_TOLERANCES, STATS_TOLERANCE,
                                                 max_excess)
from dinounet_tpu_torch.ops.msda import (ms_deform_attn_premapped_backward_plain,
                                         ms_deform_attn_premapped_fused_plain,
                                         premapped_fused_prep)
from dinounet_tpu_torch.ops.msda_kernel import (ms_deform_attn_premapped_backward,
                                                ms_deform_attn_premapped_fused)

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


def _msda_case(seed, B, M, D, H, W, P, Lq, dev):
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    v = _randn(g, (B, M, D, H * W), dev).to(bf)
    off = _randn(g, (B, M, 2 * P, Lq), dev, 2.0).to(bf)
    logits = _randn(g, (B, M, P, Lq), dev).to(bf)
    base = (torch.rand((2 * P, Lq), generator=g) * (max(H, W) + 2) - 1.5).to(dev)
    return v, off, logits, base


@pytest.mark.parametrize("B,M,D,H,W,P,Lq", [(2, 3, 8, 5, 7, 4, 37),
                                            (1, 2, 33, 6, 6, 3, 700),
                                            (2, 16, 24, 32, 32, 4, 5376)])
def test_msda_backward_kernel_matches_plain(dev, B, M, D, H, W, P, Lq):
    v, off, logits, base = _msda_case(3, B, M, D, H, W, P, Lq, dev)
    xs, ys, aw = (t.contiguous() for t in premapped_fused_prep(off, logits, base))
    cot = torch.randn((B, M, D, Lq), generator=torch.Generator().manual_seed(4)).to(dev)
    got = ms_deform_attn_premapped_backward(v, ((H, W),), xs, ys, aw, cot)
    want = ms_deform_attn_premapped_backward_plain(v, ((H, W),), xs, ys, aw, cot)
    torch.cuda.synchronize()
    for gt, wt in zip(got, want):
        assert max_excess(gt, wt, KERNEL_TOLERANCES["msda_bwd"]) <= 0


def _grads(outs, leaves, seed=6):
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator().manual_seed(seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=gen).to(o.device)).sum()
               for o in outs)
    return torch.autograd.grad(loss, leaves)


def test_msda_wrapper_grads_match_plain(dev):
    """The kernel wrapper keeps its grad_fn on the card; its gradients (the
    backward kernel) match autograd of the plain forward."""
    v, off, logits, base = _msda_case(5, 2, 4, 24, 12, 12, 4, 333, dev)
    leaves = [t.clone().requires_grad_(True) for t in (v, off, logits)]
    out = ms_deform_attn_premapped_fused(leaves[0], ((12, 12),), leaves[1],
                                         leaves[2], base)
    assert out.grad_fn is not None
    got = _grads(out, leaves)
    ref = [t.clone().requires_grad_(True) for t in (v, off, logits)]
    want = _grads(ms_deform_attn_premapped_fused_plain(
        ref[0], ((12, 12),), ref[1], ref[2], base), ref)
    torch.cuda.synchronize()
    for gt, wt in zip(got, want):
        # both round the bf16 gradients from fp32 sums taken in another order
        assert max_excess(gt, wt, (2e-2, 2e-2)) <= 0


def test_attention_and_dense_wrapper_grads_match_plain(dev):
    """Section-0 repair on the card: the kernel wrappers return tensors with a
    grad_fn, and their backward (the plain version, recomputed) gives the
    plain version's gradients."""
    g = torch.Generator().manual_seed(7)
    bf = torch.bfloat16
    qkv = _randn(g, (1, 3, 2, 64, 70), dev).to(bf)
    ang = torch.rand((70, 64), generator=g) * 6.0
    sin, cos = torch.sin(ang).to(dev), torch.cos(ang).to(dev)
    leaf = qkv.clone().requires_grad_(True)
    out = fused_rope_attention_premapped_dmaj(leaf, sin, cos)
    assert out.grad_fn is not None
    ref = qkv.clone().requires_grad_(True)
    want = _grads(rope_attention_dmaj_plain(ref, *rope_tables_dmaj(sin, cos, 70, 64, dev)),
                  [ref])
    torch.testing.assert_close(_grads(out, [leaf])[0], want[0])

    B, N, K, D = 2, 21, 40, 24
    for channel_major, gelu in ((False, True), (True, False)):
        h = _randn(g, (B, K, N) if channel_major else (B, N, K), dev).to(bf)
        args = [h, _randn(g, (K, D), dev, K ** -0.5), _randn(g, (D,), dev, 0.1),
                _randn(g, (B, N, D), dev).to(bf), _randn(g, (D,), dev, 0.5)]
        leaves = [a.clone().requires_grad_(True) for a in args]
        ref = [a.clone().requires_grad_(True) for a in args]
        if channel_major:
            outs = dense_cm_residual_stats(*leaves)
            want = _grads(dense_cm_residual_stats_plain(*ref), ref)
        else:
            outs = dense_residual_stats(*leaves, apply_gelu=gelu)
            want = _grads(dense_residual_stats_plain(*ref, gelu), ref)
        assert all(o.grad_fn is not None for o in outs)
        for gt, wt in zip(_grads(outs, leaves), want):
            torch.testing.assert_close(gt, wt)


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


def _prologue(g, B, C, dev):
    return ((torch.rand((B, C), generator=g) + 0.5).to(dev),
            _randn(g, (B, C), dev, 0.3))


def _check_conv(name, got, want, n):
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    torch.cuda.synchronize()
    assert got[0].shape == want[0].shape and got[0].dtype == want[0].dtype
    assert max_excess(got[0], want[0], KERNEL_TOLERANCES[name]) <= 0
    for gt, wt in zip(got[1:], want[1:]):
        assert max_excess(gt / n, wt / n, STATS_TOLERANCE) <= 0


# ragged maps (W not a multiple of the 128-pixel tile, odd H), each Cout the
# kernel takes, two inputs, the prologue, and the SPM form (slope 0, no stats)
@pytest.mark.parametrize("B,C1,C2,H,W,Cout,pro,slope,stats", [
    (2, 16, 0, 9, 37, 16, False, 0.01, True),
    (2, 32, 16, 12, 130, 32, True, 0.01, True),
    (1, 64, 64, 20, 64, 128, False, 0.01, True),
    (3, 64, 0, 17, 256, 64, True, 0.0, False),
])
def test_conv3x3_cm_kernel_matches_plain(dev, B, C1, C2, H, W, Cout, pro, slope, stats):
    g = torch.Generator().manual_seed(9)
    bf = torch.bfloat16
    x = _randn(g, (B, C1, H, W), dev).to(bf)
    x2 = _randn(g, (B, C2, H, W), dev).to(bf) if C2 else None
    w = _randn(g, (Cout, C1 + C2, 3, 3), dev, (9 * (C1 + C2)) ** -0.5)
    b = _randn(g, (Cout,), dev, 0.1)
    p = _prologue(g, B, C1 + C2, dev) if pro else None
    _check_conv("conv3x3_cm", conv3x3_cm(x, w, b, p, slope, stats, x2),
                conv3x3_cm_plain(x, w, b, p, slope, stats, x2), H * W)


@pytest.mark.parametrize("nchw_backed", [False, True])
def test_conv3x3_hwbc_kernel_matches_plain(dev, nchw_backed):
    """(H, W, B, C) maps, contiguous or as views of NCHW buffers (the
    decoder's form: the output keeps the input's memory layout)."""
    g = torch.Generator().manual_seed(10)
    bf = torch.bfloat16
    H, W, B, C, Co = 6, 140, 8, 32, 32

    def hwbc(shape_nchw):
        t = _randn(g, shape_nchw, dev).to(bf)
        return t.permute(2, 3, 0, 1) if nchw_backed else t.permute(2, 3, 0, 1).contiguous()

    x, x2 = hwbc((B, C, H, W)), hwbc((B, C, H, W))
    w = _randn(g, (Co, 2 * C, 3, 3), dev, (18 * C) ** -0.5)
    b = _randn(g, (Co,), dev, 0.1)
    p = _prologue(g, B, 2 * C, dev)
    got = conv3x3_hwbc(x, w, b, x2=x2, prologue=p)
    _check_conv("conv3x3_hwbc", got, conv3x3_hwbc_plain(x, w, b, x2=x2, prologue=p), H * W)
    assert got[0].permute(2, 3, 0, 1).is_contiguous() == nchw_backed
    w1 = w[:, :C].contiguous()
    _check_conv("conv3x3_hwbc", conv3x3_hwbc(x, w1, b),
                conv3x3_hwbc_plain(x, w1, b), H * W)


# Cout 4 (GEMM width 16), ragged W, two 128-column blocks with a partial one,
# a channels-last input (as the FAPM hands LearnableUpsample its maps)
@pytest.mark.parametrize("B,Cin,Cout,H,W,pro,cl", [(2, 16, 4, 5, 7, False, False),
                                                   (2, 64, 32, 16, 130, True, False),
                                                   (1, 32, 40, 8, 64, True, True),
                                                   (8, 256, 128, 64, 64, False, False)])
def test_transpconv2x2_kernel_matches_plain(dev, B, Cin, Cout, H, W, pro, cl):
    g = torch.Generator().manual_seed(11)
    x = _randn(g, (B, Cin, H, W), dev).to(torch.bfloat16)
    if cl:
        x = x.contiguous(memory_format=torch.channels_last)
    w = _randn(g, (Cin, Cout, 2, 2), dev, Cin ** -0.5)
    b = _randn(g, (Cout,), dev, 0.1)
    p = _prologue(g, B, Cin, dev) if pro else None
    got = transpconv2x2_cm(x, w, b, p)
    want = transpconv2x2_cm_plain(x, w, b, p)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, Cout, 2 * H, 2 * W)
    assert max_excess(got, want, KERNEL_TOLERANCES["transpconv2x2_cm"]) <= 0


# H * W not a multiple of 4 (the scalar path), and each class-count template
@pytest.mark.parametrize("B,C,H,W,K", [(2, 16, 7, 9, 3), (2, 32, 16, 128, 5),
                                       (1, 64, 8, 40, 14), (1, 16, 4, 4, 32)])
def test_seg_head_kernel_matches_plain(dev, B, C, H, W, K):
    g = torch.Generator().manual_seed(12)
    x = _randn(g, (B, C, H, W), dev).to(torch.bfloat16)
    w = _randn(g, (K, C, 1, 1), dev, C ** -0.5)
    b = _randn(g, (K,), dev, 0.1)
    p = _prologue(g, B, C, dev)
    got, want = seg_head_cm(x, w, b, p), seg_head_cm_plain(x, w, b, p)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (B, K, H, W)
    assert max_excess(got, want, KERNEL_TOLERANCES["seg_head_cm"]) <= 0


def test_conv_family_bad_inputs_raise(dev):
    x = torch.zeros((1, 16, 4, 4), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        conv3x3_cm(x, torch.zeros((48, 16, 3, 3), device=dev), torch.zeros(48, device=dev))
    with pytest.raises(ValueError):
        conv3x3_cm(x.float(), torch.zeros((16, 16, 3, 3), device=dev),
                   torch.zeros(16, device=dev))
    with pytest.raises(ValueError):
        transpconv2x2_cm(x[:, :8], torch.zeros((8, 4, 2, 2), device=dev),
                         torch.zeros(4, device=dev))


def test_launches_are_counted(dev):
    _build.reset_launch_counts()
    qkv = torch.zeros((1, 3, 1, 64, 8), dtype=torch.bfloat16, device=dev)
    fused_rope_attention_premapped_dmaj(qkv, None, None)
    v, off, logits, base = _msda_case(8, 1, 1, 8, 4, 4, 2, 9, dev)
    v.requires_grad_(True)
    ms_deform_attn_premapped_fused(v, ((4, 4),), off, logits, base).sum().backward()
    x = torch.zeros((8, 16, 4, 128), dtype=torch.bfloat16, device=dev)
    w, b = torch.zeros((16, 16, 3, 3), device=dev), torch.zeros(16, device=dev)
    p = (torch.ones((8, 16), device=dev), torch.zeros((8, 16), device=dev))
    conv3x3_cm(x, w, b)
    conv3x3_hwbc(x.permute(2, 3, 0, 1), w, b)
    transpconv2x2_cm(x, torch.zeros((16, 4, 2, 2), device=dev), torch.zeros(4, device=dev))
    seg_head_cm(x, torch.zeros((3, 16, 1, 1), device=dev), torch.zeros(3, device=dev), p)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    assert counts["rope_attention"] == 1
    assert counts["msda_fwd"] == 1 and counts["msda_bwd"] == 1
    assert all(counts[k] == 1 for k in ("conv3x3_cm", "conv3x3_hwbc",
                                        "transpconv2x2_cm", "seg_head_cm"))


def test_bad_inputs_raise(dev):
    qkv = torch.zeros((1, 3, 1, 48, 8), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        fused_rope_attention_premapped_dmaj(qkv, None, None)  # Dh 48
    qkv64 = torch.zeros((1, 3, 1, 64, 8), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        fused_rope_attention_premapped_dmaj(qkv64, None, None)  # fp32
