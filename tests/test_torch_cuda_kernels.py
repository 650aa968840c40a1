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


def test_launches_are_counted(dev):
    _build.reset_launch_counts()
    qkv = torch.zeros((1, 3, 1, 64, 8), dtype=torch.bfloat16, device=dev)
    fused_rope_attention_premapped_dmaj(qkv, None, None)
    v, off, logits, base = _msda_case(8, 1, 1, 8, 4, 4, 2, 9, dev)
    v.requires_grad_(True)
    ms_deform_attn_premapped_fused(v, ((4, 4),), off, logits, base).sum().backward()
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    assert counts["rope_attention"] == 1
    assert counts["msda_fwd"] == 1 and counts["msda_bwd"] == 1


def test_bad_inputs_raise(dev):
    qkv = torch.zeros((1, 3, 1, 48, 8), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        fused_rope_attention_premapped_dmaj(qkv, None, None)  # Dh 48
    qkv64 = torch.zeros((1, 3, 1, 64, 8), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        fused_rope_attention_premapped_dmaj(qkv64, None, None)  # fp32
