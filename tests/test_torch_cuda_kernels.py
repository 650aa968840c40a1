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
from dinounet_tpu_torch.ops.attention import (fused_rope_attention,
                                              fused_rope_attention_premapped,
                                              fused_rope_attention_premapped_dmaj,
                                              rope_attention_dmaj_plain,
                                              rope_attention_ndh_plain,
                                              rope_attention_plain, rope_tables,
                                              rope_tables_dmaj)
from dinounet_tpu_torch.ops.dense_stats import (dense_cm_partial, dense_cm_partial_plain,
                                                dense_cm_residual_stats,
                                                dense_cm_residual_stats_plain,
                                                dense_partial_plain, dense_residual_partial,
                                                dense_residual_stats,
                                                dense_residual_stats_plain,
                                                post_reduce_residual_stats,
                                                post_reduce_residual_stats_plain)
from dinounet_tpu_torch.ops import dense_q8 as q8
from dinounet_tpu_torch.ops.kernel_check import (KERNEL_TOLERANCES, STATS_TOLERANCE,
                                                 max_excess)
from dinounet_tpu_torch.ops.msda import (ms_deform_attn_core_plain,
                                         ms_deform_attn_premapped_backward_plain,
                                         ms_deform_attn_premapped_fused_merged_plain,
                                         ms_deform_attn_premapped_fused_plain,
                                         ms_deform_attn_premapped_plain,
                                         premapped_fused_prep)
from dinounet_tpu_torch.ops.msda_kernel import (ms_deform_attn,
                                                ms_deform_attn_premapped,
                                                ms_deform_attn_premapped_backward,
                                                ms_deform_attn_premapped_fused,
                                                ms_deform_attn_premapped_fused_merged)

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


# D above 64 splits into 32-channel slices: a ragged last slice (80), and
# dinounet_7b's adapter heads (128); a head too wide for shared memory at
# its S (a 1024^2 patch, S = 4096) into narrower slices (16 or 24
# channels); a map of which not even 8 channels fit (S = 16384) goes
# through the global-gather instances (D 8: 16-byte corner loads, D 12:
# element loads). Ragged Lq, P 1 to 16, D 8 to 128, S not a multiple of 8
# (element-wise staging), points outside the map (the base grid reaches a
# pixel past every edge, the offsets 2 pixels a sigma)
MSDA_FWD_SHAPES = [(2, 3, 8, 5, 7, 4, 37), (1, 16, 24, 32, 32, 4, 5376),
                   (2, 3, 80, 6, 9, 4, 300), (1, 16, 128, 32, 32, 4, 5376),
                   (1, 4, 32, 64, 64, 4, 700), (1, 2, 128, 64, 64, 4, 300),
                   (1, 2, 24, 64, 64, 4, 300), (2, 3, 16, 9, 11, 1, 301),
                   (1, 4, 64, 16, 16, 16, 777), (3, 2, 24, 7, 9, 7, 99),
                   (1, 2, 64, 64, 64, 4, 300), (1, 2, 8, 128, 128, 4, 200),
                   (1, 2, 12, 128, 130, 2, 100), (1, 3, 128, 20, 20, 16, 129),
                   (2, 2, 32, 8, 8, 3, 513)]


@pytest.mark.parametrize("B,M,D,H,W,P,Lq", MSDA_FWD_SHAPES)
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


@pytest.mark.parametrize("B,M,D,H,W,P,Lq", MSDA_FWD_SHAPES)
def test_msda_merged_kernel_matches_plain(dev, B, M, D, H, W, P, Lq):
    v, off, logits, base = _msda_case(19, B, M, D, H, W, P, Lq, dev)
    packed = torch.cat([off, logits], dim=2)
    got = ms_deform_attn_premapped_fused_merged(v, ((H, W),), packed, base)
    want = ms_deform_attn_premapped_fused_merged_plain(v, ((H, W),), packed, base)
    torch.cuda.synchronize()
    assert max_excess(got, want, KERNEL_TOLERANCES["msda_fwd_merged"]) <= 0


def _at_odd_element(t):
    """A contiguous copy of t that starts one element into its storage (2
    bytes past a 4-byte boundary for bf16)."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 4 == 2
    return out


# a value map that is a contiguous view at an odd element: the staged
# instances take the element-wise staging (a whole head, slices) and the
# global one its token-major copy
@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("B,M,D,H,W,P,Lq", [(2, 3, 24, 8, 8, 4, 100), (1, 2, 80, 16, 16, 4, 130),
                                           (1, 2, 8, 128, 128, 4, 200)])
def test_msda_forward_on_odd_offset_map(dev, merged, B, M, D, H, W, P, Lq):
    v, off, logits, base = _msda_case(23, B, M, D, H, W, P, Lq, dev)
    vo = _at_odd_element(v)
    if merged:
        packed = torch.cat([off, logits], dim=2)
        got = ms_deform_attn_premapped_fused_merged(vo, ((H, W),), packed, base)
        want = ms_deform_attn_premapped_fused_merged_plain(v, ((H, W),), packed, base)
    else:
        got = ms_deform_attn_premapped_fused(vo, ((H, W),), off, logits, base)
        want = ms_deform_attn_premapped_fused_plain(v, ((H, W),), off, logits, base)
    torch.cuda.synchronize()
    assert max_excess(got, want, KERNEL_TOLERANCES["msda_fwd_merged" if merged else "msda_fwd"]) <= 0


def _prepped_case(seed, B, M, D, shapes, P, Lq, dev, dtype=torch.bfloat16):
    """A value map over `shapes` and fp32 pixel coordinates reaching past
    every edge of their level, softmaxed weights."""
    g = torch.Generator().manual_seed(seed)
    S, L = sum(h * w for h, w in shapes), len(shapes)
    v = _randn(g, (B, M, D, S), dev).to(dtype)
    xs, ys = torch.empty((B, M, L * P, Lq)), torch.empty((B, M, L * P, Lq))
    for lvl, (h, w) in enumerate(shapes):
        rows = slice(lvl * P, (lvl + 1) * P)
        xs[:, :, rows] = torch.rand((B, M, P, Lq), generator=g) * (w + 4) - 2.5
        ys[:, :, rows] = torch.rand((B, M, P, Lq), generator=g) * (h + 4) - 2.5
    aw = torch.softmax(torch.randn((B, M, L * P, Lq), generator=g), dim=2)
    return v, xs.to(dev), ys.to(dev), aw.to(dev)


# one and two levels, ragged Lq, bf16 and fp32 maps, a map over the shared
# memory a block has, heads over 64 channels
PREPPED_SHAPES = [(2, 3, 8, ((5, 7),), 4, 37), (1, 16, 24, ((32, 32),), 4, 5376),
                  (2, 3, 16, ((8, 16), (4, 8)), 2, 333), (1, 4, 32, ((64, 64),), 4, 700),
                  (1, 2, 96, ((12, 12), (6, 6)), 3, 130)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,M,D,shapes,P,Lq", PREPPED_SHAPES)
def test_msda_premapped_kernel_matches_plain(dev, dtype, B, M, D, shapes, P, Lq):
    v, xs, ys, aw = _prepped_case(20, B, M, D, shapes, P, Lq, dev, dtype)
    got = ms_deform_attn_premapped(v, shapes, xs, ys, aw)
    want = ms_deform_attn_premapped_plain(v, shapes, xs, ys, aw)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    tol = KERNEL_TOLERANCES["msda_fwd_premapped"] if dtype == torch.bfloat16 else (1e-5, 1e-5)
    assert max_excess(got, want, tol) <= 0


@pytest.mark.parametrize("B,M,D,H,W,P,Lq", [(2, 3, 8, 5, 7, 4, 37),
                                            (1, 2, 33, 6, 6, 3, 700),
                                            (2, 16, 24, 32, 32, 4, 5376),
                                            (2, 16, 32, 32, 32, 4, 5376),   # dinounet_l
                                            (1, 4, 128, 32, 32, 4, 700),    # the 7B
                                            (1, 2, 24, 64, 64, 4, 500),     # S = 4096
                                            (1, 2, 100, 7, 9, 2, 65)])
def test_msda_backward_kernel_matches_plain(dev, B, M, D, H, W, P, Lq):
    v, off, logits, base = _msda_case(3, B, M, D, H, W, P, Lq, dev)
    xs, ys, aw = (t.contiguous() for t in premapped_fused_prep(off, logits, base))
    cot = torch.randn((B, M, D, Lq), generator=torch.Generator().manual_seed(4)).to(dev)
    got = ms_deform_attn_premapped_backward(v, ((H, W),), xs, ys, aw, cot)
    want = ms_deform_attn_premapped_backward_plain(v, ((H, W),), xs, ys, aw, cot)
    torch.cuda.synchronize()
    for gt, wt in zip(got, want):
        assert max_excess(gt, wt, KERNEL_TOLERANCES["msda_bwd"]) <= 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,M,D,shapes,P,Lq", PREPPED_SHAPES)
def test_msda_backward_kernel_levels_match_plain(dev, dtype, B, M, D, shapes, P, Lq):
    """The backward over several levels and an fp32 map (the reference-layout
    entry's), prepped coordinates past every edge."""
    v, xs, ys, aw = _prepped_case(21, B, M, D, shapes, P, Lq, dev, dtype)
    cot = torch.randn((B, M, D, Lq), generator=torch.Generator().manual_seed(22)).to(dev)
    got = ms_deform_attn_premapped_backward(v, shapes, xs, ys, aw, cot)
    want = ms_deform_attn_premapped_backward_plain(v, shapes, xs, ys, aw, cot)
    torch.cuda.synchronize()
    for gt, wt in zip(got, want):
        assert max_excess(gt, wt, KERNEL_TOLERANCES["msda_bwd"]) <= 0


# the staged-cell layouts of #5 and #7: D 8 to 128 and D not a multiple of a
# cell (12, 20, 33), S not a multiple of 8 (35, 99), 1 to 4 levels, P 2 to
# 16, ragged Lq, heads in channel slices (D 128; D 20 and 33 at S 4096), and
# a map of which not one 16-byte cell a position fits a block (S 16640: the
# forward's token-major copy, the backward's device-memory instance);
# coordinates past every edge
MSDA_CELL_LAYOUTS = [(8, ((5, 7),), 4, 37), (16, ((32, 32),), 4, 300),
                     (24, ((8, 16), (4, 8), (2, 4), (1, 2)), 2, 129),
                     (32, ((12, 12), (6, 6)), 3, 200), (40, ((16, 16),), 4, 257),
                     (64, ((9, 11),), 16, 65), (128, ((32, 32),), 4, 700),
                     (20, ((64, 64),), 4, 300), (33, ((48, 64), (32, 32)), 2, 90),
                     (12, ((128, 130),), 2, 100)]
# (dtype, map at an odd element)
MSDA_CELL_MAPS = [(torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, False)]


@pytest.mark.parametrize("dtype,odd", MSDA_CELL_MAPS)
@pytest.mark.parametrize("D,shapes,P,Lq", MSDA_CELL_LAYOUTS)
def test_msda_premapped_cell_layouts_match_plain(dev, dtype, odd, D, shapes, P, Lq):
    v, xs, ys, aw = _prepped_case(25, 2, 3, D, shapes, P, Lq, dev, dtype)
    got = ms_deform_attn_premapped(_at_odd_element(v) if odd else v, shapes, xs, ys, aw)
    want = ms_deform_attn_premapped_plain(v, shapes, xs, ys, aw)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    tol = KERNEL_TOLERANCES["msda_fwd_premapped"] if dtype == torch.bfloat16 else (1e-5, 1e-5)
    assert max_excess(got, want, tol) <= 0


@pytest.mark.parametrize("dtype,odd", MSDA_CELL_MAPS)
@pytest.mark.parametrize("D,shapes,P,Lq", MSDA_CELL_LAYOUTS)
def test_msda_backward_cell_layouts_match_plain(dev, dtype, odd, D, shapes, P, Lq):
    """The backward in every layout; two calls give bit-equal ga, gx, gy."""
    v, xs, ys, aw = _prepped_case(26, 2, 3, D, shapes, P, Lq, dev, dtype)
    cot = torch.randn((2, 3, D, Lq), generator=torch.Generator().manual_seed(27)).to(dev)
    vk = _at_odd_element(v) if odd else v
    got = ms_deform_attn_premapped_backward(vk, shapes, xs, ys, aw, cot)
    again = ms_deform_attn_premapped_backward(vk, shapes, xs, ys, aw, cot)
    want = ms_deform_attn_premapped_backward_plain(v, shapes, xs, ys, aw, cot)
    torch.cuda.synchronize()
    for gt, wt in zip(got, want):
        assert max_excess(gt, wt, KERNEL_TOLERANCES["msda_bwd"]) <= 0
    for gt, ag in zip(got[1:], again[1:]):
        assert torch.equal(gt, ag)


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


def test_msda_merged_and_premapped_wrapper_grads_match_plain(dev):
    """The merged, premapped and reference-layout wrappers keep their
    grad_fn on the card; their gradients (the backward kernel) match
    autograd of the plain forwards."""
    v, off, logits, base = _msda_case(23, 2, 4, 24, 12, 12, 4, 333, dev)
    packed = torch.cat([off, logits], dim=2)
    leaves = [t.clone().requires_grad_(True) for t in (v, packed)]
    out = ms_deform_attn_premapped_fused_merged(leaves[0], ((12, 12),), leaves[1], base)
    assert out.grad_fn is not None
    ref = [t.clone().requires_grad_(True) for t in (v, packed)]
    want = _grads(ms_deform_attn_premapped_fused_merged_plain(ref[0], ((12, 12),), ref[1],
                                                              base), ref)
    for gt, wt in zip(_grads(out, leaves), want):
        assert max_excess(gt, wt, (2e-2, 2e-2)) <= 0

    shapes = ((8, 16), (4, 8))
    v, xs, ys, aw = _prepped_case(24, 2, 3, 16, shapes, 2, 100, dev, torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (v, xs, ys, aw)]
    ref = [t.clone().requires_grad_(True) for t in (v, xs, ys, aw)]
    got = _grads(ms_deform_attn_premapped(leaves[0], shapes, *leaves[1:]), leaves)
    want = _grads(ms_deform_attn_premapped_plain(ref[0], shapes, *ref[1:]), ref)
    for gt, wt in zip(got, want):
        # fp32 throughout: the sums differ in order (and gv by the atomics)
        assert max_excess(gt, wt, (1e-3, 1e-3)) <= 0

    # the reference layouts: value (B, S, M, D), normalized locations
    B, Lq, M, D, P = 2, 100, 3, 16, 2
    g = torch.Generator().manual_seed(25)
    value = _randn(g, (B, 160, M, D), dev)
    loc = (torch.rand((B, Lq, M, 2, P, 2), generator=g) * 1.2 - 0.1).to(dev)
    attn = torch.softmax(torch.randn((B, Lq, M, 2 * P), generator=g), -1).view(
        B, Lq, M, 2, P).to(dev)
    leaves = [t.clone().requires_grad_(True) for t in (value, loc, attn)]
    ref = [t.clone().requires_grad_(True) for t in (value, loc, attn)]
    got = _grads(ms_deform_attn(leaves[0], shapes, *leaves[1:]), leaves)
    want = _grads(ms_deform_attn_core_plain(ref[0], shapes, *ref[1:]), ref)
    for gt, wt in zip(got, want):
        assert max_excess(gt, wt, (1e-3, 1e-3)) <= 0


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


# the attention kernel's edges: its query tile and ring stage are 128 tokens
# (two consumer warpgroups of 64 rows), so N crosses a warpgroup, a tile
# and a stage at 64, 128 and 129; 1029 is dinounet_b's and the 7B's N
ATTENTION_NS = [1, 63, 64, 65, 127, 128, 129, 1029]


@pytest.mark.parametrize("N", ATTENTION_NS)
@pytest.mark.parametrize("B,M,Dh", [(2, 2, 64), (1, 3, 128)])
def test_attention_kernel_matches_plain(dev, B, M, Dh, N):
    g = torch.Generator().manual_seed(1)
    qkv = _randn(g, (B, 3, M, Dh, N), dev).to(torch.bfloat16)
    ang = torch.rand((N, Dh), generator=g) * 6.0
    sin, cos = torch.sin(ang).to(dev), torch.cos(ang).to(dev)
    for tables in ((sin, cos), (None, None)):  # with RoPE and without
        got = fused_rope_attention_premapped_dmaj(qkv, *tables)
        want = rope_attention_dmaj_plain(qkv, *rope_tables_dmaj(*tables, N, Dh, dev))
        torch.cuda.synchronize()
        assert got.shape == (B, M, Dh, N)
        assert max_excess(got, want, KERNEL_TOLERANCES["rope_attention"]) <= 0


@pytest.mark.parametrize("N", ATTENTION_NS)
@pytest.mark.parametrize("B,M,Dh", [(2, 2, 64), (1, 3, 128)])
def test_ndh_attention_kernel_matches_plain(dev, B, M, N, Dh):
    g = torch.Generator().manual_seed(26)
    qkv = _randn(g, (B, 3, M, N, Dh), dev).to(torch.bfloat16)
    ang = torch.rand((N, Dh), generator=g) * 6.0
    sin, cos = torch.sin(ang).to(dev), torch.cos(ang).to(dev)
    for tables in ((sin, cos), (None, None)):  # with RoPE and without
        got = fused_rope_attention_premapped(qkv, *tables)
        want = rope_attention_ndh_plain(qkv, *rope_tables(*tables, N, Dh, dev))
        torch.cuda.synchronize()
        assert got.shape == (B, M, Dh, N)
        assert max_excess(got, want, KERNEL_TOLERANCES["rope_attention_ndh"]) <= 0


@pytest.mark.parametrize("N", ATTENTION_NS)
@pytest.mark.parametrize("B,M,Dh", [(2, 2, 128), (1, 3, 64)])
def test_rowmajor_attention_kernel_matches_plain(dev, B, N, M, Dh):
    g = torch.Generator().manual_seed(16)
    qkv = _randn(g, (B, N, 3, M, Dh), dev).to(torch.bfloat16)
    ang = torch.rand((N, Dh), generator=g) * 6.0
    sin, cos = torch.sin(ang).to(dev), torch.cos(ang).to(dev)
    got = fused_rope_attention(qkv, sin, cos)
    want = rope_attention_plain(qkv, *rope_tables(sin, cos, N, Dh, dev))
    torch.cuda.synchronize()
    assert got.shape == (B, N, M, Dh)
    assert max_excess(got, want, KERNEL_TOLERANCES["rope_attention_rm"]) <= 0
    # no RoPE: identity tables
    got = fused_rope_attention(qkv, None, None)
    want = rope_attention_plain(qkv, *rope_tables(None, None, N, Dh, dev))
    torch.cuda.synchronize()
    assert max_excess(got, want, KERNEL_TOLERANCES["rope_attention_rm"]) <= 0


def test_rowmajor_attention_wrapper_grads_match_plain(dev):
    g = torch.Generator().manual_seed(17)
    qkv = _randn(g, (1, 70, 3, 2, 128), dev).to(torch.bfloat16)
    ang = torch.rand((70, 128), generator=g) * 6.0
    sin, cos = torch.sin(ang).to(dev), torch.cos(ang).to(dev)
    leaf = qkv.clone().requires_grad_(True)
    out = fused_rope_attention(leaf, sin, cos)
    assert out.grad_fn is not None
    ref = qkv.clone().requires_grad_(True)
    want = _grads(rope_attention_plain(ref, *rope_tables(sin, cos, 70, 128, dev)), [ref])
    torch.testing.assert_close(_grads(out, [leaf])[0], want[0])


def test_quant_dense_int_mm_equals_the_exact_product(dev):
    """QuantDense's and the ndh qkv's int8 product on the card
    (torch._int_mm) equals the CPU's exact float64 one: the same bf16 output
    bit for bit."""
    g = torch.Generator().manual_seed(18)
    for K in (40, 256):  # 40: the cached weight's rows padded to 48
        x = _randn(g, (2, 37, K), dev).to(torch.bfloat16)
        w, b = _randn(g, (96, K), dev, K ** -0.5), _randn(g, (96,), dev, 0.1)
        got = q8.quant_dense(x, w, b, torch.bfloat16)
        want = q8.quant_dense(x.cpu(), w.cpu(), b.cpu(), torch.bfloat16)
        assert torch.equal(got.cpu(), want)
    w3, b3 = _randn(g, (256, 768), dev, 256 ** -0.5), _randn(g, (768,), dev, 0.1)
    got = q8.qkv_q8_premapped(x, w3, b3, 4, 64)
    want = q8.qkv_q8_premapped(x.cpu(), w3.cpu(), b3.cpu(), 4, 64)
    assert got.shape == (2, 3, 4, 37, 64) and torch.equal(got.cpu(), want)


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


# the dense kernel's edges: a block takes 64 rows (128 where that still
# fills two waves: the last two shapes), a ring stage 64 channels of K, a
# pass 256 (or 128) features of D; A arrives through TMA where its rows are
# 16-byte aligned (K, or N channel-major, a multiple of 8) and through the
# producer's shifted windows elsewhere (N = 1029 channel-major, K = 37)
DENSE_EDGE_SHAPES = [(1, 1029, 768, 768), (1, 5376, 384, 768),  # the model's N
                     (2, 1, 40, 24), (2, 63, 37, 136), (2, 65, 64, 264),
                     (1, 127, 72, 136), (1, 129, 3072, 264),  # K 3072: the ring wraps
                     (1, 300, 128, 4096),
                     (1, 33793, 192, 264), (8, 4232, 40, 136)]


@pytest.mark.parametrize("weight", ["kd", "linear"])
@pytest.mark.parametrize("layout", ["rm", "rm_gelu", "cm"])
@pytest.mark.parametrize("B,N,K,D", DENSE_EDGE_SHAPES)
def test_dense_kernel_edges_match_plain(dev, B, N, K, D, layout, weight):
    """w as a contiguous fp32 (K, D) tensor (copied to the kernel's (D, K)
    bf16) or as a bf16 Linear weight's transpose (read in place)."""
    g = torch.Generator().manual_seed(3)
    bf = torch.bfloat16
    cm = layout == "cm"
    h = _randn(g, (B, K, N) if cm else (B, N, K), dev).to(bf)
    w = _randn(g, (K, D), dev, K ** -0.5)
    if weight == "linear":
        w = w.t().contiguous().to(bf).t()
    b = _randn(g, (D,), dev, 0.1)
    res = _randn(g, (B, N, D), dev).to(bf)
    gamma = _randn(g, (D,), dev, 0.5)
    if cm:
        got = dense_cm_residual_stats(h, w, b, res, gamma)
        want = dense_cm_residual_stats_plain(h, w, b, res, gamma)
        name = "dense_cm_stats"
    else:
        gelu = layout == "rm_gelu"
        got = dense_residual_stats(h, w, b, res, gamma, apply_gelu=gelu)
        want = dense_residual_stats_plain(h, w, b, res, gamma, gelu)
        name = "dense_rm_stats"
    torch.cuda.synchronize()
    for gt, wt in zip(got, want):
        assert gt.shape == wt.shape
        assert max_excess(gt, wt, KERNEL_TOLERANCES[name]) <= 0


@pytest.mark.parametrize("layout", ["rm", "rm_gelu", "cm"])
@pytest.mark.parametrize("B,N,K,D", DENSE_EDGE_SHAPES + [(2, 21, 37, 25)])  # D odd
def test_row_parallel_mode_matches_plain(dev, B, N, K, D, layout):
    """The row-parallel mode of the dense kernel (the fp32 product, no
    epilogue), then the post-reduce pass on it: each against its plain
    version, the pass's output bit for bit."""
    g = torch.Generator().manual_seed(4)
    bf = torch.bfloat16
    cm = layout == "cm"
    h = _randn(g, (B, K, N) if cm else (B, N, K), dev).to(bf)
    w = _randn(g, (K, D), dev, K ** -0.5).t().contiguous().to(bf).t()
    if cm:
        got, want, name = dense_cm_partial(h, w), dense_cm_partial_plain(h, w), "dense_cm_partial"
    else:
        gelu = layout == "rm_gelu"
        got = dense_residual_partial(h, w, apply_gelu=gelu)
        want, name = dense_partial_plain(h, w, gelu), "dense_rm_partial"
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape == (B, N, D)
    assert max_excess(got, want, KERNEL_TOLERANCES[name]) <= 0
    b = _randn(g, (D,), dev, 0.1)
    res = _randn(g, (B, N, D), dev).to(bf)
    gamma = _randn(g, (D,), dev, 0.5)
    outs = post_reduce_residual_stats(want, b, res, gamma)
    plain = post_reduce_residual_stats_plain(want, b, res, gamma)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], plain[0])
    for gt, wt in zip(outs[1:], plain[1:]):
        assert max_excess(gt, wt, KERNEL_TOLERANCES["post_reduce_stats"]) <= 0


@pytest.mark.parametrize("rows,D,offset", [(1, 24, 0), (37, 136, 0), (8232, 768, 0),
                                          (100, 25, 0), (5, 4096, 0), (9, 64, 1)])
def test_post_reduce_pass_matches_plain(dev, rows, D, offset):
    """The post-reduce pass's 16-byte path and its element path (D not a
    multiple of 4; a residual view at an odd element): the output bit for
    bit, the statistics within the kernel's bound."""
    g = torch.Generator().manual_seed(5)
    acc = _randn(g, (1, rows, D), dev, 2.0)
    b, gamma = _randn(g, (D,), dev, 0.1), _randn(g, (D,), dev, 0.5)
    res = _randn(g, (rows * D + offset,), dev).to(torch.bfloat16)[offset:].view(1, rows, D)
    got = post_reduce_residual_stats(acc, b, res, gamma)
    want = post_reduce_residual_stats_plain(acc, b, res, gamma)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for gt, wt in zip(got[1:], want[1:]):
        assert max_excess(gt, wt, KERNEL_TOLERANCES["post_reduce_stats"]) <= 0


# the int8 ops: ragged N (not a multiple of the GEMM's 64- or 128-row tile),
# D not a multiple of its 256-feature pass (24, 136, 264), K not a multiple
# of 16, 32 or 128 (37 is not even one of 8: the quantize pass's scalar
# loads), the dinounet_b ViT shapes (fc1, also at the path's tile batch of
# 8, fc2, the attention projection) and the adapter's (ConvFFN fc2 K 192,
# MSDA projection K 384, N 5376); the weight as a contiguous (K, D) tensor
# or as a Linear weight's transpose, as the models pass it. Without the
# GELU `out` is bit-equal to the plain version
INT8_SHAPES = [(2, 21, 40, 24), (2, 130, 72, 136), (2, 100, 48, 264), (3, 65, 200, 136),
               (2, 64, 37, 136), (1, 77, 96, 264), (1, 1029, 768, 3072),
               (8, 1029, 768, 3072), (1, 1029, 3072, 768), (1, 5376, 192, 768),
               (1, 5376, 384, 768)]


def _int8_case(g, dev, op, B, N, K, D, weight):
    bf = torch.bfloat16
    cm = op == "dense_cm_q8_stats"
    h = _randn(g, (B, K, N) if cm else (B, N, K), dev).to(bf)
    w = _randn(g, (K, D), dev, K ** -0.5)
    if weight == "linear":
        w = torch.nn.Parameter(w.t().contiguous(), requires_grad=False).t()
    b = _randn(g, (D,), dev, 0.1)
    res, gamma = _randn(g, (B, N, D), dev).to(bf), _randn(g, (D,), dev, 0.5)
    return h, w, b, res, gamma


def _int8_call(op, h, w, b, res, gamma, plain=False):
    if op == "qkv_q8_dmaj":  # w (C, 3C): 4 heads of C / 4
        fn = q8.qkv_q8_dmaj_plain if plain else q8.qkv_q8_dmaj
        return (fn(h, w, b, 4, w.shape[1] // 12),)
    if op == "dense_q8":
        fn = q8.dense_q8_plain if plain else q8.dense_q8
        return (fn(h, w, b),)
    if op == "dense_cm_q8_stats":
        fn = q8.dense_cm_q8_residual_stats_plain if plain else q8.dense_cm_q8_residual_stats
        return fn(h, w, b, res, gamma)
    pro = "gelu" if op.endswith("gelu") else "none"
    fn = q8.dense_q8_residual_stats_plain if plain else q8.dense_q8_residual_stats
    return fn(h, w, b, res, gamma, pro)


def _check_int8(op, got, want):
    torch.cuda.synchronize()
    name = "dense_q8_stats" if op.startswith("dense_q8_stats") else op
    for gt, wt in zip(got, want):
        assert gt.shape == wt.shape and gt.dtype == wt.dtype
        assert max_excess(gt, wt, KERNEL_TOLERANCES[name]) <= 0
    if not op.endswith("gelu"):
        assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("weight", ["kd", "linear"])
@pytest.mark.parametrize("op", ["dense_q8", "dense_q8_stats", "dense_q8_stats_gelu",
                                "dense_cm_q8_stats"])
@pytest.mark.parametrize("B,N,K,D", INT8_SHAPES)
def test_int8_dense_kernel_matches_plain(dev, op, B, N, K, D, weight):
    g = torch.Generator().manual_seed(13)
    args = _int8_case(g, dev, op, B, N, K, D, weight)
    _check_int8(op, _int8_call(op, *args), _int8_call(op, *args, plain=True))


@pytest.mark.parametrize("op", ["dense_q8", "dense_q8_stats_gelu", "dense_cm_q8_stats",
                                "qkv_q8_dmaj"])
def test_int8_dense_kernel_after_weight_update(dev, op):
    """A repeated call after an in-place update of the weight (as
    load_state_dict makes one) uses the new weight's levels."""
    g = torch.Generator().manual_seed(16)
    D = 3 * 200 if op == "qkv_q8_dmaj" else 264
    h, w, b, res, gamma = _int8_case(g, dev, op, 2, 130, 200, D, "linear")
    first = _int8_call(op, h, w, b, res, gamma)
    with torch.no_grad():
        w._base.copy_(_randn(g, tuple(w._base.shape), dev, 0.2))
    got = _int8_call(op, h, w, b, res, gamma)
    _check_int8(op, got, _int8_call(op, h, w, b, res, gamma, plain=True))
    assert not torch.equal(got[0], first[0])


@pytest.mark.parametrize("channel_major,gelu", [(False, False), (False, True),
                                                (True, False)])
@pytest.mark.parametrize("B,N,K", [(2, 21, 40), (2, 130, 37), (1, 1029, 768),
                                   (1, 5376, 384), (1, 70, 2048)])
def test_int8_quantize_pass_matches_plain(dev, channel_major, gelu, B, N, K):
    """The quantize pass's token-major levels and scales equal the plain
    version's bit for bit (with the GELU: where the kernel's erff and
    PyTorch's erf agree, a level at most one apart elsewhere)."""
    g = torch.Generator().manual_seed(17)
    h = _randn(g, (B, K, N) if channel_major else (B, N, K), dev, 3.0).to(torch.bfloat16)
    pro = "gelu" if gelu else "none"
    xq, a = q8.quantize_act_tokens(h, channel_major, pro)
    torch.cuda.synchronize()
    want_q, want_a = q8.quantize_act_tokens(h.cpu(), channel_major, pro)
    assert xq.shape == want_q.shape and a.shape == want_a.shape
    if gelu:
        assert (xq.cpu().int() - want_q.int()).abs().max() <= 1
        torch.testing.assert_close(a.cpu(), want_a, rtol=2.0 ** -7, atol=0)
    else:
        assert torch.equal(xq.cpu(), want_q) and torch.equal(a.cpu(), want_a)


# the int8 mode on a model axis of 2: B N rows ragged against the GEMM's
# 128-row tiles, a rank's K / 2 not a multiple of 16 (37, 20) or of 128, D
# not a multiple of the 256-feature pass, nor of 8 (130: the post-reduce
# pass's and the whole op's element paths) nor of 4 (30: the int32 stores'
# element path); dinounet_b's shapes at one tile
SPLIT_SHAPES = [(2, 21, 80, 24), (2, 130, 74, 136), (3, 65, 400, 130), (1, 33, 40, 30),
                (1, 1029, 768, 768)]


@pytest.mark.parametrize("form", ["cm", "gelu"])
@pytest.mark.parametrize("B,N,K,D", SPLIT_SHAPES)
def test_int8_row_parallel_mode_split_equals_whole(dev, form, B, N, K, D):
    """#12's (channel-major) and #11's (row-major, with the GELU) row-parallel
    mode over two ranks' halves of K on one card: each half's maxima (the
    quantize pass's first mode) as the plain version's (with the GELU within
    a bf16 ulp: erff against PyTorch's erf); each half's int32 product at
    the joint maxima equal to the exact product of the kernel's own levels
    (and #12's to the plain version's); the summed product through the int8
    post-reduce pass equal to the whole #12 / #11 op bit for bit, stream and
    statistics, and its stream to the pass's plain version's."""
    g = torch.Generator().manual_seed(21)
    cm = form == "cm"
    prologue = "none" if cm else "gelu"
    h = _randn(g, (B, K, N) if cm else (B, N, K), dev, 2.0).to(torch.bfloat16)
    w = _randn(g, (D, K), dev, K ** -0.5).t()  # a Linear weight's transpose
    b, gamma = _randn(g, (D,), dev, 0.1), _randn(g, (D,), dev, 0.5)
    res = _randn(g, (B, N, D), dev).to(torch.bfloat16)
    if cm:
        whole = q8.dense_cm_q8_residual_stats(h, w, b, res, gamma)
    else:
        whole = q8.dense_q8_residual_stats(h, w, b, res, gamma, prologue)
    halves = [t.contiguous() for t in h.split(K // 2, dim=1 if cm else 2)]
    w_halves = w.split(K // 2, dim=0)
    maxima = [q8.act_amax(t, cm, prologue) for t in halves]
    for t, m in zip(halves, maxima):
        want = q8.act_amax_plain(t, cm, prologue)
        torch.testing.assert_close(m, want, rtol=0 if cm else 2.0 ** -7, atol=0)
    amax = torch.maximum(*maxima)
    wmax = torch.maximum(*(t.abs().amax(0, keepdim=True) for t in w_halves))
    acc = 0
    for t, wt in zip(halves, w_halves):
        wq, ws = q8.quantize_weight_dk(wt, amax=wmax)
        if cm:
            part, a = q8.dense_cm_q8_partial(t, wq, amax)
        else:
            part, a = q8.dense_q8_partial(t, wq, amax, prologue)
        xq, a_own = q8.quantize_act_tokens(t, cm, prologue, amax)
        k = wt.shape[0]
        exact = torch.einsum("nk,dk->nd", xq[:, :k].double(), wq[:, :k].double())
        assert torch.equal(part.view(-1, D), exact.to(torch.int32)) and torch.equal(a, a_own)
        if cm:
            plain = q8.dense_q8_partial_plain(t, wq, amax, prologue, cm)
            assert torch.equal(part, plain[0]) and torch.equal(a, plain[1])
        acc = acc + part
    got = q8.post_reduce_q8_residual_stats(acc, a, ws, b, res, gamma)
    plain = q8.post_reduce_q8_residual_stats_plain(acc, a, ws, b, res, gamma)
    torch.cuda.synchronize()
    for x, y in zip(got, whole):
        assert torch.equal(x, y)
    assert torch.equal(got[0], plain[0])
    for x, y in zip(got[1:], plain[1:]):
        assert max_excess(x, y, KERNEL_TOLERANCES["post_reduce_q8_stats"]) <= 0


# the qkv's GEMM tiles run over the flattened B N tokens: N 63 / 64 / 65 /
# 129 with B 3 put tile edges inside and across images, N 37 a whole image
# inside one tile; C 40 and 200 (K neither a multiple of 128 nor of 16
# before padding, 3C not one of the 256-feature pass); dinounet_b's qkv at
# one tile and at the path's tile batch of 8
QKV_SHAPES = [(2, 37, 64, 4), (1, 130, 40, 2), (3, 63, 64, 4), (3, 64, 64, 4),
              (3, 65, 64, 4), (3, 129, 64, 4), (3, 65, 40, 2), (3, 129, 200, 8),
              (2, 1029, 768, 12), (8, 1029, 768, 12)]


@pytest.mark.parametrize("weight", ["kd", "linear"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("B,N,C,M", QKV_SHAPES)
def test_qkv_q8_dmaj_kernel_matches_plain(dev, bias, B, N, C, M, weight):
    """Bit-equal to the plain version (the same levels, exact int32 sums,
    the rescale rounded once where the plain version rounds)."""
    g = torch.Generator().manual_seed(14)
    x = _randn(g, (B, N, C), dev).to(torch.bfloat16)
    w, b = _randn(g, (C, 3 * C), dev, C ** -0.5), _randn(g, (3 * C,), dev, 0.1)
    if weight == "linear":
        w = torch.nn.Parameter(w.t().contiguous(), requires_grad=False).t()
    b = b if bias else None
    got = q8.qkv_q8_dmaj(x, w, b, M, C // M)
    want = q8.qkv_q8_dmaj_plain(x, w, b, M, C // M)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B, 3, M, C // M, N)
    assert max_excess(got, want, KERNEL_TOLERANCES["qkv_q8_dmaj"]) <= 0
    assert torch.equal(got, want)


def test_int8_wrapper_grads_match_plain(dev):
    """The int8 wrappers keep their grad_fn on the card; their backward (the
    plain version, recomputed) gives the plain version's gradients."""
    g = torch.Generator().manual_seed(15)
    bf = torch.bfloat16
    B, N, K, D = 2, 21, 48, 24
    args = [_randn(g, (B, N, K), dev).to(bf), _randn(g, (K, D), dev, K ** -0.5),
            _randn(g, (D,), dev, 0.1), _randn(g, (B, N, D), dev).to(bf),
            _randn(g, (D,), dev, 0.5)]
    leaves = [a.clone().requires_grad_(True) for a in args]
    ref = [a.clone().requires_grad_(True) for a in args]
    outs = q8.dense_q8_residual_stats(*leaves, "gelu")
    assert all(o.grad_fn is not None for o in outs)
    want = _grads(q8.dense_q8_residual_stats_plain(*ref, "gelu"), ref)
    for gt, wt in zip(_grads(outs, leaves), want):
        torch.testing.assert_close(gt, wt)


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


def _conv_inputs(g, dev, B, C1, C2, H, W, Cout, pro):
    bf = torch.bfloat16
    x = _randn(g, (B, C1, H, W), dev).to(bf)
    x2 = _randn(g, (B, C2, H, W), dev).to(bf) if C2 else None
    w = _randn(g, (Cout, C1 + C2, 3, 3), dev, (9 * (C1 + C2)) ** -0.5)
    b = _randn(g, (Cout,), dev, 0.1)
    p = _prologue(g, B, C1 + C2, dev) if pro else None
    return x, x2, w, b, p


# ragged maps (W not a multiple of the 128-pixel tile, odd H), each Cout the
# kernel takes, two inputs, the prologue, and the SPM form (slope 0, no
# stats); the multi-row tile's edges: H not a multiple of its rows and H 1;
# W 63, 127, 129 (row strides TMA cannot take: the loader's own loads), 64,
# 65 and 200 (TMA, a partial second tile); B 3; two inputs of 32 + 16; Cin
# 256 -> 128 (16 chunks, each with a 37 KB weight slice) on a ragged map, by
# TMA and by the loader's loads; 450 tiles, more than the persistent grid's
# blocks, so that each block walks several tiles and images; each Cout with
# the prologue at slopes 0.01 and 0, with and without statistics
@pytest.mark.parametrize("B,C1,C2,H,W,Cout,pro,slope,stats", [
    (2, 16, 0, 9, 37, 16, False, 0.01, True),
    (2, 32, 16, 12, 130, 32, True, 0.01, True),
    (1, 64, 64, 20, 64, 128, False, 0.01, True),
    (3, 64, 0, 17, 256, 64, True, 0.0, False),
    (2, 16, 0, 1, 64, 16, True, 0.01, True),
    (1, 32, 0, 1, 129, 128, True, 0.01, True),
    (1, 32, 0, 5, 63, 32, True, 0.01, True),
    (2, 32, 0, 6, 64, 32, False, 0.01, True),
    (1, 16, 16, 7, 65, 64, True, 0.0, True),
    (2, 64, 0, 3, 127, 64, True, 0.01, True),
    (1, 32, 32, 9, 129, 128, True, 0.01, True),
    (3, 32, 16, 7, 200, 32, True, 0.01, True),
    (1, 256, 0, 11, 129, 128, True, 0.01, True),
    (1, 128, 128, 6, 200, 128, False, 0.01, True),
    (2, 16, 0, 300, 260, 16, True, 0.01, True),
] + [(2, 32, 16, 6, 72, co, True, slope, stats) for co in (16, 32, 64, 128)
     for slope in (0.01, 0.0) for stats in (True, False)])
def test_conv3x3_cm_kernel_matches_plain(dev, B, C1, C2, H, W, Cout, pro, slope, stats):
    g = torch.Generator().manual_seed(9)
    x, x2, w, b, p = _conv_inputs(g, dev, B, C1, C2, H, W, Cout, pro)
    _check_conv("conv3x3_cm", conv3x3_cm(x, w, b, p, slope, stats, x2),
                conv3x3_cm_plain(x, w, b, p, slope, stats, x2), H * W)


@pytest.mark.parametrize("W", [136, 37])
def test_conv3x3_cm_kernel_on_channel_slices(dev, W):
    """Non-contiguous inputs: channel slices x[:, 16:48] and x2[:, 32:48] of
    larger maps (by TMA at W 136, by the loader's loads at W 37)."""
    g = torch.Generator().manual_seed(13)
    B, H, Cout = 2, 10, 32
    big = _randn(g, (B, 64, H, W), dev).to(torch.bfloat16)
    x, x2 = big[:, 16:48], big[:, 32:48]
    assert not x.is_contiguous()
    w = _randn(g, (Cout, 48, 3, 3), dev, (9 * 48) ** -0.5)
    b = _randn(g, (Cout,), dev, 0.1)
    p = _prologue(g, B, 48, dev)
    _check_conv("conv3x3_cm", conv3x3_cm(x, w, b, p, 0.01, True, x2),
                conv3x3_cm_plain(x, w, b, p, 0.01, True, x2), H * W)


@pytest.mark.parametrize("Cin,Cout", [(64, 32), (256, 128)])
def test_conv3x3_cm_kernel_after_weight_update(dev, Cin, Cout):
    """A repeated call after an in-place update of the weight (as
    load_state_dict makes one) packs the new weight."""
    g = torch.Generator().manual_seed(14)
    x, _, w, b, _ = _conv_inputs(g, dev, 2, Cin, 0, 8, 96, Cout, False)
    first = conv3x3_cm(x, w, b)
    with torch.no_grad():
        w.copy_(_randn(g, tuple(w.shape), dev, (9 * Cin) ** -0.5))
    got = conv3x3_cm(x, w, b)
    _check_conv("conv3x3_cm", got, conv3x3_cm_plain(x, w, b), 8 * 96)
    assert not torch.equal(got[0], first[0])


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


# Cout 4 (GEMM width 16 in a 128-wide pass), ragged W and pixel tiles (H W
# not a multiple of the 128-pixel tile, nor of 8: one word a pixel), H 1, W 1,
# B 3, Cin 16 to 512 (a 512-channel tile leaves room for one staged tile),
# Cout 4 to 512 (up to 8 passes of 256 columns; a small map's passes split
# across blocks), the prologue on and off, channels-last inputs (as the FAPM
# may hand LearnableUpsample its maps; by TMA, and through the producer's own
# loads where a pixel's channels are not 16-byte aligned), and the path's
# shapes at tile batch 8
@pytest.mark.parametrize("B,Cin,Cout,H,W,pro,cl", [
    (2, 16, 4, 5, 7, False, False),
    (2, 64, 32, 16, 130, True, False),
    (1, 32, 40, 8, 64, True, True),
    (8, 256, 128, 64, 64, False, False),
    (3, 64, 32, 11, 13, True, False),
    (1, 32, 8, 1, 200, False, False),
    (2, 48, 12, 9, 1, True, False),
    (3, 16, 16, 1, 1, False, False),
    (2, 128, 64, 12, 24, True, True),
    (1, 256, 256, 8, 16, False, False),
    (1, 512, 16, 4, 8, True, False),
    (1, 64, 512, 4, 4, False, False),
    (3, 96, 68, 7, 40, True, False),
    (2, 32, 36, 6, 6, False, True),
    (8, 64, 32, 256, 256, True, False),
    (8, 32, 32, 256, 256, False, False),
    (8, 256, 256, 32, 32, False, False),
])
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


@pytest.mark.parametrize("view", ["channel_slice", "column_stride", "odd_channels_last"])
def test_transpconv2x2_kernel_on_views(dev, view):
    """Non-contiguous inputs: a channel slice of a larger map (TMA), every
    other column (the producer's own loads), a channels-last slice whose
    pixels are 36 channels apart (72 bytes: TMA needs 16-byte strides, so
    the producer's own loads)."""
    g = torch.Generator().manual_seed(15)
    B, H, W = 2, 6, 40
    if view == "channel_slice":
        x = _randn(g, (B, 64, H, W), dev).to(torch.bfloat16)[:, 16:48]
    elif view == "column_stride":
        x = _randn(g, (B, 32, H, 2 * W), dev).to(torch.bfloat16)[..., ::2]
    else:
        x = _randn(g, (B, 36, H, W), dev).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)[:, :32]
    assert not x.is_contiguous()
    w = _randn(g, (32, 24, 2, 2), dev, 32 ** -0.5)
    b = _randn(g, (24,), dev, 0.1)
    p = _prologue(g, B, 32, dev)
    for pro in (None, p):
        got, want = transpconv2x2_cm(x, w, b, pro), transpconv2x2_cm_plain(x, w, b, pro)
        torch.cuda.synchronize()
        assert max_excess(got, want, KERNEL_TOLERANCES["transpconv2x2_cm"]) <= 0


@pytest.mark.parametrize("Cin,Cout", [(64, 32), (256, 128)])
def test_transpconv2x2_kernel_after_weight_update(dev, Cin, Cout):
    """A repeated call after an in-place update of the weight (as
    load_state_dict makes one) packs the new weight; a bf16 bias is
    converted again after its update."""
    g = torch.Generator().manual_seed(16)
    x = _randn(g, (2, Cin, 8, 24), dev).to(torch.bfloat16)
    w = _randn(g, (Cin, Cout, 2, 2), dev, Cin ** -0.5)
    b = _randn(g, (Cout,), dev, 0.1).to(torch.bfloat16)
    first = transpconv2x2_cm(x, w, b)
    with torch.no_grad():
        w.copy_(_randn(g, tuple(w.shape), dev, Cin ** -0.5))
        b.add_(0.5)
    got = transpconv2x2_cm(x, w, b)
    torch.cuda.synchronize()
    assert max_excess(got, transpconv2x2_cm_plain(x, w, b),
                      KERNEL_TOLERANCES["transpconv2x2_cm"]) <= 0
    assert not torch.equal(got, first)


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


# the kernel's edges: H * W a multiple of 4 but not of 8 (element loads), C
# not a multiple of the 8-channel chunk, 9 and 17 classes (two and four
# threads a unit, the last group part-filled), 512 channels at 32 classes,
# and the path's tile batch of 8 at 512^2 (32 channels to 3 and 14 classes)
@pytest.mark.parametrize("B,C,H,W,K", [(2, 32, 6, 10, 3), (1, 20, 8, 16, 5), (2, 24, 8, 24, 9),
                                       (1, 40, 4, 64, 17), (1, 512, 8, 16, 32),
                                       (8, 32, 512, 512, 3), (8, 32, 512, 512, 14)])
def test_seg_head_kernel_edges_match_plain(dev, B, C, H, W, K):
    g = torch.Generator().manual_seed(13)
    x = _randn(g, (B, C, H, W), dev).to(torch.bfloat16)
    w = _randn(g, (K, C, 1, 1), dev, C ** -0.5)
    b = _randn(g, (K,), dev, 0.1)
    p = _prologue(g, B, C, dev)
    got, want = seg_head_cm(x, w, b, p), seg_head_cm_plain(x, w, b, p)
    torch.cuda.synchronize()
    assert got.shape == (B, K, H, W)
    assert max_excess(got, want, KERNEL_TOLERANCES["seg_head_cm"]) <= 0


# an input that is a contiguous view one element into a larger buffer: its
# pointer 2 bytes past a 16-byte boundary, which a 16-byte load would fault
# on; the kernel loads it element by element
@pytest.mark.parametrize("B,C,H,W,K", [(2, 32, 16, 16, 3), (2, 32, 64, 64, 14)])
def test_seg_head_kernel_on_odd_offset_input(dev, B, C, H, W, K):
    g = torch.Generator().manual_seed(14)
    x = _at_odd_element(_randn(g, (B, C, H, W), dev).to(torch.bfloat16))
    w = _randn(g, (K, C, 1, 1), dev, C ** -0.5)
    b = _randn(g, (K,), dev, 0.1)
    p = _prologue(g, B, C, dev)
    got, want = seg_head_cm(x, w, b, p), seg_head_cm_plain(x, w, b, p)
    torch.cuda.synchronize()
    assert max_excess(got, want, KERNEL_TOLERANCES["seg_head_cm"]) <= 0


def test_seg_head_kernel_after_weight_update(dev):
    """A repeated call after an in-place update of the weight and of a bf16
    bias (as load_state_dict makes them) takes the new values: the prepared
    weight and the fp32 bias are made again."""
    g = torch.Generator().manual_seed(15)
    B, C, K = 2, 32, 3
    x = _randn(g, (B, C, 16, 32), dev).to(torch.bfloat16)
    w = _randn(g, (K, C, 1, 1), dev, C ** -0.5)
    b = _randn(g, (K,), dev, 0.1).to(torch.bfloat16)
    p = _prologue(g, B, C, dev)
    first = seg_head_cm(x, w, b, p)
    with torch.no_grad():
        w.copy_(_randn(g, tuple(w.shape), dev, C ** -0.5))
        b.add_(0.5)
    got = seg_head_cm(x, w, b, p)
    torch.cuda.synchronize()
    assert max_excess(got, seg_head_cm_plain(x, w, b, p),
                      KERNEL_TOLERANCES["seg_head_cm"]) <= 0
    assert not torch.equal(got, first)


def test_seg_head_bad_inputs_raise(dev):
    x = torch.zeros((1, 16, 4, 8), dtype=torch.bfloat16, device=dev)
    w, b = torch.zeros((3, 16, 1, 1), device=dev), torch.zeros(3, device=dev)
    p = (torch.ones((1, 16), device=dev), torch.zeros((1, 16), device=dev))
    with pytest.raises(ValueError):
        seg_head_cm(x, w, b, None)  # the kernel takes a prologue, as the JAX kernel does
    with pytest.raises(ValueError):
        seg_head_cm(x, torch.zeros((33, 16, 1, 1), device=dev), torch.zeros(33, device=dev), p)
    with pytest.raises(ValueError):
        seg_head_cm(x, torch.zeros((3, 8, 1, 1), device=dev), b, p)  # 8 channels, x has 16
    with pytest.raises(ValueError):
        seg_head_cm(x.float(), w, b, p)


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
    # past the kernel's 512 input channels: its C entry refuses the launch
    xw = torch.zeros((1, 528, 2, 2), dtype=torch.bfloat16, device=dev)
    with pytest.raises(RuntimeError):
        transpconv2x2_cm(xw, torch.zeros((528, 4, 2, 2), device=dev), torch.zeros(4, device=dev))


def test_launches_are_counted(dev):
    _build.reset_launch_counts()
    qkv = torch.zeros((1, 3, 1, 64, 8), dtype=torch.bfloat16, device=dev)
    fused_rope_attention_premapped_dmaj(qkv, None, None)
    fused_rope_attention(qkv.permute(0, 4, 1, 2, 3).contiguous(), None, None)
    fused_rope_attention_premapped(qkv.transpose(3, 4).contiguous(), None, None)
    v, off, logits, base = _msda_case(8, 1, 1, 8, 4, 4, 2, 9, dev)
    v.requires_grad_(True)
    ms_deform_attn_premapped_fused(v, ((4, 4),), off, logits, base).sum().backward()
    ms_deform_attn_premapped_fused_merged(v.detach(), ((4, 4),),
                                          torch.cat([off, logits], 2), base)
    xs, ys, aw = (t.contiguous() for t in premapped_fused_prep(off, logits, base))
    ms_deform_attn_premapped(v.detach(), ((4, 4),), xs, ys, aw)
    x = torch.zeros((8, 16, 4, 128), dtype=torch.bfloat16, device=dev)
    w, b = torch.zeros((16, 16, 3, 3), device=dev), torch.zeros(16, device=dev)
    p = (torch.ones((8, 16), device=dev), torch.zeros((8, 16), device=dev))
    conv3x3_cm(x, w, b)
    conv3x3_hwbc(x.permute(2, 3, 0, 1), w, b)
    h = torch.zeros((1, 8, 16), dtype=torch.bfloat16, device=dev)
    wq, bq = torch.ones((16, 48), device=dev), torch.zeros(48, device=dev)
    res = torch.zeros((1, 8, 48), dtype=torch.bfloat16, device=dev)
    q8.dense_q8(h, wq, bq)
    q8.dense_q8_residual_stats(h, wq, bq, res, bq, "gelu")
    q8.dense_cm_q8_residual_stats(h.transpose(1, 2).contiguous(), wq, bq, res, bq)
    q8.qkv_q8_dmaj(h, wq, bq, 2, 8)
    amax = q8.act_amax(h, prologue="gelu")
    wqq = q8.quantized_weight(wq)[0]
    acc, a = q8.dense_q8_partial(h, wqq, amax, "gelu")
    q8.dense_cm_q8_partial(h.transpose(1, 2).contiguous(), wqq, amax)
    q8.post_reduce_q8_residual_stats(acc, a, torch.ones(48, device=dev), bq, res, bq)
    transpconv2x2_cm(x, torch.zeros((16, 4, 2, 2), device=dev), torch.zeros(4, device=dev))
    seg_head_cm(x, torch.zeros((3, 16, 1, 1), device=dev), torch.zeros(3, device=dev), p)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    assert counts["rope_attention"] == 1 and counts["rope_attention_rm"] == 1
    assert counts["rope_attention_ndh"] == 1
    assert counts["msda_fwd"] == 1 and counts["msda_bwd"] == 1
    assert counts["msda_fwd_merged"] == 1 and counts["msda_fwd_premapped"] == 1
    assert all(counts[k] == 1 for k in ("conv3x3_cm", "conv3x3_hwbc",
                                        "transpconv2x2_cm", "seg_head_cm", "qkv_q8_dmaj",
                                        "dense_q8", "dense_q8_stats", "dense_cm_q8_stats",
                                        "act_amax", "dense_q8_partial",
                                        "dense_cm_q8_partial", "post_reduce_q8_stats"))


def test_bad_inputs_raise(dev):
    qkv = torch.zeros((1, 3, 1, 48, 8), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        fused_rope_attention_premapped_dmaj(qkv, None, None)  # Dh 48
    qkv64 = torch.zeros((1, 3, 1, 64, 8), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        fused_rope_attention_premapped_dmaj(qkv64, None, None)  # fp32
    with pytest.raises(ValueError):
        fused_rope_attention(torch.zeros((1, 8, 3, 1, 48), dtype=torch.bfloat16,
                                         device=dev), None, None)  # Dh 48
    with pytest.raises(ValueError):
        fused_rope_attention(qkv64.permute(0, 4, 1, 2, 3).contiguous(), None, None)
