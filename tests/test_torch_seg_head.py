"""The seg head's wrapper pieces on the CPU: its weight prepared for the
kernel, the reading of that weight against the JAX kernel, and the cache.

``pack_seg_weight`` turns a (K, C, 1, 1) or (K, C) weight into the (C, K)
fp32 array csrc/seg_head.cu reads, holding the bf16-rounded values the
JAX kernel multiplies by. The prepared weight's reading, the kernel's
arithmetic written out (leaky(x * s + t) rounded to x's dtype, times the
(C, K) weight, summed in fp32, plus the bias), is held against the JAX
``seg_head_cm`` in Pallas interpret mode at 1e-4 / 1e-4 (fp32 sums of the
same exact products in another order) on bf16 maps, the kernel's only
input, at 3, 14 and 32 classes and 16 to 64 channels. ``packed_seg_weight`` keeps the array on the weight's storage
owner, tied to its version counter, so a call makes no launch for it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinounet_tpu_torch.ops import decoder_tail as t_tail


def _reading(x, wk, b, prologue, slope=0.01):
    """The op from the prepared (C, K) weight, as the kernel computes it."""
    xa = t_tail.apply_prologue(x, prologue, slope).float()
    return torch.einsum("bchw,ck->bkhw", xa, wk) + b.float()[:, None, None]


@pytest.mark.parametrize("C,K", [(16, 3), (16, 14), (64, 3), (64, 14), (32, 32)])
def test_prepared_reading_matches_jax(C, K):
    from dinounet_tpu.ops.decoder_tail_pallas import seg_head_cm as jax_seg

    rng = np.random.default_rng(40 + K)
    B, H, W = 2, 8, 128
    x = rng.standard_normal((B, C, H, W)).astype(np.float32)
    w = (rng.standard_normal((C, K)) * C ** -0.5).astype(np.float32)
    b = (rng.standard_normal(K) * 0.1).astype(np.float32)
    s = (rng.standard_normal((B, C)) * 0.2 + 1.0).astype(np.float32)
    t = (rng.standard_normal((B, C)) * 0.3).astype(np.float32)
    want = jax_seg(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
                   (jnp.asarray(s), jnp.asarray(t)), interpret=True)
    wt = torch.from_numpy(w.T.copy())[:, :, None, None]  # the port's (K, C, 1, 1)
    xt, pro = torch.from_numpy(x).to(torch.bfloat16), (torch.from_numpy(s), torch.from_numpy(t))
    got = _reading(xt, t_tail.pack_seg_weight(wt), torch.from_numpy(b), pro)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    # and the plain version the CPU path runs gives the same logits
    torch.testing.assert_close(t_tail.seg_head_cm(xt, wt, torch.from_numpy(b), pro), got,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(3, 32, 1, 1), (14, 64), (32, 512, 1, 1)])
def test_pack_seg_weight_layout(shape):
    """(C, K) fp32, contiguous, bit-equal to w's bf16 rounding transposed."""
    w = torch.randn(shape, generator=torch.Generator().manual_seed(shape[0]))
    K, C = shape[0], shape[1]
    wk = t_tail.pack_seg_weight(w)
    assert wk.dtype == torch.float32 and wk.shape == (C, K) and wk.is_contiguous()
    assert torch.equal(wk, w.reshape(K, C).t().to(torch.bfloat16).float())
    assert not wk.requires_grad


def test_packed_seg_weight_is_cached_and_remade_on_update():
    w = torch.nn.Parameter(torch.randn((3, 32, 1, 1)))
    first = t_tail.packed_seg_weight(w)
    assert t_tail.packed_seg_weight(w) is first
    assert not first.requires_grad
    with torch.no_grad():
        w.copy_(torch.randn((3, 32, 1, 1)))  # in place: the version counter moves
    second = t_tail.packed_seg_weight(w)
    assert second is not first
    assert torch.equal(second, t_tail.pack_seg_weight(w))
    assert t_tail.packed_seg_weight(w) is second
    w.data = torch.randn((3, 32, 1, 1))  # new storage
    assert torch.equal(t_tail.packed_seg_weight(w), t_tail.pack_seg_weight(w))


def test_seg_reading_after_weight_update():
    """The op from the cached weight follows an in-place update of it."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn((1, 16, 3, 8), generator=g).to(torch.bfloat16)
    w = torch.nn.Parameter(torch.randn((5, 16, 1, 1), generator=g) * 0.25)
    b = torch.randn(5, generator=g) * 0.1
    pro = (torch.rand((1, 16), generator=g) + 0.5, torch.randn((1, 16), generator=g) * 0.3)
    before = _reading(x, t_tail.packed_seg_weight(w), b, pro)
    with torch.no_grad():
        w.copy_(torch.randn((5, 16, 1, 1), generator=g) * 0.25)
    after = _reading(x, t_tail.packed_seg_weight(w), b, pro)
    assert not torch.equal(before, after)
    torch.testing.assert_close(after, t_tail.seg_head_cm_plain(x, w.detach(), b, pro),
                               atol=1e-5, rtol=1e-5)
