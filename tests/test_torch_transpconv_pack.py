"""The k2s2 transposed conv's wrapper pieces on the CPU: the weight's packing
into the kernel's B operand, its reading (the kernel's arithmetic from the
packed weight) against the JAX kernel, and the caches.

``pack_transpconv_weight`` lays a (Cin, Cout, 2, 2) weight out as
csrc/transpconv2x2.cu reads it: (Npad, Cin) bf16, row n = 4 c + 2 p + q.
The packed weight's reading, the plain version run on the weight read back
from the pack's first 4 Cout rows, is held against the JAX
``transpconv2x2_cm`` in Pallas interpret mode at W = 128 and through the JAX
wrapper's XLA branch at W = 32, at ``test_torch_decoder_tail.py``'s bf16 map
tolerance (atol 2e-2, rtol 1e-2: both round the same fp32 sums once, and an
order difference can flip one bf16 ulp). ``packed_transpconv_weight`` keeps
the pack on the weight's storage owner, tied to its version counter.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinounet_tpu_torch.ops import decoder_tail as t_tail

MAP_TOL = (2e-2, 1e-2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _reading(x, packed, b, prologue=None):
    """The op from the packed weight: the plain version on the (Cin, Cout,
    2, 2) weight that the pack's first 4 Cout rows hold."""
    cin, cout = packed.shape[1], b.shape[0]
    w = packed[:4 * cout].t().reshape(cin, cout, 2, 2)
    return t_tail.transpconv2x2_cm_plain(x, w, b, prologue)


def _transp_t(k):
    """flax conv-transpose kernel (2, 2, Ci, Co) -> torch (Ci, Co, 2, 2)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(k)[::-1, ::-1].transpose(2, 3, 0, 1)))


@pytest.mark.parametrize("width", [128, 32])  # 32: the JAX wrapper's XLA branch
@pytest.mark.parametrize("with_prologue", [False, True])
def test_packed_reading_matches_jax(width, with_prologue):
    from dinounet_tpu.ops.decoder_tail_pallas import transpconv2x2_cm as jax_tc

    rng = np.random.default_rng(31)
    B, Cin, H, Cout = 2, 32, 8, 12
    x = rng.standard_normal((B, Cin, H, width)).astype(np.float32)
    k = (rng.standard_normal((2, 2, Cin, Cout)) * Cin ** -0.5).astype(np.float32)
    b = (rng.standard_normal(Cout) * 0.1).astype(np.float32)
    pj = pt = None
    if with_prologue:
        s = (rng.standard_normal((B, Cin)) * 0.2 + 1.0).astype(np.float32)
        t = (rng.standard_normal((B, Cin)) * 0.3).astype(np.float32)
        pj, pt = (jnp.asarray(s), jnp.asarray(t)), (torch.from_numpy(s), torch.from_numpy(t))
    want = jax_tc(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k), jnp.asarray(b),
                  prologue=pj, interpret=True)
    packed = t_tail.pack_transpconv_weight(_transp_t(k))
    got = _reading(torch.from_numpy(x).to(torch.bfloat16), packed, torch.from_numpy(b), pt)
    assert got.dtype == torch.bfloat16 and got.shape == (B, Cout, 2 * H, 2 * width)
    np.testing.assert_allclose(_np(got), _np(want), atol=MAP_TOL[0], rtol=MAP_TOL[1])
    # and the plain version the CPU path runs gives the same bf16 map
    assert torch.equal(got, t_tail.transpconv2x2_cm(
        torch.from_numpy(x).to(torch.bfloat16), _transp_t(k), torch.from_numpy(b), pt))


@pytest.mark.parametrize("cin,cout", [(16, 4), (32, 32), (64, 40), (128, 64), (256, 256)])
def test_pack_transpconv_weight_layout(cin, cout):
    """(Npad, Cin): row 4 c + 2 p + q is w[:, c, p, q] in bf16, rows past
    4 Cout zero, Npad a multiple of the pass width (128 up to Cout 32, else
    256)."""
    w = torch.randn((cin, cout, 2, 2), generator=torch.Generator().manual_seed(cout))
    p = t_tail.pack_transpconv_weight(w)
    nb = t_tail.transpconv_pass_width(cout)
    assert nb == (128 if cout <= 32 else 256)
    assert p.dtype == torch.bfloat16 and p.is_contiguous()
    assert p.shape[1] == cin and p.shape[0] % nb == 0 and 4 * cout <= p.shape[0] < 4 * cout + nb
    wb = w.to(torch.bfloat16)
    for c, pp, q in ((0, 0, 0), (cout - 1, 1, 1), (cout // 2, 1, 0), (cout // 3, 0, 1)):
        assert torch.equal(p[4 * c + 2 * pp + q], wb[:, c, pp, q])
    assert torch.equal(p[:4 * cout].t().reshape(cin, cout, 2, 2), wb)
    assert not p[4 * cout:].any()


def test_packed_transpconv_weight_is_cached_and_repacked_on_update():
    w = torch.nn.Parameter(torch.randn((32, 16, 2, 2)))
    first = t_tail.packed_transpconv_weight(w)
    assert t_tail.packed_transpconv_weight(w) is first
    assert not first.requires_grad
    with torch.no_grad():
        w.mul_(2.0)  # in place: the version counter moves
    second = t_tail.packed_transpconv_weight(w)
    assert second is not first
    assert torch.equal(second, t_tail.pack_transpconv_weight(w))
    w.data = torch.randn((32, 16, 2, 2))  # new storage
    assert torch.equal(t_tail.packed_transpconv_weight(w), t_tail.pack_transpconv_weight(w))


def test_transpconv_reading_after_weight_update():
    """The op from the cached pack follows an in-place update of the weight."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((1, 16, 3, 8), generator=g).to(torch.bfloat16)
    w = torch.nn.Parameter(torch.randn((16, 8, 2, 2), generator=g) * 0.25)
    b = torch.randn(8, generator=g) * 0.1
    before = _reading(x, t_tail.packed_transpconv_weight(w), b)
    with torch.no_grad():
        w.copy_(torch.randn((16, 8, 2, 2), generator=g) * 0.25)
    after = _reading(x, t_tail.packed_transpconv_weight(w), b)
    assert not torch.equal(before, after)
    assert torch.equal(after, t_tail.transpconv2x2_cm_plain(x, w.detach(), b))


def test_bias_f32_is_converted_once():
    b32 = torch.randn(8)
    assert t_tail._bias_f32(b32) is b32  # already what the kernel takes
    b16 = torch.nn.Parameter(torch.randn(8).to(torch.bfloat16))
    first = t_tail._bias_f32(b16)
    assert first.dtype == torch.float32 and torch.equal(first, b16.detach().float())
    assert t_tail._bias_f32(b16) is first
    with torch.no_grad():
        b16.add_(1.0)
    assert torch.equal(t_tail._bias_f32(b16), b16.detach().float())
