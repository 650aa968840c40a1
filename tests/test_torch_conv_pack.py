"""The 3x3 conv's wrapper pieces on the CPU: the two-input form against the
JAX kernel, and the weight's packing into the kernel's B operand and its
cache.

``conv3x3_cm(x, w, b, x2=...)`` concatenates x2 after x along the channels
without building the concatenation; the JAX ``conv3x3_cm`` has no ``x2``, so
it runs on the concatenated map (Pallas interpret mode), at the tolerances of
``test_torch_decoder_tail.py``. ``pack_conv_weight`` lays a
(Cout, Cin, 3, 3) weight out as csrc/conv3x3_stats.cu reads it;
``packed_conv_weight`` keeps the result on the weight's storage owner, tied to
its version counter.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinounet_tpu_torch.ops import decoder_tail as t_tail

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# as tests/test_torch_decoder_tail.py: (atol, rtol) on maps and on the
# statistics' means, by dtype
MAP_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-2)}
MEAN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 1e-3)}


def _unpack(p):
    """The packed (Cin / 8, 9, Cout, 8) weight back to (Cout, Cin, 3, 3)."""
    groups, _, cout, _ = p.shape
    return p.permute(2, 0, 3, 1).reshape(cout, 8 * groups, 3, 3)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_two_input_conv_matches_jax_on_the_concatenation(dtype):
    from dinounet_tpu.ops.decoder_tail_pallas import conv3x3_cm as jax_conv

    rng = np.random.default_rng(21)
    B, C1, C2, H, W, Cout = 2, 16, 16, 16, 128, 16
    jdt, tdt = DTYPES[dtype]
    x = rng.standard_normal((B, C1, H, W)).astype(np.float32)
    x2 = rng.standard_normal((B, C2, H, W)).astype(np.float32)
    k = (rng.standard_normal((3, 3, C1 + C2, Cout)) * (9 * (C1 + C2)) ** -0.5).astype(np.float32)
    b = (rng.standard_normal(Cout) * 0.1).astype(np.float32)
    s = (rng.standard_normal((B, C1 + C2)) * 0.2 + 1.0).astype(np.float32)
    t = (rng.standard_normal((B, C1 + C2)) * 0.3).astype(np.float32)
    want = jax_conv(jnp.asarray(np.concatenate([x, x2], 1), jdt), jnp.asarray(k),
                    jnp.asarray(b), prologue=(jnp.asarray(s), jnp.asarray(t)),
                    interpret=True)
    w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    got = t_tail.conv3x3_cm(torch.from_numpy(x).to(tdt), w, torch.from_numpy(b),
                            (torch.from_numpy(s), torch.from_numpy(t)),
                            x2=torch.from_numpy(x2).to(tdt))
    assert got[0].dtype == tdt and got[0].shape == (B, Cout, H, W)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), atol=MAP_TOL[dtype][0],
                               rtol=MAP_TOL[dtype][1])
    for g, wv in zip(got[1:], want[1:]):
        np.testing.assert_allclose(_np(g) / (H * W), _np(wv) / (H * W),
                                   atol=MEAN_TOL[dtype][0], rtol=MEAN_TOL[dtype][1])


@pytest.mark.parametrize("cout,cin", [(16, 16), (32, 64), (64, 128), (128, 256)])
def test_pack_conv_weight_layout_and_inverse(cout, cin):
    """(Cin / 8, 9, Cout, 8): group g, tap ky * 3 + kx, row co, lane j holds
    w[co, 8 g + j, ky, kx]; unpacking gives the bf16 weight back exactly."""
    w = torch.randn((cout, cin, 3, 3), generator=torch.Generator().manual_seed(cout))
    p = t_tail.pack_conv_weight(w)
    assert p.shape == (cin // 8, 9, cout, 8) and p.dtype == torch.bfloat16
    assert p.is_contiguous()
    wb = w.to(torch.bfloat16)
    for g, tap, co, j in ((0, 0, 0, 0), (cin // 8 - 1, 8, cout - 1, 7), (1, 4, cout // 2, 3)):
        assert p[g, tap, co, j] == wb[co, 8 * g + j, tap // 3, tap % 3]
    assert torch.equal(_unpack(p), wb)


def test_packed_conv_weight_is_cached_and_repacked_on_update():
    w = torch.nn.Parameter(torch.randn((32, 16, 3, 3)))
    first = t_tail.packed_conv_weight(w)
    assert t_tail.packed_conv_weight(w) is first
    with torch.no_grad():
        w.mul_(2.0)  # in place: the version counter moves
    second = t_tail.packed_conv_weight(w)
    assert second is not first
    assert torch.equal(_unpack(second), w.detach().to(torch.bfloat16))
    w.data = torch.randn((32, 16, 3, 3))  # new storage
    assert torch.equal(_unpack(t_tail.packed_conv_weight(w)),
                       w.detach().to(torch.bfloat16))


def test_packed_conv_weight_of_a_view_and_of_an_inference_tensor():
    base = torch.randn((64, 16, 3, 3))
    view = base[32:]  # a view: the entry lives on its base
    p = t_tail.packed_conv_weight(view)
    assert torch.equal(_unpack(p), view.to(torch.bfloat16))
    assert t_tail.packed_conv_weight(base[:32]) is not p  # other geometry, packed again
    with torch.inference_mode():
        inf = torch.randn((16, 16, 3, 3))
    a, b = t_tail.packed_conv_weight(inf), t_tail.packed_conv_weight(inf)
    assert a is not b and torch.equal(a, b)
