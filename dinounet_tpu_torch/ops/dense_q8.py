"""w8a8 dense ops of the int8 serving mode (``DINOUNET_TPU_VIT_INT8``).

Counterparts of ``dinounet_tpu/ops/dense_q8_pallas.py``, with its
quantization scheme: per-output-channel symmetric int8 weights
(``quantize_weight``: scale max|w| / 127 over K), per-token symmetric int8
activations (scale max|x| / 127 over the K channels of a token), an exact
int32 product, and the fp32 rescale ``(acc * a) * ws + b`` rounded once to
the compute dtype:

- ``dense_q8``: h (B, N, K) -> act(h) @ w + b, (B, N, D) (ViT fc1);
- ``dense_q8_residual_stats``: h (B, N, K) -> out = res + gamma * (...) and
  the next LayerNorm's row statistics (ViT fc2 and ConvFFN fc2, with the
  exact-erf GELU prologue);
- ``dense_cm_q8_residual_stats``: the same from a channel-major h_t
  (B, K, N) (the attention and MSDA output projections);
- ``qkv_q8_dmaj``: x (B, N, C) -> the Dh-major (B, 3, M, Dh, N) qkv that
  ``ops/attention.py`` reads;
- ``qkv_q8_premapped``: the same into the (B, 3, M, N, Dh) layout of
  ``DINOUNET_TPU_ATTN_LAYOUT=ndh``, an XLA einsum in the JAX package too, so
  plain PyTorch here like ``quant_dense``;
- ``quant_dense``: the unfused linear of the SwiGLU backbone (the JAX
  ``QuantDense``), whose int8 product is a plain matrix product in the JAX
  package too (XLA's ``dot_general``): ``torch._int_mm`` on a CUDA device,
  no kernel of the port and no launch count.

w is (K, D) as in the JAX package (a float parameter, usually a Linear
weight's transposed view), b and gamma (D,). The JAX package quantizes the
weight on every call; the backbone is frozen, so here the int8 levels and
scales are computed once and kept on the weight tensor
(``quantized_weight``): (D, Kpad) int8 with K contiguous, the layout
nn.Linear stores and the kernels and ``torch._int_mm`` read, with the same
levels as ``quantize_weight``. An in-place update of the weight makes the
next call quantize it again. For CUDA tensors the first three ops launch
``csrc/dense_q8.cu`` and the qkv ``csrc/qkv_q8_dmaj.cu`` (which replace the
TPU kernels ``_q8_kernel``, ``_q8_stats_kernel``, ``_cm_q8_kernel`` and
``_qkv_q8_dmaj_kernel``; their headers say what bounds them): each call a
quantize pass, then ``csrc/int8_gemm.cuh``'s one s8 ``wgmma`` GEMM with the
op's epilogue; for CPU
tensors they run the plain versions below, which quantize the float weight
themselves and round where the JAX package's ``_reference_q8``,
``_reference_q8_stats``, ``_reference_cm_q8_stats`` and
``qkv_q8_premapped_dmaj`` round: the GELU prologue to the compute dtype
before quantization, true divisions, round-half-to-even, the int32 sums
exact (taken in float64, exact below 2^53; fp32 is not, K * 127^2 reaches
4.9e7 > 2^24), the bias added in fp32 before the one rounding. Every op is
differentiable on every device: the backward differentiates the plain
version recomputed from the saved float inputs, as the JAX custom VJPs do
(zero through the rounding, exact through the scales).

The row-parallel mode, for a backbone block split over a model axis
(``models/vit.py``): a rank holds K/n input columns of fc2 / the attention
projection / a SwiGLU w3 (or a 7B attention projection), so both scales of
the whole product are reductions across the ranks, as GSPMD computes them in
the JAX package: the activation's max|x| over the whole K of each token and
the weight's max|w| over the whole K of each column. Everything else is
exact: the int32 partial products summed over the ranks equal the whole
product in any order, so the split result equals the whole one bit for bit.
``act_amax`` (the quantize pass's first mode) writes the rank's per-token
maxima for the caller's MAX all-reduce; ``dense_q8_partial`` (#11's mode,
with the GELU prologue) and ``dense_cm_q8_partial`` (#12's, channel-major)
quantize at the scales of the all-reduced maxima (the second mode) and store
the rank's int32 product (``int8_gemm.cuh``'s ``kPartial`` epilogue) and
nothing else; after the caller's int32 all-reduce,
``post_reduce_q8_residual_stats`` (``dense_q8.cu``'s
``post_reduce_q8_stats_kernel``) rescales with the global scales and runs
#11's / #12's epilogue once. ``quantized_weight(w, group=...)`` takes the
weight's column maxima over the model group when it fills its cache, and
``quant_dense(..., group=...)`` is the SwiGLU blocks' row-parallel
``QuantDense``. These ops serve the frozen backbone under ``no_grad`` and
carry no gradient.
"""

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dinounet_tpu_torch.ops import _build
from dinounet_tpu_torch.ops.dense_stats import grads_of_plain, row_stats

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
PROLOGUES = ("none", "gelu")


def _quantize(xf: torch.Tensor, dim: int,
              amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 levels of `xf` along `dim`, kept as float in xf's
    dtype (the rounding has a zero gradient, the scale an exact one):
    (q, scale), scale max(amax, 1e-12) / 127 with `dim` kept, amax the given
    maximum (the whole row's, all-reduced) or max|xf| along `dim`. The 127 is
    a tensor on xf's device: PyTorch's CUDA division by a CPU scalar
    multiplies by its reciprocal, which is not the IEEE quotient."""
    if amax is None:
        amax = xf.abs().amax(dim=dim, keepdim=True)
    amax = torch.clamp(amax, min=1e-12)
    scale = amax / amax.new_full((), 127.0)
    return torch.clamp(torch.round(xf / scale), -127, 127), scale


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """t's elementwise maximum over the ranks of `group`, in t's dtype (sent
    as fp32: exact for bf16 and fp32 values)."""
    m = t.float() if t.dtype != torch.float32 else t.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    return m.to(t.dtype)


def quantize_weight(w: torch.Tensor,
                    amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, D) float kernel -> (wq int8 (K, D), w_scale (D,)), per output
    channel, in w's dtype as the JAX package computes it (fp32 for the
    model's parameters): at the scales of its own column maxima, or of the
    given ones (1, D) (a row-parallel shard's, taken over its model group)."""
    q, scale = _quantize(w, 0, amax)
    return q.to(torch.int8), scale[0]


def quantize_act_cm(h_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel-major (B, K, N) activation -> (xq int8 (B, K, N), a_col fp32
    (B, N, 1)), one scale per token."""
    q, a = _quantize(h_t.float(), 1)
    return q.to(torch.int8), a.transpose(1, 2)


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def quantize_weight_dk(w: torch.Tensor, dtype: Optional[torch.dtype] = None,
                       amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, D) float weight -> (wq int8 (D, Kpad), ws fp32 (D,)): the levels
    of ``quantize_weight(w, amax)`` (computed in `dtype`, default w's)
    transposed to K-contiguous rows and padded with zero columns to Kpad = K
    rounded up to 16. Built outside inference mode and autograd, so the
    tensors serve calls inside and outside both."""
    with torch.inference_mode(False), torch.no_grad():
        q, scale = quantize_weight(w if dtype is None else w.to(dtype), amax)
        K, D = q.shape
        wq = q.new_zeros((D, _pad16(K)))
        wq[:, :K] = q.t()
        return wq, scale.float()


CACHE_ATTR = "_dinounet_q8_weight"


def quantized_weight(w: torch.Tensor, dtype: Optional[torch.dtype] = None,
                     group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_weight_dk(w, dtype)``, computed once and kept on the
    tensor that owns w's storage (``w._base`` for a view such as a Linear
    weight's ``.t()``, else w). The entry is tied to that tensor's version
    counter, data pointer, dtype and device and to w's shape, strides and
    offset, so an in-place update (``copy_``, ``fill_``, ``load_state_dict``)
    or a new ``.data`` quantizes again. An inference tensor keeps no version
    counter, so its weight is quantized on every call.

    With `group` (w a rank's K rows of a row-parallel weight) the levels are
    at the column maxima over the model group, a MAX all-reduce in the fill,
    so every rank of it must fill at the same call. They do: the ranks run the same forward, and
    their shards change together (an update or a load reaches every rank).
    The split backbone's weights are parameters built outside inference
    mode, so the fill, and its collective, happen once; an inference-tensor
    shard would reduce on every call, correct but costly."""
    def make():
        amax = None
        if group is not None:
            with torch.inference_mode(False), torch.no_grad():
                wd = w if dtype is None else w.to(dtype)
                amax = all_reduce_max(wd.abs().amax(dim=0, keepdim=True), group)
        return quantize_weight_dk(w, dtype, amax)

    return _build.cached_on_storage(w, CACHE_ATTR, make, dtype, group)


def _tokens_shape(h: torch.Tensor, channel_major: bool, prologue: str, op: str):
    """(B, N, K) of a row-major (B, N, K) or channel-major (B, K, N) h."""
    if prologue not in PROLOGUES:
        raise ValueError(f"prologue must be one of {PROLOGUES}, got {prologue!r}")
    if channel_major and prologue != "none":
        raise ValueError(f"{op}: the channel-major pass has no prologue")
    if channel_major:
        B, K, N = h.shape
    else:
        B, N, K = h.shape
    return B, N, K


def _act_rows(h: torch.Tensor, channel_major: bool, prologue: str) -> torch.Tensor:
    """act(h) token-major (B, N, K) in fp32, rounded as the kernels round."""
    return _prologue(prologue, h.transpose(1, 2) if channel_major else h)


def quantize_act_tokens_plain(h: torch.Tensor, channel_major: bool = False,
                              prologue: str = "none", amax: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_act_tokens``'s plain version, on h's device."""
    B, N, K = _tokens_shape(h, channel_major, prologue, "quantize_act_tokens")
    given = None if amax is None else amax.reshape(B, N, 1)
    q, a = _quantize(_act_rows(h, channel_major, prologue), -1, given)
    xq = torch.zeros((B * N, _pad16(K)), dtype=torch.int8, device=h.device)
    xq[:, :K] = q.reshape(B * N, K)
    return xq, a.reshape(B * N)


def act_amax_plain(h: torch.Tensor, channel_major: bool = False,
                   prologue: str = "none") -> torch.Tensor:
    """``act_amax``'s plain version, on h's device."""
    B, N, _ = _tokens_shape(h, channel_major, prologue, "act_amax")
    return _act_rows(h, channel_major, prologue).abs().amax(dim=-1).reshape(B * N)


def quantize_act_tokens(h: torch.Tensor, channel_major: bool = False,
                        prologue: str = "none",
                        amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' quantize pass: h (B, N, K) through `prologue`, or a
    channel-major (B, K, N) -> (xq int8 (B N, Kpad), a fp32 (B N,)), the
    per-token levels token-major with K padded with zeros to a multiple of
    16, at the scale of each token's own maximum, or with `amax` (B N,) fp32
    of that given maximum (the row-parallel mode's second pass). The plain
    version for a CPU tensor, the pass of ``csrc/dense_q8.cu`` for a CUDA
    one."""
    B, N, K = _tokens_shape(h, channel_major, prologue, "quantize_act_tokens")
    if _on_cpu(h, "quantize_act_tokens"):
        return quantize_act_tokens_plain(h, channel_major, prologue, amax)
    specs = dict(h=(h, torch.bfloat16, h.shape))
    if amax is not None:
        specs["amax"] = (amax, torch.float32, (B * N,))
    _build.check_inputs("quantize_act_tokens", h.device, **specs)
    xq = torch.empty((B * N, _pad16(K)), dtype=torch.int8, device=h.device)
    a = torch.empty((B * N,), dtype=torch.float32, device=h.device)
    err = _build.lib().quantize_act(h.data_ptr(), None if amax is None else amax.data_ptr(),
                                    xq.data_ptr(), a.data_ptr(), B, N, K,
                                    int(channel_major), int(prologue == "gelu"),
                                    _build.stream_of(h.device))
    _build.check(err, "quantize_act_tokens")
    return xq, a


def act_amax(h: torch.Tensor, channel_major: bool = False,
             prologue: str = "none") -> torch.Tensor:
    """The row-parallel mode's first pass: each token's max|act(h)| over the
    K channels h holds (a rank's), (B N,) fp32, act rounded as the one pass
    rounds it. A CUDA tensor launches the quantize pass's kAmaxOnly mode
    (``csrc/dense_q8.cu``'s ``quantize_amax``)."""
    B, N, K = _tokens_shape(h, channel_major, prologue, "act_amax")
    if _on_cpu(h, "act_amax"):
        return act_amax_plain(h, channel_major, prologue)
    _build.check_inputs("act_amax", h.device, h=(h, torch.bfloat16, h.shape))
    amax = torch.empty((B * N,), dtype=torch.float32, device=h.device)
    err = _build.lib().quantize_amax(h.data_ptr(), amax.data_ptr(), B, N, K,
                                     int(channel_major), int(prologue == "gelu"),
                                     _build.stream_of(h.device))
    _build.check(err, "act_amax")
    act_amax.launches += 1
    return amax


def _exact_matmul(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The int32 product of two integer-valued float tensors, exact, as fp32
    (one rounding, as JAX's int32 -> fp32 convert)."""
    return torch.einsum(equation, a.double(), b.double()).float()


def _prologue(prologue: str, h: torch.Tensor) -> torch.Tensor:
    if prologue not in PROLOGUES:
        raise ValueError(f"prologue must be one of {PROLOGUES}, got {prologue!r}")
    hf = h.float()
    if prologue == "gelu":
        hf = F.gelu(hf).to(h.dtype).float()
    return hf


def _rescaled(h, w, b, prologue) -> torch.Tensor:
    """(acc * a) * ws + b in fp32, (B, N, D), from row-major h."""
    wq, ws = _quantize(w, 0)
    q, a = _quantize(_prologue(prologue, h), -1)
    return _exact_matmul("bnk,kd->bnd", q, wq) * a * ws + b.float()


def _residual_stats(y, res, gamma) -> Stats:
    out = res + y.to(res.dtype) * gamma.to(res.dtype)
    mu, var = row_stats(out)
    return out, mu, var


def dense_q8_plain(h, w, b, prologue: str = "none") -> torch.Tensor:
    return _rescaled(h, w, b, prologue).to(h.dtype)


def dense_q8_residual_stats_plain(h, w, b, res, gamma, prologue: str = "none") -> Stats:
    return _residual_stats(_rescaled(h, w, b, prologue), res, gamma)


def dense_cm_q8_residual_stats_plain(h_t, w, b, res, gamma) -> Stats:
    wq, ws = _quantize(w, 0)
    q, a = _quantize(h_t.float(), 1)  # a (B, 1, N)
    y = _exact_matmul("bkn,kd->bnd", q, wq) * a.transpose(1, 2) * ws + b.float()
    return _residual_stats(y, res, gamma)


def qkv_q8_dmaj_plain(x, w, b: Optional[torch.Tensor], n_heads: int,
                      head_dim: int) -> torch.Tensor:
    B, N, C = x.shape
    M, Dh = n_heads, head_dim
    wq, ws = _quantize(w, 0)  # (C, 3C), (1, 3C)
    q, a = _quantize(x.float(), -1)  # (B, N, C), (B, N, 1)
    acc = _exact_matmul("bnc,cj->bjn", q, wq)  # (B, 3C, N)
    y = acc * a.transpose(1, 2) * ws.reshape(1, 3 * M * Dh, 1)
    if b is not None:
        y = y + b.float().reshape(1, 3 * M * Dh, 1)
    return y.to(x.dtype).reshape(B, 3, M, Dh, N)


def _int8_product(rows: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(n, K) integer-valued rows times the cached (D, Kpad) int8 weight's
    transpose, exact, as int32 (n, D): ``torch._int_mm`` on a CUDA device
    (on the weight's K-contiguous rows, as cuBLAS takes them), an exact
    float64 product elsewhere."""
    w = wq[:, :rows.shape[1]]
    if rows.device.type == "cuda":
        return torch._int_mm(rows.to(torch.int8), w.t())
    return _exact_int_product(rows, w)


def _exact_int_product(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n, K) times (D, K)^T of integer values, exact, as int32: a float64
    product (exact below 2^53) on any device."""
    return torch.einsum("nk,dk->nd", rows.double(), w.double()).to(torch.int32)


def qkv_q8_premapped(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                     n_heads: int, head_dim: int) -> torch.Tensor:
    """``dense_q8_pallas.qkv_q8_premapped``: x (B, N, C), w (C, 3C), b (3C,)
    or None -> the (B, 3, M, N, Dh) qkv in x's dtype, ``(acc * a) * ws + b``
    in fp32 and one rounding. Not differentiable (the backbone is frozen)."""
    B, N, C = x.shape
    M, Dh = n_heads, head_dim
    if w.shape[1] != 3 * M * Dh:
        raise ValueError(f"qkv_q8_premapped: w {tuple(w.shape)} is not (C, 3 * "
                         f"{M} * {Dh})")
    wq, ws = quantized_weight(w)  # (3C, Cpad), (3C,)
    q, a = _quantize(x.float(), -1)  # (B, N, C), (B, N, 1)
    acc = _int8_product(q.reshape(-1, C), wq).float().view(B, N, 3, M, Dh)
    y = acc * a.view(B, N, 1, 1, 1) * ws.view(3, M, Dh)
    if b is not None:
        y = y + b.float().view(3, M, Dh)
    return y.to(x.dtype).permute(0, 2, 3, 1, 4).contiguous()


def quant_dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                dtype: torch.dtype, group=None) -> torch.Tensor:
    """``QuantDense`` (``dinounet_tpu/models/vit.py:186-216``): x (..., K) ->
    (..., D) in `dtype`, with weight (D, K) in the torch layout (quantized
    per output channel from its fp32 values, once: ``quantized_weight``) and
    bias (D,) or None. The int32 product is ``torch._int_mm`` on a CUDA
    device and an exact float64 product elsewhere; then ``(acc * a) * ws +
    b`` in fp32 and one rounding to `dtype`.

    With `group`, the row-parallel form: x and weight hold a rank's K
    columns of a model axis; the activation's per-token maximum and the
    weight's column maxima are MAX all-reduces over the group, the rank's
    int32 product is summed over it (exact), and the rescale and bias follow
    once, so the result equals the whole layer's bit for bit."""
    K, D = x.shape[-1], weight.shape[0]
    wq, ws = quantized_weight(weight.t(), torch.float32, group)  # (D, Kpad), (D,)
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if group is not None:
        amax = all_reduce_max(amax, group)
    q, a = _quantize(xf, -1, amax)  # (..., K), (..., 1)
    acc = _int8_product(q.reshape(-1, K), wq)
    if group is not None:
        dist.all_reduce(acc, group=group)
    y = acc.float().reshape(*x.shape[:-1], D) * a * ws
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def dense_q8_partial_plain(h, wq, amax, prologue: str = "none",
                           channel_major: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row-parallel mode's plain version: act(h)'s levels at the scales
    of the given maxima, then the exact int32 product with the cached levels
    wq (D, Kpad) -> (acc int32 (B, N, D), a fp32 (B N,))."""
    B, N, K = _tokens_shape(h, channel_major, prologue, "dense_q8_partial")
    xq, a = quantize_act_tokens_plain(h, channel_major, prologue, amax)
    return _exact_int_product(xq[:, :K], wq[:, :K]).view(B, N, -1), a


def post_reduce_q8_residual_stats_plain(acc, a, ws, b, res, gamma) -> Stats:
    """#11's / #12's epilogue on the summed int32 product acc (B, N, D):
    ``(acc * a) * ws + b`` in fp32, then out = res + y * gamma rounded as
    ``dense_q8_residual_stats_plain`` rounds, and out's row statistics."""
    B, N, _ = acc.shape
    y = acc.float() * a.float().reshape(B, N, 1) * ws.float() + b.float()
    return _residual_stats(y, res, gamma)


# ----------------------------------------------------------------- kernels

def _cached_weight(w, K, op):
    """The (K, D) weight's cached (wq (D, Kpad), ws (D,))."""
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"{op}: w must be ({K}, D), got {tuple(w.shape)}")
    return quantized_weight(w)


def _launch_dense(h, w, b, res, gamma, channel_major: bool, prologue: str,
                  op: str):
    """The dense_q8.cu launches (the quantize pass, then the GEMM): res /
    gamma None for the plain epilogue (fc1), else the residual + statistics
    one."""
    if prologue not in PROLOGUES:
        raise ValueError(f"prologue must be one of {PROLOGUES}, got {prologue!r}")
    if channel_major:
        B, K, N = h.shape
    else:
        B, N, K = h.shape
    D = w.shape[1]
    dev = h.device
    bf16, f32 = torch.bfloat16, torch.float32
    wq, ws = _cached_weight(w, K, op)
    b = b.to(f32).contiguous()
    specs = dict(h=(h, bf16, h.shape), wq=(wq, torch.int8, (D, _pad16(K))),
                 ws=(ws, f32, (D,)), b=(b, f32, (D,)))
    residual = res is not None
    if residual:
        gamma = gamma.to(f32).contiguous()
        specs.update(res=(res, bf16, (B, N, D)), gamma=(gamma, f32, (D,)))
    _build.check_inputs(op, dev, **specs)
    # the quantize pass's token-major int8 activations and per-token scales
    xq = torch.empty((B * N, _pad16(K)), dtype=torch.int8, device=dev)
    a = torch.empty((B * N,), dtype=f32, device=dev)
    out = torch.empty((B, N, D), dtype=bf16, device=dev)
    mu = var = None
    if residual:
        mu = torch.empty((B, N), dtype=f32, device=dev)
        var = torch.empty((B, N), dtype=f32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _build.lib().dense_q8(
        h.data_ptr(), wq.data_ptr(), ws.data_ptr(), b.data_ptr(), ptr(res),
        ptr(gamma), xq.data_ptr(), a.data_ptr(), out.data_ptr(), ptr(mu), ptr(var),
        B, N, K, D, int(channel_major), int(prologue == "gelu"), int(residual),
        _build.stream_of(dev))
    _build.check(err, op)
    return (out, mu, var) if residual else out


def _launch_qkv(x, w, b, n_heads, head_dim):
    op = "qkv_q8_dmaj"
    B, N, C = x.shape
    D3 = 3 * n_heads * head_dim
    dev = x.device
    f32 = torch.float32
    wq, ws = _cached_weight(w, C, op)
    b = (torch.zeros((D3,), dtype=f32, device=dev) if b is None
         else b.to(f32).contiguous())
    _build.check_inputs(op, dev, x=(x, torch.bfloat16, (B, N, C)),
                        wq=(wq, torch.int8, (D3, _pad16(C))), ws=(ws, f32, (D3,)),
                        b=(b, f32, (D3,)))
    # the quantize pass's token-major int8 activations and per-token scales,
    # as _launch_dense's
    xq = torch.empty((B * N, _pad16(C)), dtype=torch.int8, device=dev)
    a = torch.empty((B * N,), dtype=f32, device=dev)
    out = torch.empty((B, D3, N), dtype=torch.bfloat16, device=dev)
    err = _build.lib().qkv_q8_dmaj(
        x.data_ptr(), wq.data_ptr(), ws.data_ptr(), b.data_ptr(), xq.data_ptr(),
        a.data_ptr(), out.data_ptr(), B, N, C, D3, _build.stream_of(dev))
    _build.check(err, op)
    return out.reshape(B, 3, n_heads, head_dim, N)


def _partial(h, wq, amax, channel_major: bool, prologue: str, wrapper):
    B, N, K = _tokens_shape(h, channel_major, prologue, wrapper.__name__)
    if wq.dim() != 2 or wq.shape[1] != _pad16(K):
        raise ValueError(f"{wrapper.__name__}: wq must be (D, {_pad16(K)}), got "
                         f"{tuple(wq.shape)}")
    if _on_cpu(h, wrapper.__name__):
        return dense_q8_partial_plain(h, wq, amax, prologue, channel_major)
    D, dev = wq.shape[0], h.device
    _build.check_inputs(wrapper.__name__, dev, h=(h, torch.bfloat16, h.shape),
                        wq=(wq, torch.int8, (D, _pad16(K))),
                        amax=(amax, torch.float32, (B * N,)))
    # the second quantize pass's token-major levels and scales, then the product
    xq = torch.empty((B * N, _pad16(K)), dtype=torch.int8, device=dev)
    a = torch.empty((B * N,), dtype=torch.float32, device=dev)
    acc = torch.empty((B, N, D), dtype=torch.int32, device=dev)
    err = _build.lib().dense_q8_partial(
        h.data_ptr(), wq.data_ptr(), amax.data_ptr(), xq.data_ptr(), a.data_ptr(),
        acc.data_ptr(), B, N, K, D, int(channel_major), int(prologue == "gelu"),
        _build.stream_of(dev))
    _build.check(err, wrapper.__name__)
    wrapper.launches += 1
    return acc, a


def dense_q8_partial(h, wq, amax, prologue: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """#11's row-parallel mode: a rank's h (B, N, K/n) through `prologue`,
    quantized at the scales of the all-reduced per-token maxima amax (B N,),
    times the rank's cached weight levels wq (D, Kpad) -> (acc int32
    (B, N, D), a fp32 (B N,))."""
    return _partial(h, wq, amax, False, prologue, dense_q8_partial)


def dense_cm_q8_partial(h_t, wq, amax) -> Tuple[torch.Tensor, torch.Tensor]:
    """#12's row-parallel mode: the same from a channel-major h_t
    (B, K/n, N)."""
    return _partial(h_t, wq, amax, True, "none", dense_cm_q8_partial)


def post_reduce_q8_residual_stats(acc, a, ws, b, res, gamma) -> Stats:
    """The int8 row-parallel mode's epilogue on the summed acc (B, N, D)
    int32, the per-token scales a (B N,) and the weight's global scales ws
    (D,): (out (B, N, D), mean (B, N), var (B, N)), equal to the whole
    ``dense_q8_residual_stats`` / ``dense_cm_q8_residual_stats`` on the
    same product."""
    op = "post_reduce_q8_residual_stats"
    if _on_cpu(acc, op):
        return post_reduce_q8_residual_stats_plain(acc, a, ws, b, res, gamma)
    B, N, D = acc.shape
    dev = acc.device
    f32 = torch.float32
    b, gamma = b.to(f32).contiguous(), gamma.to(f32).contiguous()
    _build.check_inputs(op, dev, acc=(acc, torch.int32, (B, N, D)), a=(a, f32, (B * N,)),
                        ws=(ws, f32, (D,)), b=(b, f32, (D,)),
                        res=(res, torch.bfloat16, (B, N, D)), gamma=(gamma, f32, (D,)))
    out = torch.empty((B, N, D), dtype=torch.bfloat16, device=dev)
    mu = torch.empty((B, N), dtype=f32, device=dev)
    var = torch.empty((B, N), dtype=f32, device=dev)
    err = _build.lib().post_reduce_q8_stats(
        acc.data_ptr(), a.data_ptr(), ws.data_ptr(), b.data_ptr(), res.data_ptr(),
        gamma.data_ptr(), out.data_ptr(), mu.data_ptr(), var.data_ptr(), B * N, D,
        _build.stream_of(dev))
    _build.check(err, op)
    post_reduce_q8_residual_stats.launches += 1
    return out, mu, var


def _on_cpu(t: torch.Tensor, op: str) -> bool:
    """True for a CPU tensor (the plain version), False for a CUDA one (the
    kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no {op} kernel for device {t.device}")
    return False


class _DenseQ8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, b, prologue):
        ctx.prologue = prologue
        ctx.save_for_backward(h, w, b)
        if _on_cpu(h, "dense_q8"):
            return dense_q8_plain(h, w, b, prologue)
        out = _launch_dense(h, w, b, None, None, False, prologue, "dense_q8")
        dense_q8.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        plain = lambda h, w, b: dense_q8_plain(h, w, b, ctx.prologue)
        return grads_of_plain(ctx, plain, g, 3) + (None,)


class _DenseQ8Stats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, b, res, gamma, prologue):
        ctx.prologue = prologue
        ctx.save_for_backward(h, w, b, res, gamma)
        if _on_cpu(h, "dense_q8_residual_stats"):
            return dense_q8_residual_stats_plain(h, w, b, res, gamma, prologue)
        out = _launch_dense(h, w, b, res, gamma, False, prologue,
                            "dense_q8_residual_stats")
        dense_q8_residual_stats.launches += 1
        return out

    @staticmethod
    def backward(ctx, *grads):
        plain = lambda *a: dense_q8_residual_stats_plain(*a, ctx.prologue)
        return grads_of_plain(ctx, plain, grads, 5) + (None,)


class _DenseCmQ8Stats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h_t, w, b, res, gamma):
        ctx.save_for_backward(h_t, w, b, res, gamma)
        if _on_cpu(h_t, "dense_cm_q8_residual_stats"):
            return dense_cm_q8_residual_stats_plain(h_t, w, b, res, gamma)
        out = _launch_dense(h_t, w, b, res, gamma, True, "none",
                            "dense_cm_q8_residual_stats")
        dense_cm_q8_residual_stats.launches += 1
        return out

    @staticmethod
    def backward(ctx, *grads):
        return grads_of_plain(ctx, dense_cm_q8_residual_stats_plain, grads, 5)


class _QkvQ8Dmaj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, n_heads, head_dim):
        ctx.shape = (n_heads, head_dim)
        ctx.save_for_backward(x, w, b)
        if _on_cpu(x, "qkv_q8_dmaj"):
            return qkv_q8_dmaj_plain(x, w, b, n_heads, head_dim)
        out = _launch_qkv(x, w, b, n_heads, head_dim)
        qkv_q8_dmaj.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        plain = lambda x, w, b: qkv_q8_dmaj_plain(x, w, b, *ctx.shape)
        return grads_of_plain(ctx, plain, g, 3) + (None, None)


def dense_q8(h, w, b, prologue: str = "none") -> torch.Tensor:
    """h (B, N, K) -> (B, N, D) in h's dtype."""
    return _DenseQ8.apply(h, w, b, prologue)


def dense_q8_residual_stats(h, w, b, res, gamma, prologue: str = "none") -> Stats:
    """h (B, N, K) -> (out (B, N, D), mean (B, N), var (B, N))."""
    return _DenseQ8Stats.apply(h, w, b, res, gamma, prologue)


def dense_cm_q8_residual_stats(h_t, w, b, res, gamma) -> Stats:
    """h_t (B, K, N) -> (out (B, N, D), mean (B, N), var (B, N))."""
    return _DenseCmQ8Stats.apply(h_t, w, b, res, gamma)


def qkv_q8_dmaj(x, w, b: Optional[torch.Tensor], n_heads: int,
                head_dim: int) -> torch.Tensor:
    """x (B, N, C), w (C, 3C), b (3C,) or None -> (B, 3, M, Dh, N) in x's
    dtype."""
    if w.shape[1] != 3 * n_heads * head_dim:
        raise ValueError(f"qkv_q8_dmaj: w {tuple(w.shape)} is not (C, 3 * "
                         f"{n_heads} * {head_dim})")
    return _QkvQ8Dmaj.apply(x, w, b, n_heads, head_dim)


dense_q8.launches = 0
dense_q8_residual_stats.launches = 0
dense_cm_q8_residual_stats.launches = 0
qkv_q8_dmaj.launches = 0
act_amax.launches = 0
dense_q8_partial.launches = 0
dense_cm_q8_partial.launches = 0
post_reduce_q8_residual_stats.launches = 0
