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
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dinounet_tpu_torch.ops import _build
from dinounet_tpu_torch.ops.dense_stats import grads_of_plain, row_stats

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
PROLOGUES = ("none", "gelu")


def _quantize(xf: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 levels of `xf` along `dim`, kept as float in xf's
    dtype (the rounding has a zero gradient, the scale an exact one):
    (q, scale), scale max(max|xf|, 1e-12) / 127 with `dim` kept. The 127 is
    a tensor on xf's device: PyTorch's CUDA division by a CPU scalar
    multiplies by its reciprocal, which is not the IEEE quotient."""
    amax = torch.clamp(xf.abs().amax(dim=dim, keepdim=True), min=1e-12)
    scale = amax / amax.new_full((), 127.0)
    return torch.clamp(torch.round(xf / scale), -127, 127), scale


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, D) float kernel -> (wq int8 (K, D), w_scale (D,)), per output
    channel, in w's dtype as the JAX package computes it (fp32 for the
    model's parameters)."""
    q, scale = _quantize(w, 0)
    return q.to(torch.int8), scale[0]


def quantize_act_cm(h_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel-major (B, K, N) activation -> (xq int8 (B, K, N), a_col fp32
    (B, N, 1)), one scale per token."""
    q, a = _quantize(h_t.float(), 1)
    return q.to(torch.int8), a.transpose(1, 2)


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def quantize_weight_dk(w: torch.Tensor,
                       dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, D) float weight -> (wq int8 (D, Kpad), ws fp32 (D,)): the levels
    of ``quantize_weight(w)`` (computed in `dtype`, default w's) transposed
    to K-contiguous rows and padded with zero columns to Kpad = K rounded up
    to 16. Built outside inference mode and autograd, so the tensors serve
    calls inside and outside both."""
    with torch.inference_mode(False), torch.no_grad():
        q, scale = quantize_weight(w if dtype is None else w.to(dtype))
        K, D = q.shape
        wq = q.new_zeros((D, _pad16(K)))
        wq[:, :K] = q.t()
        return wq, scale.float()


CACHE_ATTR = "_dinounet_q8_weight"


def quantized_weight(w: torch.Tensor,
                     dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_weight_dk(w, dtype)``, computed once and kept on the tensor
    that owns w's storage (``w._base`` for a view such as a Linear weight's
    ``.t()``, else w). The entry is tied to that tensor's version counter,
    data pointer, dtype and device and to w's shape, strides and offset, so
    an in-place update (``copy_``, ``fill_``, ``load_state_dict``) or a new
    ``.data`` quantizes again. An inference tensor keeps no version
    counter, so its weight is quantized on every call."""
    base = w if w._base is None else w._base
    if base.is_inference():
        return quantize_weight_dk(w, dtype)
    key = (base._version, base.data_ptr(), base.dtype, base.device, tuple(w.shape),
           w.stride(), w.storage_offset(), dtype)
    entry = getattr(base, CACHE_ATTR, None)
    if entry is None or entry[0] != key:
        entry = (key, *quantize_weight_dk(w, dtype))
        setattr(base, CACHE_ATTR, entry)
    return entry[1], entry[2]


def quantize_act_tokens(h: torch.Tensor, channel_major: bool = False,
                        prologue: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' quantize pass: h (B, N, K) through `prologue`, or a
    channel-major (B, K, N) -> (xq int8 (B N, Kpad), a fp32 (B N,)), the
    per-token levels token-major with K padded with zeros to a multiple of
    16. The plain version for a CPU tensor, the pass of ``csrc/dense_q8.cu``
    for a CUDA one."""
    if channel_major and prologue != "none":
        raise ValueError("quantize_act_tokens: the channel-major pass has no prologue")
    if channel_major:
        B, K, N = h.shape
    else:
        B, N, K = h.shape
    if _on_cpu(h, "quantize_act_tokens"):
        rows = h.transpose(1, 2) if channel_major else h
        q, a = _quantize(_prologue(prologue, rows), -1)
        xq = torch.zeros((B * N, _pad16(K)), dtype=torch.int8)
        xq[:, :K] = q.reshape(B * N, K)
        return xq, a.reshape(B * N)
    _build.check_inputs("quantize_act_tokens", h.device, h=(h, torch.bfloat16, h.shape))
    xq = torch.empty((B * N, _pad16(K)), dtype=torch.int8, device=h.device)
    a = torch.empty((B * N,), dtype=torch.float32, device=h.device)
    err = _build.lib().quantize_act(h.data_ptr(), xq.data_ptr(), a.data_ptr(), B, N, K,
                                    int(channel_major), int(prologue == "gelu"),
                                    _build.stream_of(h.device))
    _build.check(err, "quantize_act_tokens")
    return xq, a


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
    """(n, K) integer-valued float rows times the cached (D, Kpad) int8
    weight's transpose, exact, as fp32: ``torch._int_mm`` on a CUDA device
    (on the weight's K-contiguous rows, as cuBLAS takes them), an exact
    float64 product elsewhere."""
    w = wq[:, :rows.shape[1]]
    if rows.device.type == "cuda":
        return torch._int_mm(rows.to(torch.int8), w.t()).float()
    return _exact_matmul("nk,dk->nd", rows, w.float())


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
    acc = _int8_product(q.reshape(-1, C), wq).view(B, N, 3, M, Dh)
    y = acc * a.view(B, N, 1, 1, 1) * ws.view(3, M, Dh)
    if b is not None:
        y = y + b.float().view(3, M, Dh)
    return y.to(x.dtype).permute(0, 2, 3, 1, 4).contiguous()


def quant_dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
    """``QuantDense`` (``dinounet_tpu/models/vit.py:186-216``): x (..., K) ->
    (..., D) in `dtype`, with weight (D, K) in the torch layout (quantized
    per output channel from its fp32 values, once: ``quantized_weight``) and
    bias (D,) or None. The int32 product is ``torch._int_mm`` on a CUDA
    device and an exact float64 product elsewhere; then ``(acc * a) * ws +
    b`` in fp32 and one rounding to `dtype`."""
    K, D = x.shape[-1], weight.shape[0]
    wq, ws = quantized_weight(weight.t(), torch.float32)  # (D, Kpad), (D,)
    q, a = _quantize(x.float(), -1)  # (..., K), (..., 1)
    acc = _int8_product(q.reshape(-1, K), wq)
    y = acc.reshape(*x.shape[:-1], D) * a * ws
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


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
