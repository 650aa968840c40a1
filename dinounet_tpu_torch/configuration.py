"""Global settings of the port.

The default number of host workers and the resampling's anisotropy
threshold (as in ``dinounet_tpu/configuration.py:9-14``), the compute dtype of the model,
the device-memory budget of the sliding-window accumulators, the three
inference-only conv routes, the three MSDA and attention routes and the
int8 serving mode. The JAX
package's other switches that only choose between TPU formulations of the
same math have no counterpart here (``DINOUNET_TPU_INT8_QKV_IMPL``, for
one, picks between two TPU formulations of the int8 qkv that give the same
numbers).

The routes read the JAX package's environment variables, at call time, with
its value logic (``dinounet_tpu/configuration.py:271-292,355-368,426-448``):
"jax" (the default) keeps the stock modules; "pallas" and "interpret" take
the route on any device, where an op on a CPU tensor runs its plain version
and one on a CUDA tensor launches its kernel; "auto" takes it only for CUDA
tensors, as the JAX package's "auto" takes it only on a TPU. A module in
train mode never takes a route.

Three more routes choose among formulations whose TPU kernels the port has
each ported, and apply in train mode too, as the JAX package consults them
on its premapped path in training as well
(``dinounet_tpu/configuration.py:49-62,87-109,204-221``):
``DINOUNET_TPU_MSDA_PREP=xla`` does the MSDA prep (fp32 offsets plus the
base grid, the point softmax) in PyTorch and samples with the prepped-input
kernel; ``DINOUNET_TPU_MSDA_MERGED_PROJ=1`` (with the fused prep) emits the
offsets and logits from one merged projection into one packed buffer;
``DINOUNET_TPU_ATTN_LAYOUT=ndh`` runs the stats-threaded ViT's attention
over the (B, 3, M, N, Dh) qkv layout.

The int8 serving mode reads the JAX package's variables, at call time, with
its value logic (``dinounet_tpu/configuration.py:112-156``), and is off by
default: ``DINOUNET_TPU_VIT_INT8=1`` runs the frozen backbone's four
projections as w8a8 ops (``ops/dense_q8.py``), ``DINOUNET_TPU_INT8_QKV=0``
keeps its qkv projection bf16, and ``DINOUNET_TPU_INT8_ADAPTER=1`` (with
VIT_INT8) also the adapter extractors' MSDA output projections and ConvFFN
fc2 in eval mode. Quantization happens at apply time, so one checkpoint
serves both modes. The accuracy of int8 on the published checkpoints has
not been checked; the mode stays opt-in.
"""

import os

import torch

# Number of host-side worker processes/threads for preprocessing & friends
# (the JAX package's default and variable).
default_num_processes = int(os.environ.get("nnUNet_def_n_proc", 8))

# Above this spacing-anisotropy ratio the resampling switches to the
# separate-z path (per-slice 2D resampling + independent z interpolation).
ANISO_THRESHOLD = 3

# Matmuls, convolutions and the kernels run in bfloat16; LayerNorm,
# InstanceNorm and BatchNorm statistics, the softmaxes and the logits in fp32.
# The default `dtype` of ViTConfig and DinoUNetConfig (a torch dtype name).
COMPUTE_DTYPE = "bfloat16"


def accum_budget_bytes() -> int:
    """Device-memory budget for the fp32 sliding-window accumulator pair
    (logits + weights). Above it the predictor raises instead of switching to
    host accumulation, which the port does not have yet. Override with
    DINOUNET_TPU_SW_ACCUM_BUDGET_BYTES (the JAX package's variable)."""
    v = os.environ.get("DINOUNET_TPU_SW_ACCUM_BUDGET_BYTES")
    if v is not None:
        return int(v)
    return 16 << 30  # a fifth of an 80 GB card: the model needs the rest


def _pallas_or_auto(var: str, x: torch.Tensor) -> bool:
    impl = os.environ.get(var, "jax")
    if impl in ("pallas", "interpret"):
        return True
    if impl == "jax":
        return False
    return x.is_cuda  # "auto", and any other value, as in the JAX package


def use_decoder_tail(x: torch.Tensor) -> bool:
    """DINOUNET_TPU_DECODER_TAIL in {"jax", "auto", "pallas", "interpret"}:
    the channel-major decoder chain (transposed conv, two 3x3 convs with the
    InstanceNorm applies in the next kernel's prologue, the seg head) and the
    channel-major LearnableUpsample doublings (``ops/decoder_tail.py``)."""
    return _pallas_or_auto("DINOUNET_TPU_DECODER_TAIL", x)


def use_spm_cm(x: torch.Tensor) -> bool:
    """DINOUNET_TPU_SPM_CM in {"jax", "auto", "pallas", "interpret"}: the
    SpatialPriorModule's stem2/stem3 through ``conv3x3_cm`` with the
    BatchNorm running-statistics applies in the kernel prologues."""
    return _pallas_or_auto("DINOUNET_TPU_SPM_CM", x)


def use_decoder_hwbc(x: torch.Tensor) -> bool:
    """DINOUNET_TPU_DECODER_HWBC in {"jax", "auto", "interpret"}: the
    sub-128-channel decoder stages through ``ops/conv_hwbc.py``. As in the
    JAX package, any value but "jax" and "auto" takes the route."""
    mode = os.environ.get("DINOUNET_TPU_DECODER_HWBC", "jax")
    if mode == "jax":
        return False
    if mode == "auto":
        return x.is_cuda
    return True


def msda_fused_prep() -> bool:
    """DINOUNET_TPU_MSDA_PREP == "fused" (the default; "xla" or any other
    value turns it off): the MSDA kernel takes the raw bf16 offsets and
    logits and does the base add and the point softmax itself."""
    return os.environ.get("DINOUNET_TPU_MSDA_PREP", "fused") == "fused"


def msda_merged_proj() -> bool:
    """DINOUNET_TPU_MSDA_MERGED_PROJ == "1" (default "0"): one projection
    emits the offsets and logits into one packed buffer. The adapter
    consults it only with msda_fused_prep()."""
    return os.environ.get("DINOUNET_TPU_MSDA_MERGED_PROJ", "0") == "1"


def attn_premapped_layout() -> str:
    """DINOUNET_TPU_ATTN_LAYOUT in {"dmaj", "ndh"} (default "dmaj"; any
    other value reads as "dmaj"): the qkv layout of the stats-threaded
    ViT's attention, (B, 3, M, Dh, N) or (B, 3, M, N, Dh)."""
    impl = os.environ.get("DINOUNET_TPU_ATTN_LAYOUT", "dmaj")
    return impl if impl in ("ndh", "dmaj") else "dmaj"


def vit_int8() -> bool:
    """DINOUNET_TPU_VIT_INT8 == "1" (default "0"): the backbone's qkv,
    attention output projection, fc1 and fc2 as w8a8 ops (the SwiGLU
    blocks' qkv, proj, w1, w2 and w3 as QuantDense)."""
    return os.environ.get("DINOUNET_TPU_VIT_INT8", "0") == "1"


def int8_qkv() -> bool:
    """DINOUNET_TPU_INT8_QKV == "1" (default "1"): with vit_int8(), the qkv
    projection in int8 too; "0" keeps it bf16."""
    return os.environ.get("DINOUNET_TPU_INT8_QKV", "1") == "1"


def adapter_int8() -> bool:
    """vit_int8() and DINOUNET_TPU_INT8_ADAPTER == "1" (default "0"): the
    extractors' fused junctions (MSDA output projection, ConvFFN fc2) as
    w8a8 ops too."""
    return vit_int8() and os.environ.get("DINOUNET_TPU_INT8_ADAPTER", "0") == "1"
