"""Global settings of the port.

The compute dtype of the model, the device-memory budget of the
sliding-window accumulators, and the three inference-only conv routes. The
JAX package's switches that only choose between TPU formulations of the same
math have no counterpart here: the port keeps one formulation per op.

The routes read the JAX package's environment variables, at call time, with
its value logic (``dinounet_tpu/configuration.py:271-292,355-368,426-448``):
"jax" (the default) keeps the stock modules; "pallas" and "interpret" take
the route on any device, where an op on a CPU tensor runs its plain version
and one on a CUDA tensor launches its kernel; "auto" takes it only for CUDA
tensors, as the JAX package's "auto" takes it only on a TPU. A module in
train mode never takes a route.
"""

import os

import torch

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
