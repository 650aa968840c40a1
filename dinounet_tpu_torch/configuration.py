"""Global settings of the port.

Only what the serving slice reads: the compute dtype of the model and the
device-memory budget of the sliding-window accumulators. The JAX package's
switches that choose between TPU formulations of the same math have no
counterpart here: the port keeps one formulation per op.
"""

import os

# Matmuls, convolutions and the four kernels run in bfloat16; LayerNorm,
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
