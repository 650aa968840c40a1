"""dinounet_tpu_torch: the PyTorch/CUDA port of dinounet_tpu.

The serving slice of the JAX package, for one NVIDIA Hopper card: the
Gaussian sliding-window predictor over the 2-D DinoUNet (frozen DINOv3 ViT +
ViT-Adapter + FAPM + conv U-Net decoder). Plain tensor code is PyTorch; the
four hot ops of the tile forward (RoPE attention, the two fused
dense + residual + LayerNorm-statistics projections, and multi-scale
deformable attention) are CUDA kernels written for sm_90a under ``csrc/``,
built on first use (``ops/_build.py``). Each has a plain PyTorch version in
the same module, which runs for tensors on the CPU.

The package imports torch, numpy and the standard library only.
"""

__version__ = "0.1.0"
