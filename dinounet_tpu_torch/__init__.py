"""dinounet_tpu_torch: the PyTorch/CUDA port of dinounet_tpu.

The JAX package's 2-D path, for one NVIDIA Hopper card: the Gaussian
sliding-window predictor over the DinoUNet (frozen DINOv3 ViT + ViT-Adapter +
FAPM + conv U-Net decoder), its trainer, and the path from raw image files
to segmentation files (readers and writers, preprocessing, the trainer's
final validation, export and metrics). Plain tensor code is PyTorch; the
four hot ops of the tile forward (RoPE attention, the two fused
dense + residual + LayerNorm-statistics projections, and multi-scale
deformable attention) are CUDA kernels written for sm_90a under ``csrc/``,
built on first use (``ops/_build.py``). Each has a plain PyTorch version in
the same module, which runs for tensors on the CPU.

The package imports torch, numpy, scipy (the host's resampling, cropping and
metrics, as in the JAX package) and the standard library; PIL only inside
the PNG and TIFF readers and writers, when such a file is read or written.
"""

__version__ = "0.1.0"
