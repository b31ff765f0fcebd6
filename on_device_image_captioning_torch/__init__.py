"""PyTorch + CUDA port of the image-captioning system (Swin-L/384 backbone +
ExpansionNet v2 caption head), written for one NVIDIA H100.

The JAX package `on_device_image_captioning_tpu` beside it is the reference:
module names here follow it, so each module has a counterpart there. This
package imports `torch` and never `jax`; its CUDA kernels are built and
loaded at their first launch, never at import time.

Kernel dispatch rule (every wrapper under `ops/`): a CPU tensor gets the
kernel's plain PyTorch version, a CUDA tensor gets the hand-written kernel or
an exception. There is no switch and no fallback.
"""
