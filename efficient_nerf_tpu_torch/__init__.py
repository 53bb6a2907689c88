"""efficient_nerf_tpu_torch: the R2L system in PyTorch and CUDA for Hopper.

A port of `efficient_nerf_tpu` (JAX/Pallas on a TPU) to PyTorch with kernels
written by hand for the NVIDIA H100 (`sm_90a`). It keeps the JAX package's
module structure, names and public layouts (rays [B, 3], rgb [B, out_dim],
images [H, W, 3]) so that each function can be held against its JAX
counterpart. It imports neither JAX nor the JAX package.

Every entry point takes an explicit `device`; it defaults to CUDA and raises
when CUDA is absent unless the caller asked for the CPU (device.py).
"""

__version__ = "0.1.0"

from .device import resolve_device

__all__ = ["resolve_device"]
