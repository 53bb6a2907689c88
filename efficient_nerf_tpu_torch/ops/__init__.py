"""Kernels written by hand for Hopper, each beside its plain torch version.

  * `r2l_forward_fused` (r2l_forward.py, csrc/r2l_forward.cu): the whole R2L
    inference forward, rays in, rgb out.
  * `fast_sin` / `fast_cos` / `fast_sincos` (trig.py, csrc/trig.cuh): the
    polynomial trig the kernels call as device helpers.

The gate is the tensor's device: a kernel runs on CUDA tensors, its plain
version on CPU tensors. There is no switch that turns a kernel off.
"""
from __future__ import annotations

import torch

from .r2l_forward import pack_r2l_weights, r2l_forward_fused, r2l_forward_fused_ref
from .trig import fast_cos, fast_sin, fast_sincos, fast_sincos_cuda

__all__ = ["fused_r2l_available", "pack_r2l_weights", "r2l_forward_fused",
           "r2l_forward_fused_ref", "fast_sin", "fast_cos", "fast_sincos",
           "fast_sincos_cuda"]


def fused_r2l_available(device: torch.device) -> bool:
    """The fused R2L kernel serves tensors that lie on a CUDA device."""
    return torch.device(device).type == "cuda"
