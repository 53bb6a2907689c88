"""Kernels written by hand for Hopper, each beside its plain torch version.

  * `r2l_forward_fused` (r2l_forward.py, csrc/r2l_forward.cu): the whole R2L
    inference forward, rays in, rgb out.
  * `r2l_forward_int8` (r2l_int8.py, csrc/r2l_int8.cu): the same forward
    with the residual body in int8 (W8A8, static or per-row dynamic
    activation scales), beside `pack_r2l_weights_int8` and
    `calibrate_r2l_int8`.
  * `r2l_train_fwd` / `r2l_train_bwd` (r2l_train.py): the fused training
    forward (csrc/r2l_train.cu) and the backward in two passes, the
    activation chain `r2l_train_bwd_act` (csrc/r2l_train.cu) and the weight
    gradients `r2l_train_wgrad` (csrc/r2l_wgrad.cu), behind
    `r2l_train_apply`.
  * `nerf_forward_fused` (nerf_forward.py, csrc/nerf_forward.cu): the
    teacher's field eval, sample points and view directions in, raw out,
    beside `pack_nerf_weights`.
  * `nerf_forward_int8` (nerf_int8.py, csrc/nerf_int8.cu): the same field
    eval with the hidden layers and the feature head in int8 (W8A8, static
    activation scales), beside `pack_nerf_weights_int8` and
    `calibrate_nerf_int8`.
  * `sample_pdf_det_fused` (sample_pdf.py, csrc/sample_pdf.cu): the
    teacher's deterministic inverse-CDF sampler.
  * `nerf_render_rays_fused` (nerf_frame.py, csrc/nerf_frame.cu): the whole
    deterministic coarse + fine teacher render of a ray batch, rays in, the
    RenderResult fields out.
  * `fast_sin` / `fast_cos` / `fast_sincos` (trig.py, csrc/trig.cuh): the
    polynomial trig the kernels call as device helpers.

The gate is the tensor's device: a kernel runs on CUDA tensors, its plain
version on CPU tensors. There is no switch that turns a kernel off.
"""
from __future__ import annotations

import torch

from .r2l_forward import pack_r2l_weights, r2l_forward_fused, r2l_forward_fused_ref
from .r2l_int8 import (calibrate_r2l_int8, pack_r2l_weights_int8, r2l_forward_int8,
                       r2l_forward_int8_ref)
from .r2l_train import (pack_r2l_train_weights, r2l_train_apply, r2l_train_bwd,
                        r2l_train_bwd_act, r2l_train_bwd_act_ref, r2l_train_bwd_ref,
                        r2l_train_fwd, r2l_train_fwd_ref, r2l_train_wgrad,
                        r2l_train_wgrad_ref)
from .nerf_forward import nerf_forward_fused, nerf_forward_fused_ref, pack_nerf_weights
from .nerf_frame import nerf_render_rays_fused, nerf_render_rays_fused_ref
from .nerf_int8 import (calibrate_nerf_int8, nerf_forward_int8, nerf_forward_int8_ref,
                        pack_nerf_weights_int8)
from .sample_pdf import sample_pdf_det_fused, sample_pdf_det_fused_ref
from .trig import fast_cos, fast_sin, fast_sincos, fast_sincos_cuda

__all__ = ["fused_r2l_available", "fused_r2l_train_available",
           "pack_r2l_weights", "r2l_forward_fused", "r2l_forward_fused_ref",
           "pack_r2l_weights_int8", "calibrate_r2l_int8", "r2l_forward_int8",
           "r2l_forward_int8_ref",
           "pack_r2l_train_weights", "r2l_train_apply", "r2l_train_fwd",
           "r2l_train_fwd_ref", "r2l_train_bwd", "r2l_train_bwd_ref",
           "r2l_train_bwd_act", "r2l_train_bwd_act_ref", "r2l_train_wgrad",
           "r2l_train_wgrad_ref",
           "pack_nerf_weights", "nerf_forward_fused", "nerf_forward_fused_ref",
           "pack_nerf_weights_int8", "calibrate_nerf_int8", "nerf_forward_int8",
           "nerf_forward_int8_ref", "nerf_render_rays_fused", "nerf_render_rays_fused_ref",
           "sample_pdf_det_fused", "sample_pdf_det_fused_ref",
           "fast_sin", "fast_cos", "fast_sincos", "fast_sincos_cuda"]


def fused_r2l_available(device: torch.device) -> bool:
    """The fused R2L kernel serves tensors that lie on a CUDA device."""
    return torch.device(device).type == "cuda"


# the training kernels take the same devices as the serving kernel
fused_r2l_train_available = fused_r2l_available
