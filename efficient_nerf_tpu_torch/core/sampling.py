"""Depth values along rays, as in `efficient_nerf_tpu.core.sampling`.

`linear_zvals` and `stratify_zvals` are ported; `sample_pdf` and the rest
arrive with the teacher.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_device

__all__ = ["linear_zvals", "stratify_zvals"]


def _linspace01(n: int) -> np.ndarray:
    """f32 linspace(0, 1, n) as the JAX package gets it from jnp.linspace
    under XLA: i times the f32 reciprocal of n-1 (XLA turns the division by
    a constant into that multiply), endpoint exact. So depths match the JAX
    package bit for bit; torch.linspace rounds some entries the other way."""
    if n == 1:
        return np.zeros(1, np.float32)
    return np.append(
        np.arange(n - 1, dtype=np.float32) * (np.float32(1) / np.float32(n - 1)),
        np.float32(1))


def linear_zvals(near: float, far: float, n_samples: int,
                 device: DeviceLike = None):
    """Base depth values [n_samples] between scalar near and far (f32),
    computed on the host in f32, one operation at a time as the JAX
    package's f32 arithmetic does, and copied to `device`. (`lindisp`
    arrives with the teacher, its only user.)"""
    dev = resolve_device(device)
    t = _linspace01(n_samples)
    near, far = np.float32(near), np.float32(far)
    return to_device(near * (np.float32(1) - t) + far * t, dev)


def stratify_zvals(z_vals: torch.Tensor, t_rand: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Jitter each depth uniformly within its interval, after
    `efficient_nerf_tpu.core.sampling.stratify_zvals` (:34-50).

    z_vals: [..., S]. Intervals are delimited by the midpoints between
    neighbouring samples; the first and last reach the endpoints. t_rand:
    uniforms of z_vals' shape (the tests hand both packages the same
    numbers); otherwise drawn with `torch.rand` from `generator` on
    z_vals' device.
    """
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], -1)
    lower = torch.cat([z_vals[..., :1], mids], -1)
    if t_rand is None:
        t_rand = torch.rand(z_vals.shape, generator=generator,
                            device=z_vals.device)
    return lower + (upper - lower) * t_rand
