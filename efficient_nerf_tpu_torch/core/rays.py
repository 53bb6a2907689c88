"""Ray generation, as in `efficient_nerf_tpu.core.rays`.

Pixel (x, y) maps to the camera-space direction ((x - W/2)/f, -(y - H/2)/f, -1),
rotated into the world frame by the camera-to-world matrix; ray origins are
the camera position. `ndc_rays` and the origin-translation helpers are not
ported yet.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_device

__all__ = ["get_rays", "plucker_rays"]


@functools.lru_cache(maxsize=32)
def _pixel_dirs_np(H: int, W: int, focal: float) -> np.ndarray:
    """Camera-frame unit-plane directions for every pixel, as [H, W, 3]."""
    x = np.arange(W, dtype=np.float32)
    y = np.arange(H, dtype=np.float32)
    xs, ys = np.meshgrid(x, y, indexing="xy")  # each [H, W]
    dirs = np.stack(
        [(xs - W * 0.5) / focal, -(ys - H * 0.5) / focal, -np.ones_like(xs)],
        axis=-1,
    )
    dirs.setflags(write=False)  # shared by every caller through the cache
    return dirs


@functools.lru_cache(maxsize=8)
def _pixel_dirs(H: int, W: int, focal: float, device: torch.device) -> torch.Tensor:
    """_pixel_dirs_np on `device`, made once per camera and device (the JAX
    package gets the same from XLA's constant folding)."""
    return to_device(_pixel_dirs_np(H, W, focal).copy(), device)


def get_rays(H: int, W: int, focal: float, c2w, focal_scale: float = 1.0,
             device: DeviceLike = None):
    """World-space rays for every pixel of a pinhole camera.

    c2w: [3, 4] or [4, 4] (only the top 3x4 is used), numpy or tensor.
    Returns (rays_o, rays_d), each [H, W, 3] f32 on `device`; rays_d is not
    normalized.
    """
    dev = resolve_device(device)
    dirs = _pixel_dirs(H, W, float(focal) * float(focal_scale), dev)
    c2w = to_device(c2w, dev)
    # d_w = R @ d_c as an elementwise multiply and sum: a matmul here could
    # run in TF32 on the card and corrupt the directions
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], dim=-1)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def plucker_rays(rays_o: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """Plucker-coordinate ray representation [..., 6] = (d, o x d)."""
    m = torch.linalg.cross(rays_o, rays_d, dim=-1)
    return torch.cat([rays_d, m], dim=-1)
