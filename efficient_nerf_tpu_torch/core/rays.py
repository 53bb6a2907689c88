"""Ray generation, as in `efficient_nerf_tpu.core.rays`.

Pixel (x, y) maps to the camera-space direction ((x - W/2)/f, -(y - H/2)/f, -1),
rotated into the world frame by the camera-to-world matrix; ray origins are
the camera position. `get_rays_np` is the numpy twin for host-side data
preparation (the synthetic scene, the shard converter). `ndc_rays` projects
forward-facing (LLFF) rays to NDC; the origin translations are the
pseudo-data generator's `trans_origin` modes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_device
from ..utils.profiling import span

__all__ = ["pixel_dirs", "get_rays", "get_rays_np", "plucker_rays", "ndc_rays",
           "translate_origin_fixed", "translate_origin_to_sphere",
           "apply_trans_origin"]


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


def pixel_dirs(H: int, W: int, focal: float, device: DeviceLike = None) -> torch.Tensor:
    """[H, W, 3] camera-frame direction for each pixel (z = -1 plane), on
    `device`."""
    return _pixel_dirs(H, W, float(focal), resolve_device(device))


def get_rays(H: int, W: int, focal: float, c2w, focal_scale=1.0,
             device: DeviceLike = None):
    """World-space rays for every pixel of a pinhole camera.

    c2w: [3, 4] or [4, 4] (only the top 3x4 is used), numpy or tensor.
    Returns (rays_o, rays_d), each [H, W, 3] f32 on `device`; rays_d is not
    normalized.

    focal_scale: a Python number multiplies the focal. Anything else (a
    tensor or a numpy scalar, as the pseudo-data generator's random focal)
    takes the JAX package's second branch (`core/rays.py:66-68`, what it
    does for a traced scale): pixel directions at the base focal, x and y
    then divided by the scale in f32. The two round differently.
    """
    dev = resolve_device(device)
    if isinstance(focal_scale, (int, float)):
        dirs = _pixel_dirs(H, W, float(focal) * float(focal_scale), dev)
    else:
        dirs = _pixel_dirs(H, W, float(focal), dev)
        # a tensor on the device: a CPU scalar divisor makes CUDA multiply
        # by its reciprocal instead of dividing
        fs = to_device(focal_scale, dev).reshape(())
        dirs = torch.cat([dirs[..., :2] / fs, dirs[..., 2:]], dim=-1)
    c2w = to_device(c2w, dev)
    # d_w = R @ d_c as an elementwise multiply and sum: a matmul here could
    # run in TF32 on the card and corrupt the directions
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], dim=-1)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_np(H: int, W: int, focal: float, c2w):
    """Numpy twin of get_rays for host-side data preparation: (rays_o,
    rays_d), each [H, W, 3], in the JAX package's operations (an einsum over
    the f32 pixel grid), so that the two agree bit for bit. Span:
    core.get_rays_np."""
    with span("core.get_rays_np"):
        c2w = np.asarray(c2w)
        dirs = _pixel_dirs_np(H, W, float(focal))
        rays_d = np.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
        rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
        return rays_o, rays_d


def plucker_rays(rays_o: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """Plucker-coordinate ray representation [..., 6] = (d, o x d)."""
    m = torch.linalg.cross(rays_o, rays_d, dim=-1)
    return torch.cat([rays_d, m], dim=-1)


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o: torch.Tensor,
             rays_d: torch.Tensor):
    """Shift ray origins to the near plane and project to NDC (forward-facing
    scenes), in the JAX package's order of operations."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    fx = W / (2.0 * focal)
    fy = H / (2.0 * focal)
    oz = rays_o[..., 2]
    # a number over a tensor: `number / t` is t.reciprocal() * number in
    # torch, which rounds twice; a tensor numerator divides as JAX does
    o0 = -1.0 / fx * rays_o[..., 0] / oz
    o1 = -1.0 / fy * rays_o[..., 1] / oz
    o2 = 1.0 + torch.full_like(oz, 2.0 * near) / oz

    d0 = -1.0 / fx * (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / oz)
    d1 = -1.0 / fy * (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / oz)
    d2 = torch.full_like(oz, -2.0 * near) / oz
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def _unit(rays_d: torch.Tensor) -> torch.Tensor:
    return rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)


def translate_origin_fixed(rays_o: torch.Tensor, rays_d: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """Slide ray origins `scale` units along the normalized direction."""
    return rays_o + scale * _unit(rays_d)


def translate_origin_to_sphere(rays_o: torch.Tensor, rays_d: torch.Tensor,
                               radius: float = 3.6) -> torch.Tensor:
    """Slide each origin along its ray onto the |o'| = radius sphere: solve
    |o + t u|^2 = r^2 for the unit direction u and take the root nearest the
    camera (the reference's min-|root| and sign rule)."""
    u = _unit(rays_d)
    m2 = torch.sum(rays_o * rays_o, dim=-1)
    b = torch.sum(rays_o * u, dim=-1)
    disc = torch.clamp_min(b * b - m2 + radius * radius, 0.0)
    sq = torch.sqrt(disc)
    d1 = -b + sq
    d2 = -b - sq
    opposite = d1 * d2 < 0
    min_abs = torch.where(torch.abs(d1) <= torch.abs(d2), d1, d2)
    t = torch.where(opposite, torch.maximum(d1, d2),
                    torch.sign(d1) * torch.abs(min_abs))
    return rays_o + t[..., None] * u


def apply_trans_origin(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       trans_origin: str) -> torch.Tensor:
    """The --trans_origin modes: '' no-op; 'fixed' 30 units along the ray;
    '<float>' that many units; 'adapative' / 'adaptive' / 'to_sphere' onto
    the |o| = 3.6 sphere (the reference's misspelt 'adapative' branch calls
    an undefined function; the JAX package maps it here, and so does this
    one)."""
    if not trans_origin:
        return rays_o
    if trans_origin in ("adapative", "adaptive", "to_sphere"):
        return translate_origin_to_sphere(rays_o, rays_d)
    scale = 30.0 if trans_origin == "fixed" else float(trans_origin)
    return translate_origin_fixed(rays_o, rays_d, scale)
