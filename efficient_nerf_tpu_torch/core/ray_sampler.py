"""R2L ray -> flattened network input, as in
`efficient_nerf_tpu.core.ray_sampler`.

The student consumes a whole ray as one input: n_sample points along it are
flattened into the feature dimension ([B, n_sample*3]). Stratified jitter
is on in training (an augmentation) and off at test. `sample_patch_points`
feeds the conv student: rays [N, ph, pw, 3], one jitter a patch.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import DeviceLike
from .rays import get_rays, plucker_rays
from .sampling import linear_zvals, stratify_zvals

__all__ = ["sample_ray_points", "sample_image_points", "sample_patch_points"]


def sample_ray_points(rays_o: torch.Tensor, rays_d: torch.Tensor, near: float,
                      far: float, n_sample: int, perturb: bool = False,
                      generator: Optional[torch.Generator] = None,
                      t_rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """rays [B, 3] -> [B, n_sample*3] flattened sample coordinates, on the
    rays' device. perturb: stratified jitter of the depths (training), with
    uniforms `t_rand` [B, n_sample] or drawn from `generator`."""
    z = linear_zvals(near, far, n_sample, device=rays_o.device)  # [S]
    z = z.expand(rays_o.shape[:-1] + (n_sample,))
    if perturb:
        z = stratify_zvals(z, t_rand, generator)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., :, None]
    return pts.reshape(pts.shape[:-2] + (n_sample * 3,))


def sample_patch_points(rays_o: torch.Tensor, rays_d: torch.Tensor, near: float,
                        far: float, n_sample: int, perturb: bool = False,
                        generator: Optional[torch.Generator] = None,
                        t_rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CNN-style patch sampling: rays [N, ph, pw, 3] -> [N, ph, pw, S*3],
    after `efficient_nerf_tpu.core.ray_sampler.sample_patch_points` (:46).

    The stratified jitter draws ONE uniform per patch (t_rand [N], or drawn
    from `generator`) broadcast over all its pixels and samples, so the
    whole patch shifts coherently (reference PointSampler.sample_train2,
    nerf_raybased.py:129-173).
    """
    N = rays_o.shape[0]
    z = linear_zvals(near, far, n_sample, device=rays_o.device)  # [S]
    z = z.expand(rays_o.shape[:-1] + (n_sample,))
    if perturb:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], -1)
        lower = torch.cat([z[..., :1], mids], -1)
        if t_rand is None:
            t_rand = torch.rand((N,), generator=generator, device=rays_o.device)
        t = t_rand.reshape((N,) + (1,) * (z.ndim - 1))
        z = lower + (upper - lower) * t
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., :, None]
    return pts.reshape(pts.shape[:-2] + (n_sample * 3,))


def sample_image_points(c2w, H: int, W: int, focal: float, near: float,
                        far: float, n_sample: int, plucker: bool = False,
                        device: DeviceLike = None) -> torch.Tensor:
    """Full-image R2L inputs for one camera: [H*W, n_sample*3] (or [H*W, 6]
    in Plucker mode)."""
    rays_o, rays_d = get_rays(H, W, focal, c2w, device=device)
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    if plucker:
        return plucker_rays(rays_o, rays_d)
    return sample_ray_points(rays_o, rays_d, near, far, n_sample)
