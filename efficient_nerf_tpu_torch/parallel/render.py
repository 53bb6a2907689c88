"""Data-parallel R2L serving, after `efficient_nerf_tpu.parallel.render`
(:21-41).

Rays are independent, so each rank serves its own rows through the
per-card dispatch of `r2l_forward_rays` (the fused kernel, or the int8 one
with quant="int8") with no collective at all. The caller gathers a frame
with `mesh.gather_batch`.
"""
from __future__ import annotations

from ..render.r2l_renderer import r2l_forward_rays
from .mesh import Mesh

__all__ = ["make_sharded_r2l_forward"]


def make_sharded_r2l_forward(model, mesh: Mesh, *, near: float, far: float,
                             n_sample: int, L: int = 10, plucker: bool = False,
                             quant: str = "", act_scales=None):
    """fn(rays_o, rays_d) -> rgb of this rank's rows, on the mesh's device.

    The model is replicated (each rank holds it whole). quant="int8" serves
    through the W8A8 kernel with act_scales from `calibrate_serving_scales`;
    pass the same scales to every rank, since scales calibrated on each
    rank's own rows would differ from rank to rank.
    """

    def fn(rays_o, rays_d):
        return r2l_forward_rays(model, rays_o, rays_d, near, far, n_sample, L=L,
                                plucker=plucker, perturb=False, quant=quant,
                                device=mesh.device, act_scales=act_scales)

    return fn
