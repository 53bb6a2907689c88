"""R2L (neural light field) rendering: one ray -> one forward -> one pixel,
after `efficient_nerf_tpu.render.r2l_renderer`.

Eligible models (the flagship profile: uniform-width resmlp body, relu,
sigmoid tail, eval mode, no Plucker input) on a CUDA device go through the
fused kernel `ops.r2l_forward_fused`; everything else goes through
`sample_ray_points` -> `ray_embed` -> `R2LNet`. On the CPU the unfused path
runs, as the JAX package's XLA path does off the TPU. int8 serving and
`calibrate_serving_scales` arrive with the int8 slice; the conv student is
not ported yet.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from ..core.encoding import ray_embed
from ..core.ray_sampler import sample_image_points, sample_ray_points
from ..core.rays import get_rays, plucker_rays
from ..device import DeviceLike, resolve_device, to_device
from ..models.r2l import R2LNet
from ..ops import fused_r2l_available, pack_r2l_weights, r2l_forward_fused
from ..ops.r2l_forward import MAX_WIDTH, WIDTH_ALIGN

__all__ = ["r2l_forward_rays", "r2l_render_image", "make_r2l_forward"]


def _check_model(model, quant: str, dev: torch.device) -> None:
    if quant == "int8":
        raise NotImplementedError(
            "quant='int8' serving arrives with the int8 slice (slice 3)")
    if quant:
        raise ValueError(f"unknown quant mode {quant!r}")
    if not isinstance(model, R2LNet):
        raise NotImplementedError(
            f"{type(model).__name__} is not ported: only the R2LNet student "
            "is (the conv student R2LConvNet is still to be ported)")
    p = next(model.parameters())
    if p.device != dev:
        raise ValueError(f"model is on {p.device}, rendering on {dev}: move "
                         "the model with model.to(device)")


def _fused_eligible(model: R2LNet, plucker: bool, perturb: bool,
                    dev: torch.device) -> bool:
    """The fused kernel covers the flagship profile: uniform-width resmlp
    body, relu in-act, sigmoid tail, eval mode, non-Plucker, a width the
    kernel's warps cover, on a CUDA device."""
    return (not plucker and not perturb
            and model.body_arch == "resmlp"
            and not model.layerwise_widths
            and model.n_learnable == 2
            and model.act == "relu" and model.inact == "relu"
            and model.outact == "none"
            and not model.linear_tail
            and model.width % WIDTH_ALIGN == 0 and model.width <= MAX_WIDTH
            and fused_r2l_available(dev))


_optimizer_steps = 0


def _count_optimizer_step(optimizer, args, kwargs) -> None:
    global _optimizer_steps
    _optimizer_steps += 1


# a fused optimizer (Adam(fused=True)) writes the parameters without bumping
# their version counters, so the pack's key also counts every optimizer step
# taken in the process
register_optimizer_step_post_hook(_count_optimizer_step)


def _packed(model: R2LNet, n_sample: int, L: int) -> Dict[str, object]:
    """The model's kernel operands, packed once and reused while no
    parameter changes: the key holds each parameter's storage and version
    counter, which in-place updates through autograd-visible ops
    (load_state_dict, a foreach optimizer) bump, and the count of optimizer
    steps, which also covers the fused optimizers that do not."""
    key: Tuple = (n_sample, L, _optimizer_steps) + tuple(
        (p.data_ptr(), p._version) for p in model.parameters())
    cached = getattr(model, "_fused_pack", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            cached = (key, pack_r2l_weights(model.state_dict(), n_sample, L))
        model._fused_pack = cached
    return cached[1]


def _as_rays(x, dev: torch.device) -> torch.Tensor:
    return to_device(x, dev).contiguous()


def r2l_forward_rays(model: R2LNet, rays_o, rays_d, near: float, far: float,
                     n_sample: int, L: int = 10, plucker: bool = False,
                     perturb: bool = False, allow_fused: bool = True,
                     quant: str = "", device: DeviceLike = None) -> torch.Tensor:
    """[B, 3] rays -> [B, output_dim] colors on `device` (default CUDA).

    Eligible models on CUDA dispatch to the fused kernel
    (allow_fused=False forces the unfused path).
    """
    dev = resolve_device(device)
    _check_model(model, quant, dev)
    rays_o, rays_d = _as_rays(rays_o, dev), _as_rays(rays_d, dev)
    with torch.no_grad():
        if allow_fused and _fused_eligible(model, plucker, perturb, dev):
            return r2l_forward_fused(
                _packed(model, n_sample, L), rays_o, rays_d, near, far,
                n_sample, L, res_scale=model.res_scale,
                use_global_residual=model.use_residual)
        if plucker:
            pts = plucker_rays(rays_o, rays_d)
        else:
            pts = sample_ray_points(rays_o, rays_d, near, far, n_sample,
                                    perturb=perturb)
        return model(ray_embed(pts, L))


def make_r2l_forward(model: R2LNet, near: float, far: float, n_sample: int,
                     L: int = 10, plucker: bool = False,
                     device: DeviceLike = None):
    """Eval-mode ray forward closure: (rays_o, rays_d) -> rgb."""
    dev = resolve_device(device)

    def fn(rays_o, rays_d):
        return r2l_forward_rays(model, rays_o, rays_d, near, far, n_sample,
                                L=L, plucker=plucker, device=dev)

    return fn


def r2l_render_image(model: R2LNet, c2w, H: int, W: int, focal: float,
                     near: float, far: float, n_sample: int, L: int = 10,
                     plucker: bool = False, chunk: int = 0, quant: str = "",
                     device: DeviceLike = None) -> torch.Tensor:
    """Render a full frame -> [H, W, output_dim] on `device` (default CUDA).

    Eligible models render the whole frame in one fused launch; the
    unfused path evaluates `chunk` rays at a time when chunk > 0.
    """
    dev = resolve_device(device)
    _check_model(model, quant, dev)
    if _fused_eligible(model, plucker, perturb=False, dev=dev):
        rays_o, rays_d = get_rays(H, W, focal, c2w, device=dev)
        rgb = r2l_forward_rays(model, rays_o.reshape(-1, 3),
                               rays_d.reshape(-1, 3), near, far, n_sample, L,
                               device=dev)
        return rgb.reshape(H, W, -1)
    with torch.no_grad():
        pts = sample_image_points(c2w, H, W, focal, near, far, n_sample,
                                  plucker=plucker, device=dev)
        x = ray_embed(pts, L)
        if chunk and chunk < x.shape[0]:
            rgb = torch.cat([model(xi) for xi in torch.split(x, chunk)])
        else:
            rgb = model(x)
    return rgb.reshape(H, W, -1)
