"""R2L (neural light field) rendering: one ray -> one forward -> one pixel,
after `efficient_nerf_tpu.render.r2l_renderer`.

Eligible models (the flagship profile: uniform-width resmlp body, relu,
sigmoid tail, eval mode, no Plucker input) on a CUDA device go through the
fused kernel `ops.r2l_forward_fused`; everything else goes through
`sample_ray_points` -> `ray_embed` -> `R2LNet`. On the CPU the unfused path
runs, as the JAX package's XLA path does off the TPU.

`quant="int8"` serves through the W8A8 kernel `ops.r2l_forward_int8`, with
activation scales from `calibrate_serving_scales` (once per checkpoint) or,
without them, calibrated on the first 1024 rays of the call. It needs the
flagship profile and raises `ValueError` otherwise, on any device. A
deliberate divergence: the JAX package's int8 branch raises off the TPU,
where its Pallas kernel is unavailable; here a CPU device runs the int8
kernel's plain version, so that the tests can hold the whole int8 path
against the JAX package.

The conv student (`R2LConvNet`) renders a full frame as one [1, H, W, C]
patch and evaluates arbitrary rays as 1x1 patches (SAME-padded convs reduce
to their centre taps), in eval mode (BatchNorm on its running statistics),
always unfused: no kernel covers a conv body in either package, and
`quant="int8"` raises for it as for every model off the flagship profile.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.encoding import ray_embed
from ..core.ray_sampler import sample_image_points, sample_ray_points
from ..core.rays import get_rays, plucker_rays
from ..device import DeviceLike, resolve_device, to_device
from ..models.r2l import R2LConvNet, R2LNet
from ..ops import (calibrate_r2l_int8, fused_r2l_available, pack_r2l_weights,
                   pack_r2l_weights_int8, r2l_forward_fused, r2l_forward_int8)
from ..ops.r2l_forward import MAX_WIDTH, WIDTH_ALIGN
from ..utils.profiling import span
from ._pack_cache import cached_pack

__all__ = ["r2l_forward_rays", "r2l_render_image", "make_r2l_forward",
           "calibrate_serving_scales"]

_PACKERS = {"": pack_r2l_weights, "int8": pack_r2l_weights_int8}
_INT8_PROFILE = ("int8 inference requires the fused-kernel profile (R2LNet, uniform "
                 "resmlp body, relu, sigmoid tail, eval mode, no Plucker input, a width "
                 f"that is a multiple of {WIDTH_ALIGN} up to {MAX_WIDTH})")


def _check_model(model, quant: str, dev: torch.device) -> None:
    if quant not in _PACKERS:
        raise ValueError(f"unknown quant mode {quant!r}")
    if not isinstance(model, (R2LNet, R2LConvNet)):
        raise NotImplementedError(f"{type(model).__name__} is not an R2L student: "
                                  "the renderer serves R2LNet and R2LConvNet")
    if quant == "int8" and not isinstance(model, R2LNet):
        raise ValueError(_INT8_PROFILE)
    p = next(model.parameters())
    if p.device != dev:
        raise ValueError(f"model is on {p.device}, rendering on {dev}: move "
                         "the model with model.to(device)")


def _profile_eligible(model: R2LNet, plucker: bool, perturb: bool) -> bool:
    """The fused kernels cover the flagship profile: uniform-width resmlp
    body, relu in-act, sigmoid tail, eval mode, non-Plucker, a width the
    kernels' warps cover."""
    return (not plucker and not perturb
            and isinstance(model, R2LNet)
            and model.body_arch == "resmlp"
            and not model.layerwise_widths
            and model.n_learnable == 2
            and model.act == "relu" and model.inact == "relu"
            and model.outact == "none"
            and not model.linear_tail
            and model.width % WIDTH_ALIGN == 0 and model.width <= MAX_WIDTH)


def _fused_eligible(model: R2LNet, plucker: bool, perturb: bool,
                    dev: torch.device) -> bool:
    """The bf16 kernel serves the flagship profile on a CUDA device."""
    return _profile_eligible(model, plucker, perturb) and fused_r2l_available(dev)


def _packed(model: R2LNet, n_sample: int, L: int,
            quant: str = "") -> Dict[str, object]:
    """The model's operands for the bf16 (quant "") or the int8 kernel,
    packed once and reused while no parameter changes (`cached_pack`). The
    int8 pack quantizes the body once per parameter version, not once per
    frame."""
    return cached_pack(model, "_int8_pack" if quant else "_fused_pack", (n_sample, L),
                       lambda: _PACKERS[quant](model.state_dict(), n_sample, L))


def _as_rays(x, dev: torch.device) -> torch.Tensor:
    return to_device(x, dev).contiguous()


def calibrate_serving_scales(model: R2LNet, rays_o, rays_d, near: float,
                             far: float, n_sample: int, L: int = 10,
                             n_cal: int = 1024,
                             device: DeviceLike = None) -> torch.Tensor:
    """Per-checkpoint int8 activation scales [n_block, 2] f32 on `device`
    (default CUDA), computed once at load time from the first n_cal rays and
    passed to every frame as `act_scales`, so that no frame calibrates
    itself."""
    dev = resolve_device(device)
    _check_model(model, "int8", dev)
    n_cal = min(n_cal, len(rays_o))
    rays_o = _as_rays(rays_o[:n_cal], dev)
    rays_d = _as_rays(rays_d[:n_cal], dev)
    with torch.no_grad():
        return calibrate_r2l_int8(model.state_dict(), rays_o, rays_d, near, far,
                                  n_sample, L, res_scale=model.res_scale)


def _forward_int8(model: R2LNet, rays_o, rays_d, near, far, n_sample, L,
                  act_scales, dev: torch.device) -> torch.Tensor:
    if act_scales is None:
        # self-calibration on the call's own first rays: right for a one-off
        # render; a serving loop passes calibrate_serving_scales' result
        act_scales = calibrate_serving_scales(model, rays_o, rays_d, near, far,
                                              n_sample, L, device=dev)
    return r2l_forward_int8(
        _packed(model, n_sample, L, "int8"), rays_o, rays_d, near, far,
        n_sample, L, res_scale=model.res_scale,
        use_global_residual=model.use_residual,
        act_scales=to_device(act_scales, dev).contiguous())


def r2l_forward_rays(model: R2LNet, rays_o, rays_d, near: float, far: float,
                     n_sample: int, L: int = 10, plucker: bool = False,
                     perturb: bool = False, allow_fused: bool = True,
                     quant: str = "", device: DeviceLike = None,
                     act_scales=None) -> torch.Tensor:
    """[B, 3] rays -> [B, output_dim] colors on `device` (default CUDA).

    Eligible models on CUDA dispatch to the fused kernel
    (allow_fused=False forces the unfused path). quant="int8" takes the W8A8
    kernel (its plain version on the CPU) with act_scales from
    `calibrate_serving_scales`, or calibrates on the first 1024 rays when
    act_scales is None; it raises ValueError for a model off the flagship
    profile or with allow_fused=False.
    """
    dev = resolve_device(device)
    _check_model(model, quant, dev)
    return _forward_rays(model, _as_rays(rays_o, dev), _as_rays(rays_d, dev), near, far,
                         n_sample, L, plucker, perturb, allow_fused, quant, act_scales, dev)


def _forward_rays(model, rays_o: torch.Tensor, rays_d: torch.Tensor, near, far,
                  n_sample: int, L: int, plucker: bool, perturb: bool,
                  allow_fused: bool, quant: str, act_scales,
                  dev: torch.device) -> torch.Tensor:
    """`r2l_forward_rays` after its device and model checks, on contiguous
    f32 rays on `dev`."""
    if quant == "int8" and not (allow_fused and _profile_eligible(model, plucker, perturb)):
        raise ValueError(_INT8_PROFILE)
    with torch.no_grad():
        if quant == "int8":
            return _forward_int8(model, rays_o, rays_d, near, far, n_sample, L,
                                 act_scales, dev)
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
        x = ray_embed(pts, L)
        if isinstance(model, R2LConvNet):
            return _conv_eval(model, x[:, None, None, :]).reshape(x.shape[0], -1)
        return model(x)


def _conv_eval(model: R2LConvNet, x: torch.Tensor) -> torch.Tensor:
    """The conv student on NHWC patches x in eval mode (BatchNorm on its
    running statistics); the model's mode is restored after."""
    was_training = model.training
    model.eval()
    try:
        return model(x)
    finally:
        model.train(was_training)


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
                     device: DeviceLike = None,
                     act_scales: Optional[torch.Tensor] = None,
                     allow_fused: bool = True) -> torch.Tensor:
    """Render a full frame -> [H, W, output_dim] on `device` (default CUDA).

    Eligible models render the whole frame in one fused launch (quant="int8":
    the W8A8 kernel, act_scales from `calibrate_serving_scales`, which a
    serving loop passes; None calibrates on the frame's first 1024 rays);
    allow_fused=False forces the unfused path (and makes quant="int8"
    raise). The unfused path evaluates `chunk` rays at a time when chunk >
    0; the conv student evaluates the frame as one [1, H, W, C] patch.
    Spans (`utils.profiling.span`): r2l.render_image around the call,
    r2l.rays around the rays (and, unfused, their points), r2l.forward
    around the network.
    """
    with span("r2l.render_image"):
        dev = resolve_device(device)
        _check_model(model, quant, dev)
        if quant == "int8" or (allow_fused and _fused_eligible(model, plucker, False, dev)):
            with span("r2l.rays"):
                rays_o, rays_d = get_rays(H, W, focal, c2w, device=dev)
            with span("r2l.forward"):
                rgb = _forward_rays(model, rays_o.reshape(-1, 3).contiguous(),
                                    rays_d.reshape(-1, 3).contiguous(), near, far,
                                    n_sample, L, plucker, False, allow_fused, quant,
                                    act_scales, dev)
            return rgb.reshape(H, W, -1)
        with torch.no_grad():
            with span("r2l.rays"):
                pts = sample_image_points(c2w, H, W, focal, near, far, n_sample,
                                          plucker=plucker, device=dev)
            with span("r2l.forward"):
                x = ray_embed(pts, L)
                if isinstance(model, R2LConvNet):
                    rgb = _conv_eval(model, x.reshape(1, H, W, x.shape[-1]))
                elif chunk and chunk < x.shape[0]:
                    rgb = torch.cat([model(xi) for xi in torch.split(x, chunk)])
                else:
                    rgb = model(x)
        return rgb.reshape(H, W, -1)
