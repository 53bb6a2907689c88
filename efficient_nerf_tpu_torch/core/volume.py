"""Volume integration: raw (rgb, sigma) predictions -> composited ray colors,
as in `efficient_nerf_tpu.core.volume`.

  * dists[i] = z[i+1] - z[i], the last one 1e10, scaled by ||rays_d||;
  * alpha = 1 - exp(-relu(sigma + noise) * dists);
  * T_i = prod_{j<i}(1 - alpha_j + 1e-10) (exclusive cumprod);
  * weights = alpha * T; rgb = sum(w * sigmoid(raw_rgb));
  * disp = 1 / max(1e-10, depth / acc), NaN where acc = 0 (as in the JAX
    package: torch.maximum keeps NaN, clamp would not); white_bkgd adds
    (1 - acc).

The sigma noise is drawn only when raw_noise_std > 0: `noise` hands it in
as is (the tests' hook), else it is `randn * raw_noise_std` from `generator`.

The transmittance's cumprod takes a backward of its own. Torch's cumprod
backward first reads on the host whether its input holds a zero
(`.any().item()`), which drains the card's queue once per call, and only
then takes the formula reversed_cumsum(cumprod * grad) / x. The factors
1 - alpha + 1e-10 are never zero in float32 (1e-10 where alpha is 1, else
at least 2^-24), so `_composite` takes that formula directly: the same
values and gradients, bit for bit, with no read. `exclusive_cumprod`
stays on torch's cumprod, correct for any input, zeros included.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["RenderOutputs", "raw2outputs", "raw2outputs_cm", "exclusive_cumprod"]


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor      # [..., 3]
    disp: torch.Tensor     # [...]
    acc: torch.Tensor      # [...]
    weights: torch.Tensor  # [..., S]
    depth: torch.Tensor    # [...]


def _shift_in_one(cp: torch.Tensor, dim: int) -> torch.Tensor:
    """cp shifted right by one along dim, with a leading 1."""
    ones = torch.ones_like(cp.narrow(dim, 0, 1))
    return torch.cat([ones, cp.narrow(dim, 0, cp.shape[dim] - 1)], dim=dim)


def exclusive_cumprod(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """cumprod shifted right by one with a leading 1 (TF 'exclusive' mode)."""
    return _shift_in_one(torch.cumprod(x, dim=dim), dim)


class _NonzeroCumprod(torch.autograd.Function):
    """torch.cumprod for inputs that hold no zero, with a backward that
    never reads the device from the host.

    Precondition: no element of x is zero. The backward is then torch's own
    no-zero formula, reversed_cumsum(out * grad) / x, in torch's order of
    operations (flip, cumsum, flip, div), so values and gradients equal
    torch.cumprod's bit for bit. Torch's backward reads `(x == 0).any()` on
    the host to choose between that formula and the one for zeros; the read
    waits for the card to drain. With a zero in x this gradient is inf or
    NaN where torch's is finite."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int) -> torch.Tensor:
        out = torch.cumprod(x, dim=dim)
        ctx.save_for_backward(x, out)
        ctx.dim = dim
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, out = ctx.saved_tensors
        dim = ctx.dim
        return (out * grad).flip(dim).cumsum(dim).flip(dim).div(x), None


def _exclusive_cumprod_nonzero(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """`exclusive_cumprod` for x with no zero element (`_NonzeroCumprod`)."""
    return _shift_in_one(_NonzeroCumprod.apply(x, dim), dim)


def _composite(rgb, sigma, z_vals, dist_scale, raw_noise_std, white_bkgd,
               noise, generator, rgb_dim) -> RenderOutputs:
    """rgb: [..., S, 3] (rgb_dim -2) or [3, ..., S] (rgb_dim 0), sigma and
    z_vals [..., S], dist_scale [..., 1]."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * dist_scale
    if raw_noise_std > 0.0:
        if noise is None:
            noise = torch.randn(sigma.shape, generator=generator,
                                device=sigma.device) * raw_noise_std
        sigma = sigma + noise
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    # never zero in float32: 1e-10 where alpha is 1, else 1 - alpha >= 2^-24
    trans = _exclusive_cumprod_nonzero(1.0 - alpha + 1e-10, dim=-1)
    weights = alpha * trans
    if rgb_dim == 0:
        rgb_map = torch.sum(weights[None] * rgb, dim=-1).movedim(0, -1)
    else:
        rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    ratio = depth_map / acc_map
    # a device-side scalar: torch.tensor(1e-10, device=...) would copy from
    # the host and stall the host until the card has drained its queue
    disp_map = 1.0 / torch.maximum(ratio.new_full((), 1e-10), ratio)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return RenderOutputs(rgb_map, disp_map, acc_map, weights, depth_map)


def raw2outputs(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor,
                raw_noise_std: float = 0.0, white_bkgd: bool = False,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> RenderOutputs:
    """Composite raw [..., S, 4] (pre-sigmoid rgb, pre-relu sigma) at depths
    z_vals [..., S] along unnormalized rays_d [..., 3]."""
    return _composite(torch.sigmoid(raw[..., :3]), raw[..., 3], z_vals,
                      torch.linalg.norm(rays_d[..., None, :], dim=-1),
                      raw_noise_std, white_bkgd, noise, generator, rgb_dim=-2)


def raw2outputs_cm(raw_cm: torch.Tensor, z_vals: torch.Tensor,
                   rays_d: torch.Tensor, raw_noise_std: float = 0.0,
                   white_bkgd: bool = False,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> RenderOutputs:
    """Channel-major twin of `raw2outputs`: raw_cm is [4, ..., S]. The same
    math on another layout, kept for the JAX package's interface."""
    return _composite(torch.sigmoid(raw_cm[:3]), raw_cm[3], z_vals,
                      torch.linalg.norm(rays_d, dim=-1)[..., None],
                      raw_noise_std, white_bkgd, noise, generator, rgb_dim=0)
