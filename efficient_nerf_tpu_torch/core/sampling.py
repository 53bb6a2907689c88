"""Depth sampling along rays, stratified and hierarchical (inverse CDF), as in
`efficient_nerf_tpu.core.sampling`.

Random draws come from a `torch.Generator` on the tensors' device, or are
handed in through the hooks `t_rand=` and `u=` (the tests give both packages
the same numbers).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_device

__all__ = ["linear_zvals", "stratify_zvals", "stratified_sample", "sample_pdf",
           "sorted_uniform", "merge_sorted"]


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


@functools.lru_cache(maxsize=32)
def _zvals(near: float, far: float, n_samples: int, lindisp: bool,
           device: torch.device) -> torch.Tensor:
    """Scalar-bound depths in f32 on the host, copied to `device` once per
    (bounds, count, device): the renderers ask for them every chunk."""
    t = _linspace01(n_samples)
    near, far = np.float32(near), np.float32(far)
    one = np.float32(1)
    if lindisp:
        z = one / (one / near * (one - t) + one / far * t)
    else:
        z = near * (one - t) + far * t
    return to_device(z, device)


def linear_zvals(near, far, n_samples: int, lindisp: bool = False,
                 device: DeviceLike = None) -> torch.Tensor:
    """Base depth values, in f32, one operation at a time as the JAX
    package's f32 arithmetic does.

    Scalar near/far: [n_samples], computed on the host and copied to
    `device` (a tensor shared by the callers: do not write into it).
    Tensor near/far of shape [..., 1] (per-ray bounds): [..., n_samples] on
    their device (`device` is then ignored). lindisp samples linearly in
    inverse depth.
    """
    if not (torch.is_tensor(near) or torch.is_tensor(far)):
        dev = resolve_device(device)
        return _zvals(float(near), float(far), n_samples, bool(lindisp), dev)
    ref = near if torch.is_tensor(near) else far
    near = torch.as_tensor(near, dtype=torch.float32, device=ref.device)
    far = torch.as_tensor(far, dtype=torch.float32, device=ref.device)
    t = torch.from_numpy(_linspace01(n_samples)).to(ref.device)
    if lindisp:
        return 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    return near * (1.0 - t) + far * t


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


def stratified_sample(rays_o: torch.Tensor, rays_d: torch.Tensor, near, far,
                      n_samples: int, lindisp: bool = False, perturb: bool = True,
                      t_rand: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
    """Sample 3D points along rays [..., 3] on their device. Returns (pts
    [..., S, 3], z_vals [..., S])."""
    shape = rays_o.shape[:-1]
    z = linear_zvals(near, far, n_samples, lindisp, device=rays_o.device)
    z = z.expand(shape + (n_samples,))
    if perturb:
        z = stratify_zvals(z, t_rand, generator)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., :, None]
    return pts, z


def sorted_uniform(shape, generator: Optional[torch.Generator] = None,
                   device: DeviceLike = None) -> torch.Tensor:
    """iid U(0, 1) samples already sorted along the last axis, by the
    order-statistics identity: with E_1..E_{n+1} iid Exp(1),
    cumsum(E)[:n] / sum(E) is distributed as n sorted uniforms. O(n), no
    sort."""
    dev = resolve_device(device) if generator is None else generator.device
    shape = tuple(shape)
    e = -torch.log1p(-torch.rand(shape[:-1] + (shape[-1] + 1,),
                                 generator=generator, device=dev))
    c = torch.cumsum(e, dim=-1)
    return c[..., :-1] / c[..., -1:]


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge per-row sorted a [..., m] and b [..., n] into a sorted
    [..., m+n] by the same Batcher bitonic-merge network as the JAX package:
    flip(a) ++ b is bitonic, padded with the dtype's max to a power of two,
    then log2(N) compare-exchange stages of strided min/max. A general sort
    can order an ulp-level out-of-order b row differently; the network gives
    the JAX package's result bit for bit."""
    m, n = a.shape[-1], b.shape[-1]
    tot = m + n
    x = torch.cat([torch.flip(a, [-1]), b], dim=-1)
    N = 1 << max(1, (tot - 1).bit_length())
    if N != tot:
        big = torch.finfo(a.dtype).max
        x = torch.cat([x, x.new_full(x.shape[:-1] + (N - tot,), big)], dim=-1)
    lead = x.shape[:-1]
    s = N // 2
    while s >= 1:
        xr = x.reshape(lead + (N // (2 * s), 2, s))
        lo = torch.minimum(xr[..., 0, :], xr[..., 1, :])
        hi = torch.maximum(xr[..., 0, :], xr[..., 1, :])
        x = torch.stack([lo, hi], dim=-2).reshape(lead + (N,))
        s //= 2
    return x[..., :tot]


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               det: bool = False, u: Optional[torch.Tensor] = None,
               sorted_u: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-CDF importance sampling of depths from coarse weights, as
    `efficient_nerf_tpu.core.sampling.sample_pdf` (:112): bins [..., C] bin
    edges, weights [..., C-1] -> samples [..., n_samples].

    det: evenly spaced levels (XLA's linspace, `_linspace01`); else uniforms
    from `generator`, already sorted with `sorted_u`; `u` hands the levels in
    (broadcast to [..., n_samples]). Same 1e-5 weight floor and denom < 1e-5
    guard; u >= cdf[-1] returns bins[-1]. The JAX package evaluates every
    interval for every level as a dense masked sum; here the one interval
    with cdf_lo <= u < cdf_hi is found with searchsorted and gathered, which
    selects the same interval (the CDF is nondecreasing, so at most one
    matches) and gives the same value without the [..., n, C-1] temporaries.
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)  # [..., C]
    lead = cdf.shape[:-1]
    if u is None:
        if det:
            u = torch.from_numpy(_linspace01(n_samples)).to(cdf.device)
        elif sorted_u:
            u = sorted_uniform(lead + (n_samples,), generator, device=cdf.device)
        else:
            u = torch.rand(lead + (n_samples,), generator=generator,
                           device=cdf.device)
    u = torch.as_tensor(u, dtype=cdf.dtype, device=cdf.device)
    u = u.expand(lead + (n_samples,)).contiguous()

    n_int = cdf.shape[-1] - 1
    # number of interval upper edges <= u: the interval whose [lo, hi) holds
    # u, or n_int when u >= cdf[-1] (the tail)
    idx = torch.searchsorted(cdf[..., 1:].contiguous(), u, right=True)
    inside = idx < n_int
    i = idx.clamp(max=n_int - 1)
    cdf_lo = torch.gather(cdf[..., :-1], -1, i)
    cdf_hi = torch.gather(cdf[..., 1:], -1, i)
    b_lo = torch.gather(bins[..., :-1], -1, i)
    b_hi = torch.gather(bins[..., 1:], -1, i)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_lo) / denom
    vals = b_lo + t * (b_hi - b_lo)
    # u below cdf[0] = 0 matches no interval in the masked sum either
    inside = inside & (cdf_lo <= u)
    samples = torch.where(inside, vals, torch.zeros_like(vals))
    tail = (u >= cdf[..., -1:]) * bins[..., -1:]
    return samples + tail
