"""Positional encodings, as in `efficient_nerf_tpu.core.encoding`.

Two layouts, each fixed by the first linear layer of the model that reads it:

1. `nerf_embed`, the teacher's per-point encoding: for x in R^d,
   [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...]; d = 3 gives 63
   dims at L = 10 and 27 at L = 4.
2. `ray_embed`, the R2L student's flattened-ray encoding: each scalar k of a
   flattened ray expands to [sin(2^0 k)..sin(2^{L-1} k), cos(2^0 k)..
   cos(2^{L-1} k), k], and the result is flattened to [..., K*(2L+1)]
   (48*21 = 1008 for 16 samples, L = 10).
"""
from __future__ import annotations

import torch

__all__ = ["nerf_embed", "nerf_embed_dim", "ray_embed", "ray_embed_dim"]


def nerf_embed_dim(d: int, L: int, include_input: bool = True) -> int:
    return d * (2 * L + int(include_input))


def ray_embed_dim(K: int, L: int, include_input: bool = True) -> int:
    return K * (2 * L + int(include_input))


def _doubling_sincos(x: torch.Tensor, L: int):
    """sin/cos at octave frequencies 2^j x, j in [0, L), by the double-angle
    recurrences sin 2x = 2 s c, cos 2x = 1 - 2 s^2: one transcendental pair
    per element instead of L. f32 error grows by about 2^L ulp (~1e-4 at
    L = 10). Returns (sins, coss), each [..., L, d]."""
    s = torch.sin(x)
    c = torch.cos(x)
    sins, coss = [s], [c]
    for _ in range(1, L):
        s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
        sins.append(s)
        coss.append(c)
    return torch.stack(sins, dim=-2), torch.stack(coss, dim=-2)


def nerf_embed(x: torch.Tensor, L: int, include_input: bool = True,
               fast: bool = False) -> torch.Tensor:
    """Teacher-style encoding. x: [..., d] -> [..., d*(2L+1)] in the layout
    [x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...], f_i = 2^i.

    fast=True: the double-angle recurrence (see _doubling_sincos).
    """
    if L == 0:
        return x
    if fast:
        sin, cos = _doubling_sincos(x, L)
    else:
        freqs = 2.0 ** torch.arange(L, dtype=x.dtype, device=x.device)
        xf = x[..., None, :] * freqs[:, None]  # [..., L, d]
        sin, cos = torch.sin(xf), torch.cos(xf)
    # interleave per frequency: sin(f_i x) then cos(f_i x)
    sc = torch.stack([sin, cos], dim=-2)  # [..., L, 2, d]
    sc = sc.reshape(x.shape[:-1] + (2 * L * x.shape[-1],))
    if include_input:
        return torch.cat([x, sc], dim=-1)
    return sc


def ray_embed(x: torch.Tensor, L: int, include_input: bool = True,
              fast: bool = False) -> torch.Tensor:
    """R2L-style encoding. x: [..., K] -> [..., K*(2L+1)].

    fast=True: the double-angle recurrence (see _doubling_sincos).
    """
    if fast:
        sin, cos = _doubling_sincos(x[..., None], L)
        parts = [sin.squeeze(-1), cos.squeeze(-1)]
    else:
        freqs = 2.0 ** torch.arange(L, dtype=x.dtype, device=x.device)
        y = x[..., None] * freqs  # [..., K, L]
        parts = [torch.sin(y), torch.cos(y)]
    if include_input:
        parts.append(x[..., None])
    out = torch.cat(parts, dim=-1)  # [..., K, 2L+1]
    return out.reshape(x.shape[:-1] + (-1,))
