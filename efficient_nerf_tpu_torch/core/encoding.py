"""The R2L student's flattened-ray positional encoding, as in
`efficient_nerf_tpu.core.encoding`.

Each scalar k of a flattened ray expands to
[sin(2^0 k)..sin(2^{L-1} k), cos(2^0 k)..cos(2^{L-1} k), k], and the result is
flattened to [..., K*(2L+1)] (48*21 = 1008 for 16 samples, L = 10). The
teacher's `nerf_embed` arrives with the teacher.
"""
from __future__ import annotations

import torch

__all__ = ["ray_embed", "ray_embed_dim"]


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
