"""rays -> flattened stratified points -> R2L positional encoding in one
linear step, after `efficient_nerf_tpu.ops.ray_points_embed` (ops/__init__.py
:90-113) and its constants (`_embed_constants_np`, ops/pallas/r2l_forward.py
:43-70), copied here since this package must not import the JAX one.

The deterministic path is linear in the rays: y = o @ P1 + d @ P2, then sin,
cos or the identity per column. Plain torch, not a kernel: no TPU kernel
stands behind it (the JAX function is jnp).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.encoding import ray_embed
from ..core.ray_sampler import sample_ray_points

__all__ = ["ray_points_embed"]


@functools.lru_cache(maxsize=8)
def _embed_constants_np(n_sample: int, L: int, near: float, far: float
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(P1, P2, mode) for the linearized embedding.

    P1/P2: [3, K*(2L+1)] f32. mode: [K*(2L+1)] int32 in {0 sin, 1 cos, 2 id}.
    """
    K = n_sample * 3
    E = 2 * L + 1
    z = np.linspace(near, far, n_sample).astype(np.float64)

    # p = o @ A + d @ B ; A,B: [3, K]
    A = np.zeros((3, K))
    Bz = np.zeros((3, K))
    for s in range(n_sample):
        for c in range(3):
            A[c, s * 3 + c] = 1.0
            Bz[c, s * 3 + c] = z[s]

    # y = p @ S ; S: [K, K*E], S[m, m*E + j] = f_j
    freqs = np.concatenate([2.0 ** np.arange(L), 2.0 ** np.arange(L), [1.0]])
    S = np.zeros((K, K * E))
    for m in range(K):
        S[m, m * E:(m + 1) * E] = freqs

    mode = np.tile(np.concatenate(
        [np.zeros(L), np.ones(L), [2]]).astype(np.int32), K)
    return ((A @ S).astype(np.float32), (Bz @ S).astype(np.float32), mode)


def ray_points_embed(rays_o: torch.Tensor, rays_d: torch.Tensor, near: float,
                     far: float, n_sample: int, L: int, perturb: bool = False,
                     generator: Optional[torch.Generator] = None,
                     t_rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """rays [B, 3] -> [B, n_sample*3*(2L+1)], the layout of
    `ray_embed(sample_ray_points(...), L)`, on the rays' device.

    perturb: the explicit sample + embed chain, the depths jittered with
    uniforms `t_rand` [B, n_sample] or drawn from `generator`.

    The deterministic path computes o @ P1 + d @ P2 elementwise. Each column
    of P1 and of P2 has at most one nonzero, in the row of coordinate
    (col // (2L+1)) % 3, so o[:, c] * P1[c, col] + d[:, c] * P2[c, col]
    is the product's exact f32 value. A matmul would be free to run in TF32
    on the card, whose 10-bit operands the 2^j-scaled columns turn into
    O(1) phase error; the JAX function asks for Precision.HIGHEST for the
    same reason.
    """
    if perturb:
        pts = sample_ray_points(rays_o, rays_d, near, far, n_sample,
                                perturb=True, generator=generator, t_rand=t_rand)
        return ray_embed(pts, L)

    P1, P2, mode = _embed_constants_np(n_sample, L, float(near), float(far))
    cols = np.arange(P1.shape[1])
    coord = (cols // (2 * L + 1)) % 3
    dev = rays_o.device
    p1 = torch.from_numpy(P1[coord, cols]).to(dev)
    p2 = torch.from_numpy(P2[coord, cols]).to(dev)
    idx = torch.from_numpy(coord).to(dev)
    y = rays_o[..., idx] * p1 + rays_d[..., idx] * p2
    mode = torch.from_numpy(mode).to(dev)
    return torch.where(mode == 0, torch.sin(y),
                       torch.where(mode == 1, torch.cos(y), y))
