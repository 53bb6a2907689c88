"""Camera pose math (host-side numpy), as in `efficient_nerf_tpu.core.poses`.

Only `pose_spherical` is ported so far; the novel-pose grids and the LLFF
pose pipeline come with the loaders.
"""
from __future__ import annotations

import numpy as np

__all__ = ["pose_spherical"]


def _trans_z(t: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def _rot_phi(phi: float) -> np.ndarray:
    c, s = np.cos(phi), np.sin(phi)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def _rot_theta(th: float) -> np.ndarray:
    c, s = np.cos(th), np.sin(th)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, -s, s, c
    return m


_FLIP = np.array(
    [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
)


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """4x4 c2w looking at the origin from spherical coords (blender frame)."""
    c2w = _trans_z(radius)
    c2w = _rot_phi(phi_deg / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta_deg / 180.0 * np.pi) @ c2w
    return (_FLIP @ c2w).astype(np.float32)
