"""Camera pose math (host-side numpy), as in `efficient_nerf_tpu.core.poses`.

`pose_spherical`, the random orbit pose and the LLFF bbox pose sampler (with
the helpers it needs) are ported; the novel-pose grids, recentring,
spherification and spiral paths come with the loaders. The same
`np.random.Generator` gives the same poses as the JAX package.
"""
from __future__ import annotations

import numpy as np

__all__ = ["pose_spherical", "random_spherical_pose", "normalize", "viewmatrix",
           "poses_avg", "random_pose_in_bbox", "make_llff_pose_sampler"]


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


def random_spherical_pose(rng: np.random.Generator, radius: float = 4.0,
                          theta_range=(-180.0, 180.0),
                          phi_range=(-90.0, 0.0)) -> np.ndarray:
    """Uniform random orbit pose (reference load_blender.py:359-368)."""
    theta = rng.uniform(*theta_range)
    phi = rng.uniform(*phi_range)
    return pose_spherical(theta, phi, radius)


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """[3, 4] camera frame with view axis z, up hint, position pos."""
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses: np.ndarray) -> np.ndarray:
    """Average [3, 5] pose (orientation-averaged; keeps the first hwf column)."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], 1)


def _bbox(points: np.ndarray):
    return points.min(0), points.max(0)


def _rand_in(rng, lo, hi, scale=1.0):
    mid, half = (lo + hi) * 0.5, (hi - lo) * 0.5 * scale
    return rng.uniform(mid - half, mid + half)


def random_pose_in_bbox(rng: np.random.Generator, poses: np.ndarray,
                        c2w: np.ndarray, up: np.ndarray,
                        scale: float = 1.1) -> np.ndarray:
    """Random LLFF pose inside the (slightly inflated) bbox of the training
    poses (reference load_llff.py:187-218, get_rand_pose_v2, with its module
    globals made explicit)."""
    hwf = c2w[:, 4:5]
    mins_o, maxs_o = _bbox(poses[:, :3, 3])
    mins_d, maxs_d = _bbox(poses[:, :3, 2])
    c = c2w[:3, :4] @ np.array(
        [_rand_in(rng, mins_o[i], maxs_o[i], scale) for i in range(3)] + [1.0]
    )
    z = c2w[:3, :4] @ np.array(
        [_rand_in(rng, mins_d[i], maxs_d[i], scale) for i in range(3)] + [1.0]
    )
    return np.concatenate([viewmatrix(normalize(z), up, c), hwf], 1).astype(np.float32)


def make_llff_pose_sampler(poses: np.ndarray, scale: float = 1.1):
    """Closure rng -> random [3, 5] pose for a forward-facing capture: the
    orientation-averaged c2w and the up vector are derived once from the
    capture's poses ([N, 3, 4] or [N, 3, 5]), then each draw samples the
    camera origin and view axis inside the 1.1x-inflated bbox of the
    training cameras (the pose distribution of LLFF pseudo-data)."""
    poses = np.asarray(poses, np.float32)
    if poses.shape[-1] == 4:
        poses = np.concatenate(
            [poses, np.zeros((poses.shape[0], 3, 1), np.float32)], -1)
    c2w = poses_avg(poses)
    up = normalize(poses[:, :3, 1].sum(0))

    def sample(rng: np.random.Generator) -> np.ndarray:
        return random_pose_in_bbox(rng, poses, c2w, up, scale)

    return sample
