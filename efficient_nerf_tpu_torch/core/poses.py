"""Camera pose math (host-side numpy), as in `efficient_nerf_tpu.core.poses`.

The pose generators and the LLFF pose pipeline, copied function for
function:
  * spherical poses, the orbit video path, novel-pose grids and random
    orbit poses (reference dataset/load_blender.py:10-28, 327-368);
  * LLFF recentring, spherification, spiral paths and bbox-random poses
    (reference dataset/load_llff.py:135-333).
The same `np.random.Generator` gives the same poses as the JAX package.
"""
from __future__ import annotations

import numpy as np

__all__ = ["pose_spherical", "spherical_render_poses", "novel_pose_grid",
           "random_spherical_pose", "normalize", "viewmatrix", "poses_avg",
           "recenter_poses", "spherify_poses", "render_path_spiral",
           "random_pose_in_bbox", "make_llff_pose_sampler"]


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


def spherical_render_poses(n_pose: int = 40, phi: float = -30.0,
                           radius: float = 4.0) -> np.ndarray:
    """[n_pose, 4, 4] even-theta orbit (the classic blender video path)."""
    thetas = np.linspace(-180.0, 180.0, n_pose + 1)[:-1]
    return np.stack([pose_spherical(t, phi, radius) for t in thetas], 0)


def _axis_values(spec, lo: float, hi: float, endpoint_trim: str):
    """Resolve one axis of a novel-pose grid spec.

    spec: int n -> n sampled values; 'sample:n' -> same; 'fix:v' or a float
    -> single fixed value. endpoint_trim: 'theta' drops the duplicated +180
    endpoint; 'interior' drops both endpoints.
    """
    def _spaced(n):
        if endpoint_trim == "theta":
            return np.linspace(lo, hi, n + 1)[:-1]
        return np.linspace(lo, hi, n + 2)[1:-1]

    if isinstance(spec, (int, np.integer)):
        return _spaced(int(spec))
    s = str(spec)
    if ":" in s:
        mode, value = s.split(":")
        if mode == "sample":
            return _spaced(int(value))
        return np.array([float(value)])
    return np.array([float(s)])


def novel_pose_grid(n_pose, theta_range=(-180.0, 180.0), phi_range=(-90.0, 0.0),
                    radius_range=(2.0, 6.0)) -> np.ndarray:
    """Even-spaced spherical pose grid (reference load_blender.py:327-356).

    n_pose: int (theta orbit only, phi=-30, r=4) or a 3-sequence of axis
    specs [theta, phi, radius], each an int or 'sample:n' / 'fix:v' string.
    """
    if isinstance(n_pose, (int, np.integer)):
        thetas = np.linspace(theta_range[0], theta_range[1], int(n_pose) + 1)[:-1]
        phis, radii = [-30.0], [4.0]
    else:
        thetas = _axis_values(n_pose[0], *theta_range, endpoint_trim="theta")
        phis = _axis_values(n_pose[1], *phi_range, endpoint_trim="interior")
        radii = _axis_values(n_pose[2], *radius_range, endpoint_trim="interior")
    return np.stack(
        [pose_spherical(t, p, r) for r in radii for p in phis for t in thetas], 0
    )


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


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Rigidly transform all poses so the average pose is the identity."""
    out = poses.copy()
    bottom = np.array([[0, 0, 0, 1.0]], dtype=poses.dtype)
    c2w = poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], 0)
    homo = np.concatenate(
        [poses[:, :3, :4], np.broadcast_to(bottom, (poses.shape[0], 1, 4))], 1
    )
    out[:, :3, :4] = (np.linalg.inv(c2w) @ homo)[:, :3, :4]
    return out


def render_path_spiral(c2w, up, rads, focal, zrate: float, rots: float,
                       N: int) -> np.ndarray:
    """Spiral camera path around the average pose (LLFF video path)."""
    poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = c2w[:3, :4] @ (
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0])
            * rads
        )
        z = normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        poses.append(np.concatenate([viewmatrix(z, up, c), hwf], 1))
    return np.stack(poses, 0).astype(np.float32)


def spherify_poses(poses: np.ndarray, bds: np.ndarray):
    """Recenter 360-capture poses onto a sphere; produce a circular path.

    Returns (poses_reset [N,3,5], render_poses [120,3,5], bds) — parity with
    reference load_llff.py:265-333.
    """
    def p34_to_44(p):
        bottom = np.broadcast_to(
            np.eye(4, dtype=p.dtype)[-1].reshape(1, 1, 4), (p.shape[0], 1, 4)
        )
        return np.concatenate([p, bottom], 1)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    # Point minimizing distance to all camera optical axes.
    A_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b_i = -A_i @ rays_o
    pt_mindist = np.squeeze(
        -np.linalg.inv((np.transpose(A_i, [0, 2, 1]) @ A_i).mean(0)) @ b_i.mean(0)
    )

    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = normalize(up)
    vec1 = normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)

    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])

    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad**2 - zh**2)

    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = normalize(camorigin)
        vec0 = normalize(np.cross(vec2, up))
        vec1 = normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin], 1))
    new_poses = np.stack(new_poses, 0)

    hwf_bcast = np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)
    new_poses = np.concatenate([new_poses, hwf_bcast], -1)
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4],
         np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape)], -1
    )
    return poses_reset.astype(np.float32), new_poses.astype(np.float32), bds


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
