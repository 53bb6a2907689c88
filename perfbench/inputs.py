"""What the benchmark makes from the seed and hands to the program and the
reference alike: sub-seeds, camera poses, frames and ray shards."""
from __future__ import annotations

import math
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from .reference._plain import get_rays

_FLIP = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32)


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed of its own for each stream of draws from one seed."""
    state = np.random.SeedSequence([seed % 2 ** 64, *stream]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def torch_generator(seed: int, device: torch.device, *stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *stream))


def numpy_rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *stream))


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """4x4 camera-to-world looking at the origin (the blender orbit)."""
    def rot(axis: Tuple[int, int], a: float) -> np.ndarray:
        m = np.eye(4, dtype=np.float32)
        c, s = np.cos(a), np.sin(a)
        i, j = axis
        m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
        return m

    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = radius
    c2w = rot((1, 2), phi_deg / 180.0 * np.pi) @ c2w
    c2w = rot((0, 2), theta_deg / 180.0 * np.pi) @ c2w
    return (_FLIP @ c2w).astype(np.float32)


def random_orbit_pose(rng: np.random.Generator, radius: float) -> np.ndarray:
    """theta uniform in [-180, 180), phi in [-90, 0)."""
    return pose_spherical(rng.uniform(-180.0, 180.0), rng.uniform(-90.0, 0.0), radius)


def focal_of(traffic: Dict) -> float:
    return 0.5 * traffic["W"] / math.tan(0.5 * traffic["camera_angle_x"])


def write_shards(directory: str, traffic: Dict, seed: int, device: torch.device) -> List[str]:
    """traffic['shards'] files of traffic['shard_rows'] rows [rays_o, rays_d,
    rgb] in the reference's .npy format: the rays of random orbit cameras at
    a random focal scale in [1, 2), shuffled, and rgb uniform in [0, 1)."""
    n_rows = traffic["shards"] * traffic["shard_rows"]
    H, W, focal = traffic["H"], traffic["W"], focal_of(traffic)
    rng, gen = numpy_rng(seed, 3), torch_generator(seed, device, 3)
    rays, have = [], 0
    while have < n_rows:
        o, d = get_rays(random_orbit_pose(rng, traffic["radius"]), H, W, focal, device,
                        1.0 + rng.random())
        rays.append(torch.cat([o, d], -1))
        have += o.shape[0]
    rays = torch.cat(rays)[:n_rows]
    rays = rays[torch.randperm(n_rows, generator=gen, device=device)]
    rows = torch.cat([rays, torch.rand((n_rows, 3), generator=gen, device=device)], -1)
    rows = rows.cpu().numpy().reshape(traffic["shards"], traffic["shard_rows"], 9)
    paths = []
    for k, shard in enumerate(rows):
        paths.append(os.path.join(directory, f"data_{k}.npy"))
        np.save(paths[-1], shard)
    return paths
