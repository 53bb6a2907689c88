"""Procedural synthetic scene: an analytically ray-traced shaded sphere, a
numpy copy of `efficient_nerf_tpu.data.synthetic`.

`render_sphere_frame` gives a frame in memory, which is how a teacher is
trained on the card with nothing downloaded. The two writers lay out a
blender-format (transforms_*.json + PNGs) or an LLFF-format scene on disk;
they write their PNGs with the port's own codec (utils/images.write_png),
so they run on a machine without `imageio`.
"""
from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from ..core.poses import pose_spherical
from ..core.rays import get_rays_np
from ..utils.images import write_png

__all__ = ["render_sphere_frame", "make_synthetic_scene",
           "make_forward_facing_scene", "CAMERA_ANGLE_X"]

CAMERA_ANGLE_X = 0.6911112070083618  # the classic blender-synthetic fov


def render_sphere_frame(c2w, H: int, W: int, focal: float,
                        radius: float = 1.3,
                        center=(0.0, 0.0, 0.0)) -> np.ndarray:
    """[H, W, 4] RGBA: a normal-shaded sphere on transparent background."""
    rays_o, rays_d = get_rays_np(H, W, focal, np.asarray(c2w)[:3, :4])
    o = rays_o.reshape(-1, 3) - np.asarray(center)
    d = rays_d.reshape(-1, 3)
    dn = d / np.linalg.norm(d, axis=-1, keepdims=True)

    b = np.einsum("nd,nd->n", o, dn)
    c = np.einsum("nd,nd->n", o, o) - radius ** 2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit &= t > 0

    p = o + t[:, None] * dn                      # hit point (centered)
    normal = p / radius
    # color: normal-mapped base + simple lambert toward a fixed light
    light = np.array([0.5, 0.7, 0.5])
    light = light / np.linalg.norm(light)
    lambert = np.clip(normal @ light, 0.0, 1.0)
    base = 0.5 + 0.5 * normal                    # xyz -> rgb
    rgb = base * (0.35 + 0.65 * lambert[:, None])

    img = np.zeros((H * W, 4), np.float32)
    img[hit, :3] = rgb[hit]
    img[hit, 3] = 1.0
    return img.reshape(H, W, 4)


def make_synthetic_scene(outdir: str, n_train: int = 20, n_val: int = 2,
                         n_test: int = 4, H: int = 64, W: int = 64,
                         radius: float = 1.3,
                         seed: int = 0) -> Tuple[int, int, float]:
    """Write a blender-format sphere scene; returns (H, W, focal)."""
    rng = np.random.default_rng(seed)
    focal = 0.5 * W / np.tan(0.5 * CAMERA_ANGLE_X)
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        os.makedirs(os.path.join(outdir, split), exist_ok=True)
        frames = []
        for i in range(n):
            if split == "train":
                theta = rng.uniform(-180, 180)
                phi = rng.uniform(-75, -15)
            else:  # deterministic eval poses
                theta = -180 + 360 * i / max(1, n)
                phi = -30.0
            pose = pose_spherical(theta, phi, 4.0)
            img = render_sphere_frame(pose, H, W, focal, radius=radius)
            fname = f"./{split}/r_{i}"
            write_png(os.path.join(outdir, fname + ".png"),
                      (img * 255).astype(np.uint8))
            frames.append({"file_path": fname,
                           "transform_matrix": pose.tolist()})
        with open(os.path.join(outdir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)
    return H, W, focal


def make_forward_facing_scene(outdir: str, n_images: int = 12,
                              H: int = 48, W: int = 64,
                              sphere_z: float = -4.0, radius: float = 1.2,
                              seed: int = 0) -> Tuple[int, int, float]:
    """Write an LLFF-format forward-facing sphere scene; returns (H, W, focal).

    images/*.png plus poses_bounds.npy [N, 17]: rows of a 3x5 pose (rotation
    columns stored in LLFF's [down, right, back] order, 5th column [H, W,
    focal]) and [near, far] depth bounds. Cameras sit near the origin looking
    down world -z with small x/y/z jitter.
    """
    rng = np.random.default_rng(seed)
    focal = 0.9 * W
    os.makedirs(os.path.join(outdir, "images"), exist_ok=True)
    rows = []
    center = (0.0, 0.0, sphere_z)
    for i in range(n_images):
        t = np.array([rng.uniform(-0.4, 0.4), rng.uniform(-0.3, 0.3),
                      rng.uniform(0.0, 0.2)], np.float32)
        # camera axes in world frame: x=right, y=up, z=back (looks down -z)
        c2w = np.concatenate([np.eye(3, dtype=np.float32), t[:, None]], 1)
        img = render_sphere_frame(c2w, H, W, focal, radius=radius,
                                  center=center)
        rgb = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])  # white bg
        write_png(os.path.join(outdir, "images", f"img_{i:03d}.png"),
                  (rgb * 255).astype(np.uint8))
        # invert the loader's column swap [down,right,back]->[right,up,back]:
        # store columns [-y, x, z]
        stored = np.stack([-c2w[:, 1], c2w[:, 0], c2w[:, 2], c2w[:, 3],
                           np.array([H, W, focal], np.float32)], 1)  # [3, 5]
        near = abs(sphere_z) - radius - 0.6
        far = abs(sphere_z) + radius + 0.6
        rows.append(np.concatenate([stored.reshape(-1), [near, far]]))
    np.save(os.path.join(outdir, "poses_bounds.npy"),
            np.stack(rows, 0).astype(np.float64))
    return H, W, focal
