"""Blender-synthetic (NeRF) and DONeRF dataset loading, a copy of
`efficient_nerf_tpu.data.blender` (numpy; this package must not import the
JAX one).

As the reference's dataset/load_blender.py:31-121 minus its debug side
effects (the reference unconditionally overwrites render_poses with 200
random poses and writes two scatter PDFs into CWD, load_blender.py:88-104;
here that is the opt-in `random_render_poses` flag). The PNGs are read
with the port's own codec (utils/images.read_png), since the card's machine
has no `imageio`; `cv2` is imported only to halve frames (`half_res`).

Returns plain numpy; the caller moves arrays to its device.
"""
from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np

from ..core.poses import random_spherical_pose, spherical_render_poses
from ..utils.images import read_png

__all__ = ["BlenderData", "load_blender_data", "composite_white"]


class BlenderData(NamedTuple):
    images: np.ndarray        # [N, H, W, 3 or 4] float32 in [0, 1]
    poses: np.ndarray         # [N, 4, 4]
    render_poses: np.ndarray  # [n_pose, 4, 4]
    hwf: tuple                # (H, W, focal)
    splits: tuple             # (i_train, i_val, i_test)


def _resize_half(img: np.ndarray) -> np.ndarray:
    import cv2

    H, W = img.shape[:2]
    return cv2.resize(img, (W // 2, H // 2), interpolation=cv2.INTER_AREA)


def load_blender_data(basedir: str, half_res: bool = False, testskip: int = 1,
                      n_pose: int = 40, splits: Sequence[str] = ("train", "val", "test"),
                      random_render_poses: int = 0,
                      rng: Optional[np.random.Generator] = None) -> BlenderData:
    """Load transforms_{split}.json + images.

    DONeRF-format scenes keep camera_angle_x in dataset_info.json instead of
    the transforms files (reference load_blender.py:76-81); both are read.
    """
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if (s == "train" or testskip == 0) else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            imgs.append(read_png(fname))
            poses.append(np.array(frame["transform_matrix"], np.float32))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)
        all_imgs.append(imgs)
        all_poses.append(np.array(poses, np.float32))
        counts.append(counts[-1] + len(imgs))

    i_split = tuple(np.arange(counts[i], counts[i + 1]) for i in range(len(splits)))
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    meta = metas[splits[-1]]
    if "camera_angle_x" in meta:
        camera_angle_x = float(meta["camera_angle_x"])
    else:  # DONeRF layout
        with open(os.path.join(basedir, "dataset_info.json")) as fp:
            camera_angle_x = float(json.load(fp)["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    if random_render_poses:
        rng = rng or np.random.default_rng(0)
        render_poses = np.stack(
            [random_spherical_pose(rng) for _ in range(random_render_poses)], 0
        )
    else:
        render_poses = spherical_render_poses(n_pose)

    if half_res:
        H, W, focal = H // 2, W // 2, focal / 2.0
        imgs = np.stack([_resize_half(im) for im in imgs], 0).astype(np.float32)

    return BlenderData(imgs, poses, render_poses.astype(np.float32),
                       (H, W, focal), i_split)


def composite_white(images: np.ndarray, white_bkgd: bool) -> np.ndarray:
    """RGBA -> RGB, optionally alpha-compositing onto white
    (reference main.py:933-937)."""
    if images.shape[-1] == 3:
        return images
    if white_bkgd:
        return images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
    return images[..., :3]
