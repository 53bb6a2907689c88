"""DeepVoxels dataset loading, a copy of `efficient_nerf_tpu.data.deepvoxels`
(the reference's dataset/load_deepvoxels.py; numpy).

Layout: {basedir}/{split}/{scene}/ with intrinsics.txt, pose/*.txt and
rgb/*.png; 512x512 frames; poses stored c2w with y/z flipped relative to the
NeRF convention. The PNGs are read with the port's own codec
(utils/images.read_png).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from ..utils.images import read_png

__all__ = ["DeepVoxelsData", "load_dv_data"]


class DeepVoxelsData(NamedTuple):
    images: np.ndarray
    poses: np.ndarray
    render_poses: np.ndarray
    hwf: tuple
    splits: tuple


def _parse_intrinsics(path: str, trgt_sidelength: int):
    with open(path) as f:
        f_, cx, cy = list(map(float, f.readline().split()))[:3]
        f.readline()  # grid barycenter
        near_plane = float(f.readline())
        f.readline()  # scale
        height, width = map(float, f.readline().split())
    focal = trgt_sidelength / height * f_
    return focal, near_plane


def _load_poses(posedir: str) -> np.ndarray:
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    poses = []
    for fname in sorted(os.listdir(posedir)):
        if not fname.endswith("txt"):
            continue
        nums = np.array(
            [float(x) for x in open(os.path.join(posedir, fname)).read().split()]
        ).reshape(4, 4)
        poses.append((nums @ flip)[:3, :4].astype(np.float32))
    return np.stack(poses, 0)


def _load_rgb(imgdir: str, skip: int = 1) -> np.ndarray:
    files = [f for f in sorted(os.listdir(imgdir)) if f.endswith("png")]
    return np.stack(
        [read_png(os.path.join(imgdir, f)) / 255.0 for f in files[::skip]],
        0,
    ).astype(np.float32)


def load_dv_data(scene: str = "cube", basedir: str = "/data/deepvoxels",
                 testskip: int = 8) -> DeepVoxelsData:
    H = W = 512
    base = os.path.join(basedir, "train", scene)
    focal, _ = _parse_intrinsics(os.path.join(base, "intrinsics.txt"), H)

    poses = _load_poses(os.path.join(base, "pose"))
    testposes = _load_poses(os.path.join(basedir, "test", scene, "pose"))[::testskip]
    valposes = _load_poses(
        os.path.join(basedir, "validation", scene, "pose"))[::testskip]

    imgs = _load_rgb(os.path.join(base, "rgb"))
    testimgs = _load_rgb(os.path.join(basedir, "test", scene, "rgb"), testskip)
    valimgs = _load_rgb(os.path.join(basedir, "validation", scene, "rgb"),
                        testskip)

    all_imgs = [imgs, valimgs, testimgs]
    counts = np.cumsum([0] + [x.shape[0] for x in all_imgs])
    i_split = tuple(np.arange(counts[i], counts[i + 1]) for i in range(3))

    return DeepVoxelsData(
        np.concatenate(all_imgs, 0),
        np.concatenate([poses, valposes, testposes], 0),
        testposes, (H, W, focal), i_split,
    )
