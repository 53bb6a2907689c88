"""LLFF (forward-facing real scene) dataset loading, a copy of
`efficient_nerf_tpu.data.llff` (numpy; this package must not import the JAX
one).

As the reference's dataset/load_llff.py:336-456: poses_bounds.npy parsing,
image minification (cv2 INTER_AREA instead of shelling out to ImageMagick
`mogrify`, the same on-disk images_{factor}/ cache layout), axis
reordering, bound rescale, recentring, spherify or spiral render path.
`imageio` and `cv2` are imported when a scene is read.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

from ..core.poses import (normalize, poses_avg, recenter_poses,
                          render_path_spiral, spherify_poses)

__all__ = ["LLFFData", "load_llff_data", "minify"]


class LLFFData(NamedTuple):
    images: np.ndarray        # [N, H, W, 3] float32
    poses: np.ndarray         # [N, 3, 5]  (c2w | hwf column)
    bds: np.ndarray           # [N, 2]
    render_poses: np.ndarray  # [n_pose, 3, 5]
    i_test: int


_IMG_EXTS = (".jpg", ".jpeg", ".png", ".JPG", ".PNG")


def _list_images(d):
    return [os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.endswith(_IMG_EXTS)]


def minify(basedir: str, factor: int) -> str:
    """Create (or reuse) images_{factor}/ with 1/factor-size images."""
    import cv2
    import imageio.v2 as imageio

    outdir = os.path.join(basedir, f"images_{factor}")
    srcs = _list_images(os.path.join(basedir, "images"))
    if os.path.exists(outdir) and len(_list_images(outdir)) == len(srcs):
        return outdir
    os.makedirs(outdir, exist_ok=True)
    for src in srcs:
        img = imageio.imread(src)
        H, W = img.shape[:2]
        out = cv2.resize(img, (W // factor, H // factor),
                         interpolation=cv2.INTER_AREA)
        name = os.path.splitext(os.path.basename(src))[0] + ".png"
        imageio.imwrite(os.path.join(outdir, name), out)
    return outdir


def _load_raw(basedir: str, factor: Optional[int]):
    import imageio.v2 as imageio

    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))  # [N, 17]
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    if factor is not None and factor != 1:
        imgdir = minify(basedir, factor)
    else:
        factor = 1
        imgdir = os.path.join(basedir, "images")

    imgfiles = _list_images(imgdir)
    if poses.shape[-1] != len(imgfiles):
        raise ValueError(
            f"{len(imgfiles)} images vs {poses.shape[-1]} poses in {basedir}")

    sh = imageio.imread(imgfiles[0]).shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] / factor

    imgs = np.stack(
        [imageio.imread(f)[..., :3] / 255.0 for f in imgfiles], 0
    ).astype(np.float32)
    return poses, bds, imgs


def load_llff_data(basedir: str, factor: int = 8, recenter: bool = True,
                   bd_factor: Optional[float] = 0.75, spherify: bool = False,
                   path_zflat: bool = False, n_pose_video: int = 120) -> LLFFData:
    poses, bds, imgs = _load_raw(basedir, factor)

    # [down, right, back] -> [right, up, back] axis convention swap
    poses = np.concatenate(
        [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = poses_avg(poses)
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)

        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        # an alias, as in the JAX loader: path_zflat moves c2w too, which
        # is recomputed before i_test
        c2w_path = c2w
        N_views, N_rots = n_pose_video, 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            N_rots, N_views = 1, N_views // 2
        up = normalize(poses[:, :3, 1].sum(0))
        render_poses = render_path_spiral(c2w_path, up, rads, focal,
                                          zrate=0.5, rots=N_rots, N=int(N_views))

    c2w = poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))

    return LLFFData(imgs.astype(np.float32), poses.astype(np.float32), bds,
                    np.asarray(render_poses, np.float32), i_test)
