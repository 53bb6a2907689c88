"""Real data -> ray shards, after `efficient_nerf_tpu.data.convert` (the
reference's utils/convert_original_data_to_rays_{blender,llff}.py): every
training image becomes H*W rows of [rays_o, rays_d, rgb], all rows are
double-shuffled and written as 4096-row `train_{k}.npy` shards (the
`train_` prefix marks REAL data for RayShardDataset's pseudo/real mixing).
The same seed writes the same shards as the JAX converters, byte for byte.

One deliberate divergence: `convert_llff_to_rays` defaults to raw rays
(ndc=False), where the JAX converter defaults to NDC ones. The reference
packs raw rays, and every student path of both packages samples its points
from raw rays; `ndc=True` stays available and writes the JAX default's
shards.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..core.rays import get_rays_np, ndc_rays
from .blender import composite_white, load_blender_data
from .llff import load_llff_data
from .pseudo import SHARD_ROWS

__all__ = ["rays_to_shards", "convert_blender_to_rays", "convert_llff_to_rays",
           "donerf_ray_directions", "FICUS_IGNORE"]

# The reference hard-codes this ignore list for the ficus scene (frames with
# phi >= 0; convert_original_data_to_rays_blender.py:113-114).
FICUS_IGNORE = ("10,13,14,24,26,30,31,37,39,40,41,47,48,49,52,54,55,57,58,"
                "66,67,74,75,76,77,79,81,82,87,88,89,94,97,99")


def donerf_ray_directions(H: int, W: int, camera_angle_x: float,
                          focal: float) -> np.ndarray:
    """Camera-frame ray directions in the DONeRF convention: NORMALIZED
    pixel rays built from the horizontal fov, with y and z negated
    (reference convert_original_data_to_rays_blender.py:35-57). Differs from
    the NeRF convention (unnormalized, z = -1), so shards converted for
    DONeRF scenes must use this grid."""
    x_dist = np.tan(camera_angle_x / 2) * focal
    y_dist = x_dist * (H / W)
    x_pp = x_dist / (W / 2)
    y_pp = y_dist / (H / 2)
    start = np.array([-(x_dist - x_pp / 2), -(y_dist - y_pp / 2), focal])
    d = np.broadcast_to(start, (H, W, 3)).copy()
    d[:, :, 0] += x_pp * np.arange(W)[None, :]
    d[:, :, 1] += y_pp * np.arange(H)[:, None]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    d[:, :, 1] *= -1.0
    d[:, :, 2] *= -1.0
    return d.astype(np.float32)


def rays_to_shards(rows: np.ndarray, outdir: str, prefix: str = "train_",
                   rng: Optional[np.random.Generator] = None,
                   start_index: int = 1) -> int:
    """Double-shuffle rows [N, D] and write full 4096-row shards (a
    remainder of fewer rows is dropped). Returns the number of shards
    written."""
    rng = rng or np.random.default_rng(0)
    rows = rows[rng.permutation(rows.shape[0])]
    rows = rows[rng.permutation(rows.shape[0])]
    os.makedirs(outdir, exist_ok=True)
    num = rows.shape[0] // SHARD_ROWS
    for k in range(num):
        np.save(os.path.join(outdir, f"{prefix}{start_index + k}.npy"),
                rows[k * SHARD_ROWS:(k + 1) * SHARD_ROWS].astype(np.float32))
    return num


def _pack_image_rays(H, W, focal, pose, img, ndc: bool = False) -> np.ndarray:
    """[H*W, 6 + C] rows of one frame: raw world rays and the image's
    channels (ndc=True projects the rays first, on the CPU)."""
    rays_o, rays_d = get_rays_np(H, W, focal, pose)
    if ndc:
        o, d = ndc_rays(H, W, focal, 1.0, torch.from_numpy(np.ascontiguousarray(rays_o)),
                        torch.from_numpy(np.ascontiguousarray(rays_d)))
        rays_o, rays_d = o.numpy(), d.numpy()
    return np.concatenate(
        [rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), img.reshape(-1, img.shape[-1])],
        axis=-1,
    ).astype(np.float32)


def convert_blender_to_rays(datadir: str, outdir: str, half_res: bool = True,
                            white_bkgd: bool = True, splits=("train",),
                            donerf: bool = False, ignore: str = "",
                            seed: int = 0) -> int:
    """Blender/DONeRF images -> real-ray shards train_{k}.npy; returns the
    number of shards.

    donerf=True uses the DONeRF ray-direction convention, with the fov of
    dataset_info.json where the scene has one; `ignore` drops frame indices
    (comma list; the ficus rule is FICUS_IGNORE).
    """
    data = load_blender_data(datadir, half_res=half_res, testskip=1,
                             splits=list(splits))
    H, W, focal = data.hwf
    imgs = composite_white(data.images, white_bkgd)
    poses = data.poses
    if ignore:
        ignored = set(ignore.split(","))
        keep = [i for i in range(len(imgs)) if str(i) not in ignored]
        imgs, poses = imgs[keep], poses[keep]

    if donerf:
        meta_path = os.path.join(datadir, "dataset_info.json")
        if os.path.exists(meta_path):
            with open(meta_path) as fp:
                cax = float(json.load(fp)["camera_angle_x"])
        else:
            cax = 2.0 * np.arctan(0.5 * W / focal)
        dirs = donerf_ray_directions(H, W, cax, focal)
        all_rows = []
        for p, im in zip(poses, imgs):
            rd = np.einsum("hwc,rc->hwr", dirs, p[:3, :3])
            ro = np.broadcast_to(p[:3, 3], rd.shape)
            all_rows.append(np.concatenate(
                [ro.reshape(-1, 3), rd.reshape(-1, 3),
                 im.reshape(-1, im.shape[-1])], -1).astype(np.float32))
        rows = np.concatenate(all_rows, 0)
    else:
        rows = np.concatenate(
            [_pack_image_rays(H, W, focal, p[:3, :4], im)
             for p, im in zip(poses, imgs)], 0)
    return rays_to_shards(rows, outdir, rng=np.random.default_rng(seed))


def convert_llff_to_rays(datadir: str, outdir: str, factor: int = 8,
                         llffhold: int = 8, ndc: bool = False,
                         seed: int = 0) -> int:
    """LLFF images -> real-ray shards train_{k}.npy of the training frames
    (every llffhold-th frame held out; llffhold 0 holds out the loader's
    i_test); returns the number of shards. Raw world rays by default, NDC
    rays with ndc=True (the JAX converter's default: see the module
    docstring)."""
    data = load_llff_data(datadir, factor=factor)
    H, W, focal = data.poses[0, :3, -1]
    H, W, focal = int(H), int(W), float(focal)
    i_test = (np.arange(data.images.shape[0])[::llffhold] if llffhold > 0
              else np.array([data.i_test]))
    i_train = np.array([i for i in range(data.images.shape[0])
                        if i not in i_test])
    rows = np.concatenate(
        [_pack_image_rays(H, W, focal, data.poses[i, :3, :4], data.images[i],
                          ndc=ndc) for i in i_train], 0)
    return rays_to_shards(rows, outdir, rng=np.random.default_rng(seed))
