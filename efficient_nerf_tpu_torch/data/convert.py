"""Real frames -> ray shards, the part of `efficient_nerf_tpu.data.convert`
that shards frames already in memory: every frame becomes H*W rows of
[rays_o, rays_d, rgb], all rows are double-shuffled and written as
4096-row `train_{k}.npy` shards (the `train_` prefix marks REAL data for
RayShardDataset's pseudo/real mixing).

The blender, DONeRF and LLFF converters read their datasets through the
loaders, which come with them in a later slice (ROADMAP queue 1 item 3).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.rays import get_rays_np, ndc_rays
from .pseudo import SHARD_ROWS

__all__ = ["rays_to_shards"]


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
