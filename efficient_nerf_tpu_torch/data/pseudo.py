"""Teacher -> student pseudo-data generation, after
`efficient_nerf_tpu.data.pseudo`.

The teacher renders frames on the device (a random pose and a random focal
in [1, 2) times the base focal); the rows [rays_o, rays_d, rgb(, depth |
surface)] go into a host-side streaming shuffle buffer that student batches
are drawn from, or are written as the reference's 4096-row .npy shards.

One-frame pipeline: frame k+1's render is queued on the card before frame
k's rows are read on the host. Each frame's rows are copied into pinned host
memory with a non-blocking copy, an event is recorded after the copy, and
the host waits on that event only when it needs the rows, so the copy and
the host's shuffling overlap the next render.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.poses import make_llff_pose_sampler, random_spherical_pose
from ..core.rays import apply_trans_origin, get_rays, ndc_rays
from ..device import DeviceLike, resolve_device, to_device
from ..render.renderer import RenderConfig, render_chunks

__all__ = ["make_pseudo_frame_renderer", "ShuffleBuffer",
           "StreamingPseudoGenerator", "export_pseudo_shards",
           "scene_pose_sampler", "SHARD_ROWS"]

SHARD_ROWS = 4096
_ROW_DIM = {"": 9, "depth": 10, "surface": 12}


def scene_pose_sampler(dataset_type: str, poses=None, radius: float = 4.0):
    """Pseudo-data pose distribution per dataset family: rng -> c2w.

    blender / deepvoxels: uniform spherical orbit. llff: bbox-random
    forward-facing poses derived from the capture's own cameras.
    """
    if dataset_type == "llff":
        if poses is None:
            raise ValueError(
                "llff pseudo-data pose sampling needs the capture poses")
        return make_llff_pose_sampler(poses)
    return lambda rng: random_spherical_pose(rng, radius=radius)


def make_pseudo_frame_renderer(model, model_fine, cfg: RenderConfig, H: int,
                               W: int, focal: float, learn_depth: str = "",
                               trans_origin: str = "",
                               device: DeviceLike = None):
    """(c2w, focal_scale) -> [H*W, D] teacher rows on `device` (default
    CUDA), rendered with cfg.eval_mode() in chunks of cfg.chunk rays.

    D = 9, or 10 with learn_depth='depth', or 12 with 'surface' (the
    reference shard format). trans_origin applies the reference's origin
    translation modes to every generated ray. The focal scale takes the JAX
    package's traced-scale branch of get_rays (pixel directions at the base
    focal, x and y divided by the f32 scale), as its jitted renderer does.

    cfg.ndc (LLFF forward-facing scenes): the render uses NDC rays, projected
    with the BASE focal even under a random focal scale (as the reference
    does), and viewdirs normalized from the world directions before the
    projection; the rows keep the raw world rays.
    """
    if learn_depth not in _ROW_DIM:
        raise ValueError(f"unknown learn_depth {learn_depth!r}")
    dev = resolve_device(device)
    ecfg = cfg.eval_mode()

    def fn(c2w, focal_scale) -> torch.Tensor:
        # pinned and non-blocking: the host queues the frame without waiting
        # for the card to drain (a pageable copy would wait)
        fs = to_device(np.float32(focal_scale), dev)
        rays_o, rays_d = get_rays(H, W, focal, c2w, focal_scale=fs, device=dev)
        rays_o = rays_o.reshape(-1, 3)
        rays_d = rays_d.reshape(-1, 3)
        rays_o = apply_trans_origin(rays_o, rays_d, trans_origin)
        viewdirs = None
        if ecfg.use_viewdirs:
            viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        if ecfg.ndc:
            render_o, render_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
        else:
            render_o, render_d = rays_o, rays_d
        res = render_chunks(model, model_fine, render_o.contiguous(),
                            render_d.contiguous(), viewdirs, ecfg)
        cols = [rays_o, rays_d, res.rgb]
        if learn_depth == "depth":
            cols.append(res.depth[:, None])
        elif learn_depth == "surface":
            cols.append(rays_o + rays_d * res.depth[:, None])
        return torch.cat(cols, dim=-1)

    return fn


class ShuffleBuffer:
    """Fixed-capacity streaming shuffle of rows (host-side numpy).

    add() fills until capacity, then overwrites uniformly-random rows;
    sample() draws uniform rows. Together these approximate the reference's
    global double-shuffle over all generated rays at O(capacity) memory.
    """

    def __init__(self, capacity: int, row_dim: int,
                 rng: Optional[np.random.Generator] = None):
        self.buf = np.empty((capacity, row_dim), np.float32)
        self.size = 0
        self.rng = rng or np.random.default_rng()

    def add(self, rows: np.ndarray):
        n = rows.shape[0]
        cap = self.buf.shape[0]
        if self.size < cap:
            take = min(n, cap - self.size)
            self.buf[self.size:self.size + take] = rows[:take]
            self.size += take
            rows = rows[take:]
            n = rows.shape[0]
        if n > 0:
            idx = self.rng.choice(cap, size=n, replace=False) if n <= cap \
                else self.rng.integers(0, cap, size=n)
            self.buf[idx] = rows

    def sample(self, n: int) -> np.ndarray:
        if self.size == 0:
            raise RuntimeError("empty shuffle buffer")
        idx = self.rng.integers(0, self.size, size=n)
        return self.buf[idx]


class _HostRows:
    """A frame's rows on their way to the host: on a card, a non-blocking
    copy into pinned memory and an event recorded after it; `numpy()` waits
    on that event only."""

    def __init__(self, rows: torch.Tensor):
        if rows.is_cuda:
            self.host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
            self.host.copy_(rows, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = rows, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class StreamingPseudoGenerator:
    """Endless student batches straight from the teacher on the card.

    frames_per_batch controls the refresh rate: how many new teacher frames
    are rendered per emitted batch (fractional allowed, e.g. 0.25 = one new
    frame every 4 batches). pose_sampler: rng -> [3, >= 4] c2w (default the
    blender orbit; LLFF scenes pass `make_llff_pose_sampler(poses)`).
    Batches are numpy (rays_o, rays_d, target) arrays.
    """

    def __init__(self, model, model_fine, cfg: RenderConfig, H: int, W: int,
                 focal: float, *, batch_rays: int, buffer_rays: int = 2_000_000,
                 warmup_frames: int = 4, frames_per_batch: float = 0.5,
                 use_rand_focal: bool = True, learn_depth: str = "",
                 radius: float = 4.0, trans_origin: str = "", pose_sampler=None,
                 rng: Optional[np.random.Generator] = None,
                 device: DeviceLike = None):
        self.render_frame = make_pseudo_frame_renderer(
            model, model_fine, cfg, H, W, focal, learn_depth, trans_origin,
            device=device)
        self.H, self.W = H, W
        self.batch_rays = batch_rays
        self.use_rand_focal = use_rand_focal
        self.radius = radius
        self.pose_sampler = pose_sampler or (
            lambda r: random_spherical_pose(r, radius=self.radius))
        self.rng = rng or np.random.default_rng(0)
        self.buffer = ShuffleBuffer(buffer_rays, _ROW_DIM[learn_depth], self.rng)
        self.frames_per_batch = frames_per_batch
        self._debt = 0.0
        self.frames_rendered = 0
        self._pending: Optional[_HostRows] = None
        for _ in range(warmup_frames):
            self._render_one()

    def _render_one(self):
        pose = self.pose_sampler(self.rng)
        fs = 1.0 + self.rng.random() if self.use_rand_focal else 1.0
        rows = _HostRows(self.render_frame(pose[:3, :4], fs))  # queued
        if self._pending is not None:
            self.buffer.add(self._pending.numpy())
        self._pending = rows
        self.frames_rendered += 1

    def _flush(self):
        if self._pending is not None:
            self.buffer.add(self._pending.numpy())
            self._pending = None

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        return self

    def __next__(self):
        self._debt += self.frames_per_batch
        while self._debt >= 1.0:
            self._render_one()
            self._debt -= 1.0
        if self.buffer.size == 0:
            self._flush()
        rows = self.buffer.sample(self.batch_rays)
        return rows[:, :3], rows[:, 3:6], rows[:, 6:]


def export_pseudo_shards(model, model_fine, cfg: RenderConfig, H: int, W: int,
                         focal: float, outdir: str, n_pose: int, *,
                         i_save: int = 100, use_rand_focal: bool = True,
                         learn_depth: str = "", resume: bool = True,
                         radius: float = 4.0, trans_origin: str = "",
                         max_save: int = 0, pose_sampler=None, seed: int = 0,
                         progress=None, device: DeviceLike = None) -> int:
    """Write reference-format pseudo shards data_{k}.npy (4096 rows each);
    returns the last shard index.

    Every i_save poses the accumulated rows are double-shuffled and flushed
    as full 4096-row shards; an existing directory resumes by counting its
    .npy files. max_save > 0 bounds the shard count by wrapping the index (a
    ring of files that newer shards overwrite).
    """
    rng = np.random.default_rng(seed)
    pose_sampler = pose_sampler or (
        lambda r: random_spherical_pose(r, radius=radius))
    render_frame = make_pseudo_frame_renderer(model, model_fine, cfg, H, W,
                                              focal, learn_depth, trans_origin,
                                              device=device)
    os.makedirs(outdir, exist_ok=True)
    split = len([x for x in os.listdir(outdir) if x.endswith(".npy")]) \
        if resume else 0

    acc = []
    pending: Optional[_HostRows] = None  # the one-frame pipeline
    for i in range(1, n_pose + 1):
        pose = pose_sampler(rng)
        fs = 1.0 + rng.random() if use_rand_focal else 1.0
        rows = _HostRows(render_frame(pose[:3, :4], fs))
        if pending is not None:
            acc.append(pending.numpy())
        pending = rows
        if progress is not None:
            progress(i, n_pose)
        if i % i_save == 0 or i == n_pose:
            acc.append(pending.numpy())   # drain the pipeline at the
            pending = None                # shard boundary
            data = np.concatenate(acc, 0)
            data = data[rng.permutation(data.shape[0])]
            data = data[rng.permutation(data.shape[0])]
            num = data.shape[0] // SHARD_ROWS
            for k in range(num):
                split += 1
                idx = split % max_save if max_save > 0 else split
                np.save(os.path.join(outdir, f"data_{idx}.npy"),
                        data[k * SHARD_ROWS:(k + 1) * SHARD_ROWS])
            acc = []
    return split
