"""Pseudo-data generation driver, after `efficient_nerf_tpu.create_data`
(reference utils/create_data.py parity), with its flags.

Modes (--create_data):
  rand                 shuffled 4096-ray shards [4096, 9/10/12] from random
                       poses with random focal (the main R2L recipe)
  spiral_evenly_spaced whole teacher frames at an even pose grid, appended
                       to the KD dir's transforms json (image-mode KD)
  rand_images          whole frames at random poses (image-mode KD)
  rand_tworays         adjacent-ray-pair shards [N, 1, 2, 9]
  3x3rays              3x3-patch shards [N, 3, 3, 9]
  16x16patches(_v2/_v3) 16x16-patch shards [N, 16, 16, 9] (the conv student)

--test_teacher renders the test split through the teacher first and reports
PSNR (teacher self-test, reference create_data.py:723-742); --teacher_quant
int8 renders with the int8 field eval. Every frame renders on the card
through the teacher's eval path (data/pseudo.py); the host draws poses and
shuffles from one `numpy.random.default_rng(0)` in the JAX driver's order.

Run: python -m efficient_nerf_tpu_torch.create_data --config <scene> \\
        --model_name nerf --teacher_ckpt ... --datadir_kd <name>:<dir> ...
"""
from __future__ import annotations

import os
import shutil
from types import SimpleNamespace
from typing import Optional

import numpy as np

from .config.options import parse_args
from .core.poses import novel_pose_grid, random_spherical_pose
from .data.images_dataset import append_pseudo_frames, setup_image_datadir
from .data.pseudo import (SHARD_ROWS, export_pseudo_shards,
                          make_pseudo_frame_renderer, scene_pose_sampler)
from .device import DeviceLike, resolve_device
from .evaluate import render_path
from .factory import create_models
from .main import load_scene
from .utils.logging import Logger

__all__ = ["create_data", "main"]


def _teacher_bundle(args, scene, device):
    targs = SimpleNamespace(**vars(args))
    targs.model_name = "nerf"
    targs.pretrained_ckpt = args.teacher_ckpt or args.pretrained_ckpt
    targs.resume = False
    if not targs.pretrained_ckpt:
        raise ValueError("create_data requires --teacher_ckpt")
    return create_models(targs, scene.near, scene.far, device=device)


def _prepare_dir(path: str, rm_existing: bool) -> int:
    """Returns the resume count of existing .npy files."""
    if os.path.exists(path):
        if rm_existing:
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
            os.makedirs(path)
            return 0
        return len([x for x in os.listdir(path) if x.endswith(".npy")])
    os.makedirs(path)
    return 0


def _export_patch_shards(render_frame, H, W, outdir, n_pose, patch_hw, rng,
                         use_rand_focal, i_save=20, start_split=0,
                         items_per_shard=None, max_save=0, pose_sampler=None,
                         log=print):
    """Frames -> [N, ph, pw, D] patch shards (the conv student's data)."""
    ph, pw = patch_hw
    pose_sampler = pose_sampler or random_spherical_pose
    items_per_shard = items_per_shard or max(1, SHARD_ROWS // (ph * pw))
    split, acc = start_split, []
    for i in range(1, n_pose + 1):
        pose = pose_sampler(rng)
        fs = 1.0 + rng.random() if use_rand_focal else 1.0
        img = render_frame(pose[:3, :4], fs).cpu().numpy().reshape(H, W, -1)
        for y in range(0, H - ph + 1, ph):
            for x in range(0, W - pw + 1, pw):
                acc.append(img[y:y + ph, x:x + pw])
        log(f"[{i}/{n_pose}] rendered pose, {len(acc)} patches buffered")
        if i % i_save == 0 or i == n_pose:
            rng.shuffle(acc)
            n_full = len(acc) // items_per_shard * items_per_shard
            for s in range(0, n_full, items_per_shard):
                split += 1
                idx = split % max_save if max_save > 0 else split
                np.save(os.path.join(outdir, f"data_{idx}.npy"),
                        np.stack(acc[s:s + items_per_shard]).astype(np.float32))
            acc = acc[n_full:]
    return split


def create_data(args, logger: Optional[Logger] = None, device: DeviceLike = None):
    """Run the --create_data mode on `device` (default CUDA; the CPU only
    when passed as "cpu"); returns the count of shards or frames written."""
    dev = resolve_device(device)
    logger = logger or Logger(args, basedir=args.basedir)
    log = logger.info
    rng = np.random.default_rng(0)

    scene = load_scene(args)
    H, W, focal = scene.hwf
    teacher = _teacher_bundle(args, scene, dev)
    nets = teacher.model
    coarse, fine = nets["coarse"], nets["fine"] if "fine" in nets else None
    log(f"Teacher loaded ({teacher.n_params / 1e6:.2f}M params) on {dev}")

    if args.test_teacher:
        misc = render_path(teacher, scene.poses[scene.i_test], scene.hwf,
                           model_name="nerf", gt_imgs=scene.images[scene.i_test],
                           render_factor=args.render_factor, log=log)
        log(f"[TEST TEACHER] PSNR {misc['test_psnr']:.4f} "
            f"PSNRv2 {misc['test_psnr_v2']:.4f} SSIM {misc['test_ssim']:.4f}")

    datadir_kd = args.datadir_kd.split(":")[-1]
    if not datadir_kd:
        log("No --datadir_kd given; done after teacher test.")
        return None

    n_pose = args.n_pose_kd if isinstance(args.n_pose_kd, int) else 100
    mode = args.create_data
    pose_sampler = scene_pose_sampler(args.dataset_type, scene.poses)

    if mode == "rand":
        resume = not args.rm_existing_data
        if args.rm_existing_data and os.path.exists(datadir_kd):
            shutil.rmtree(datadir_kd)
        n = export_pseudo_shards(
            coarse, fine, teacher.cfg_test, H, W, focal, outdir=datadir_kd,
            n_pose=n_pose, i_save=args.create_data_chunk,
            use_rand_focal=args.use_rand_focal, learn_depth=args.learn_depth,
            resume=resume, trans_origin=args.trans_origin, max_save=args.max_save,
            pose_sampler=pose_sampler,
            progress=lambda i, n: log(f"[{i}/{n}] teacher rendering..."), device=dev)
        log(f"Wrote {n} ray shards to {datadir_kd}")
        return n

    if mode in ("spiral_evenly_spaced", "rand_images"):
        if not os.path.exists(os.path.join(datadir_kd, "transforms_train.json")):
            setup_image_datadir(args.datadir, datadir_kd, half_res=args.half_res,
                                white_bkgd=args.white_bkgd)
            log(f"Set up image KD dir {datadir_kd}")
        if mode == "spiral_evenly_spaced":
            poses = novel_pose_grid(args.n_pose_kd or 100)
        else:
            ps = []
            for _ in range(n_pose):  # stored 4x4 homogeneous in the json
                m = np.eye(4, dtype=np.float32)
                m[:3, :4] = pose_sampler(rng)[:3, :4]
                ps.append(m)
            poses = np.stack(ps, 0)
        render_frame = make_pseudo_frame_renderer(coarse, fine, teacher.cfg_test, H, W,
                                                  focal, device=dev)
        images = []
        for i, pose in enumerate(poses):
            rows = render_frame(pose[:3, :4], 1.0).cpu().numpy()
            images.append(rows[:, 6:9].reshape(H, W, 3))
            log(f"[{i + 1}/{len(poses)}] frame rendered")
        append_pseudo_frames(datadir_kd, poses, images)
        log(f"Appended {len(images)} pseudo frames to {datadir_kd}")
        return len(images)

    patch_modes = {"rand_tworays": (1, 2), "3x3rays": (3, 3),
                   "16x16patches": (16, 16), "16x16patches_v2": (16, 16),
                   "16x16patches_v3": (16, 16)}
    if mode in patch_modes:
        start = _prepare_dir(datadir_kd, args.rm_existing_data)
        render_frame = make_pseudo_frame_renderer(
            coarse, fine, teacher.cfg_test, H, W, focal, learn_depth=args.learn_depth,
            trans_origin=args.trans_origin, device=dev)
        n = _export_patch_shards(render_frame, H, W, datadir_kd, n_pose, patch_modes[mode],
                                 rng, args.use_rand_focal, i_save=args.create_data_chunk,
                                 start_split=start,
                                 items_per_shard=args.patch_items_per_shard or None,
                                 max_save=args.max_save, pose_sampler=pose_sampler, log=log)
        log(f"Wrote {n} patch shards to {datadir_kd}")
        return n

    raise ValueError(f"unknown create_data mode {mode!r}")


def main(argv=None, device: DeviceLike = None):
    args = parse_args(argv)
    return create_data(args, device=device)


if __name__ == "__main__":
    main()
