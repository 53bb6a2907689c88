"""Training / rendering / benchmark / export driver, after
`efficient_nerf_tpu.main`, with its flags.

Modes: train, --render_only [--render_test], --benchmark, --convert_to_onnx
(a `torch.export` program, as the JAX driver exports StableHLO instead of
ONNX), --test_pretrained, for both model families (--model_name nerf | R2L,
and the conv student with --data_mode patches). Input pipelines: .npy ray
or patch shards (ShardLoader's threads), the image-mode KD dataset, or
--stream_pseudo_data (the teacher on the card, no files).

Host draws come from one `numpy.random.default_rng(0)` threaded in the JAX
driver's order (batch order, pixel choice, shard order, poses), so that with
the same flags and initial checkpoint both drivers see the same batches;
device draws (perturbed sampling, hard-pool picks, sigma noise) from one
`torch.Generator` seeded once in `train`. `--no_pallas` is passed down to
the renderers and steps as the switch that takes their unfused `nn.Module`
paths (no kernel launch); there is no environment variable. A kernel that
fails to build or launch raises. Checkpoints are written in the reference
`.tar` layout; --pretrained_ckpt, --resume and --teacher_ckpt also read the
reference's own `.tar` and the JAX package's ENTPUCK1 files
(train/checkpoints.py).

Run: python -m efficient_nerf_tpu_torch.main --config <scene.txt> [flags]
"""
from __future__ import annotations

import math
import os
import signal
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .config.options import parse_args
from .core.poses import novel_pose_grid
from .core.rays import get_rays, get_rays_np
from .data.blender import composite_white, load_blender_data
from .data.deepvoxels import load_dv_data
from .data.images_dataset import ImageFrameDataset, pseudo_ratio_schedule
from .data.llff import load_llff_data
from .data.rays_dataset import RayShardDataset, ShardLoader, infinite_indices
from .device import DeviceLike, resolve_device, to_device
from .evaluate import load_given_rays, render_path
from .factory import Bundle, create_models
from .models import R2LConvNet
from .render.r2l_renderer import (calibrate_serving_scales, r2l_forward_rays,
                                  r2l_render_image)
from .train.checkpoints import load_checkpoint, save_checkpoint
from .train.hard_mining import hard_pool_init
from .train.steps import (init_train_state, make_patch_train_step,
                          make_r2l_train_step, make_teacher_train_step)
from .utils.benchmark import frame_time
from .utils.images import save_video
from .utils.logging import Logger
from .utils.meters import AverageMeter, LossLine, Timer

__all__ = ["train", "main", "load_scene"]


def load_scene(args):
    """Load the dataset named by args; returns a SimpleNamespace with
    images/poses/render_poses/hwf/splits/near/far (reference
    main.py:888-954)."""
    if args.dataset_type == "llff":
        d = load_llff_data(args.datadir, args.factor, recenter=True,
                           bd_factor=0.75, spherify=args.spherify,
                           n_pose_video=args.n_pose_video
                           if isinstance(args.n_pose_video, int) else 120)
        hwf = d.poses[0, :3, -1]
        poses = d.poses[:, :3, :4]
        i_test = (np.arange(d.images.shape[0])[::args.llffhold]
                  if args.llffhold > 0 else np.array([d.i_test]))
        i_val = i_test
        i_train = np.array([i for i in range(d.images.shape[0]) if i not in i_test])
        if args.no_ndc:
            near, far = float(d.bds.min()) * 0.9, float(d.bds.max())
        else:
            near, far = 0.0, 1.0
        images, poses_all, render_poses = d.images, poses, d.render_poses
    elif args.dataset_type == "blender":
        n_pose = args.n_pose_video if isinstance(args.n_pose_video, int) else 40
        d = load_blender_data(args.datadir, args.half_res, args.testskip, n_pose=n_pose)
        images = composite_white(d.images, args.white_bkgd)
        poses_all = d.poses[:, :3, :4]
        render_poses = d.render_poses
        hwf = d.hwf
        i_train, i_val, i_test = d.splits
        near, far = 2.0, 6.0
    elif args.dataset_type == "deepvoxels":
        d = load_dv_data(scene=args.shape, basedir=args.datadir, testskip=args.testskip)
        images, poses_all, render_poses = d.images, d.poses, d.render_poses
        hwf = d.hwf
        i_train, i_val, i_test = d.splits
        hemi_r = float(np.mean(np.linalg.norm(poses_all[:, :3, -1], axis=-1)))
        near, far = hemi_r - 1.0, hemi_r + 1.0
    else:
        raise ValueError(f"unknown dataset_type {args.dataset_type}")

    if getattr(args.trial, "ON", False) and args.trial.near > 0:
        near, far = args.trial.near, args.trial.far

    H, W, focal = hwf
    H, W, focal = int(H), int(W), float(focal)
    if args.focal_scale > 0:
        focal *= args.focal_scale
    return SimpleNamespace(images=np.asarray(images), poses=np.asarray(poses_all),
                           render_poses=np.asarray(render_poses), hwf=(H, W, focal),
                           i_train=np.asarray(i_train), i_val=np.asarray(i_val),
                           i_test=np.asarray(i_test), near=near, far=far)


def _select_coords(rng, H, W, n_rand, mode, precrop_frac=None):
    """Pixel-coordinate sampling (reference main.py:1264-1302): the precrop
    warmup restricts the coordinate GRID, then get_selected_coords applies
    the select_pixel_mode within it — so rand_patch yields a contiguous
    patch inside the cropped grid, sized from the cropped dims
    (helpers.py:385-405)."""
    y0, x0, gh, gw = 0, 0, H, W
    if precrop_frac is not None:
        dH, dW = int(H // 2 * precrop_frac), int(W // 2 * precrop_frac)
        y0, x0 = H // 2 - dH, W // 2 - dW
        gh, gw = 2 * dH, 2 * dW
    if n_rand > gh * gw:
        raise ValueError(f"N_rand {n_rand} exceeds the "
                         f"{'precropped ' if precrop_frac else ''}grid {gh}x{gw}")
    if mode == "rand_patch":
        k = math.sqrt(float(n_rand) / gh / gw)
        ph, pw = int(gh * k), int(gw * k)
        py = y0 + int(rng.integers(0, gh - ph + 1))
        px = x0 + int(rng.integers(0, gw - pw + 1))
        ys, xs = np.meshgrid(np.arange(py, py + ph), np.arange(px, px + pw), indexing="ij")
        return np.stack([ys, xs], -1).reshape(-1, 2)
    idx = rng.choice(gh * gw, size=n_rand, replace=False)
    return np.stack([y0 + idx // gw, x0 + idx % gw], -1)


def _export(bundle: Bundle, logger) -> str:
    """--convert_to_onnx: export the student's forward with torch.export
    (the batch dimension dynamic), save it, reload it, and hold the
    reloaded program against eager at the JAX driver's tolerance (rtol
    1e-3, atol 1e-5) on a 65,536-ray batch."""
    model, dev = bundle.model, bundle.device
    B = 256 * 256
    if isinstance(model, R2LConvNet):
        shape = (B // 256, 16, 16, bundle.input_dim)   # 256 patches of 16x16
    else:
        shape = (B, bundle.input_dim)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(np.float32) * 0.1)
    x = x.to(dev)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            batch = torch.export.Dim("batch")
            exported = torch.export.export(model, (x,), dynamic_shapes=({0: batch},))
            path = os.path.join(logger.weights_path, "model.pt2")
            torch.export.save(exported, path)
            got = torch.export.load(path).module()(x)
            want = model(x)
    finally:
        model.train(was_training)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=1e-3, atol=1e-5)
    logger.info(f"Exported + verified torch.export program at {path}")
    return path


def _benchmark(args, bundle: Bundle, video_poses, hwf, near, far, log) -> float:
    """--benchmark: the student's full frame timed by utils.benchmark
    (CUDA events around each frame, after warm-up, on inputs varied from
    frame to frame)."""
    if args.model_name == "nerf":
        raise ValueError("--benchmark times the R2L student's frame; model_name is nerf")
    H, W, focal = hwf
    model, dev = bundle.model, bundle.device
    allow_fused = not args.no_pallas
    c2w = np.asarray(video_poses[0])[:3, :4].astype(np.float32)
    quant = args.inference_quant
    if isinstance(model, R2LConvNet):
        # the conv student's served program is the full-frame conv apply
        def frame(eps):
            return r2l_render_image(model, c2w + eps, H, W, focal, near, far,
                                    args.n_sample_per_ray, L=args.multires,
                                    allow_fused=allow_fused, device=dev)
    else:
        rays_o, rays_d = get_rays(H, W, focal, c2w, device=dev)
        rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        act_scales = None
        if quant == "int8":
            act_scales = calibrate_serving_scales(model, rays_o, rays_d, near, far,
                                                  args.n_sample_per_ray, L=args.multires,
                                                  device=dev)

        def frame(eps):
            return r2l_forward_rays(model, rays_o + eps, rays_d, near, far,
                                    args.n_sample_per_ray, L=args.multires,
                                    plucker=args.plucker, quant=quant,
                                    act_scales=act_scales, allow_fused=allow_fused,
                                    device=dev)

    dt, spread = frame_time(frame, dev)
    log(f"[BENCH] frame {dt * 1e3:.3f}ms  {H * W / dt / 1e6:.2f}M rays/s"
        f"  (middle-half spread {spread:.1f}%, {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'})")
    return dt


def train(args, logger: Optional[Logger] = None, max_iters: Optional[int] = None,
          device: DeviceLike = None):
    """Run the mode args name on `device` (default CUDA; the CPU only when
    passed as "cpu"). Returns the TrainState of a training run, the
    render_path result of --render_only, the export's path or the benchmark's
    seconds per frame."""
    dev = resolve_device(device)
    logger = logger or Logger(args, basedir=args.basedir)
    log = logger.info
    guard = _PreemptionGuard()  # installed before set-up
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)

    scene = load_scene(args)
    H, W, focal = scene.hwf
    near, far = scene.near, scene.far
    log(f"Loaded {args.dataset_type}: images {scene.images.shape} "
        f"hwf {scene.hwf} near/far {near}/{far}")

    bundle = create_models(args, near, far, device=dev)
    log(f"Created model {args.model_name}: params {bundle.n_params / 1e6:.3f}M "
        f"FLOPs/pixel {bundle.flops_per_pixel / 1e6:.3f}M on {dev}")

    test_poses = scene.poses[scene.i_test]
    test_images = scene.images[scene.i_test]
    if args.dataset_type == "blender":
        video_poses = novel_pose_grid(args.n_pose_video or 40)
    else:
        video_poses = scene.render_poses

    rp_kwargs = dict(model_name="nerf" if args.model_name == "nerf" else "r2l",
                     n_sample_per_ray=args.n_sample_per_ray,
                     multires=args.multires, plucker=args.plucker,
                     render_factor=args.render_factor,
                     flip_reference_domain=args.flip_reference_domain,
                     quant=args.inference_quant, allow_fused=not args.no_pallas, log=log)
    if args.given_render_path_rays:
        go, gd, ggt = load_given_rays(args.given_render_path_rays)
        rp_kwargs["given_rays"] = (go, gd)
        if ggt is not None:
            test_images = ggt
        log(f'Using given render-path rays: "{args.given_render_path_rays}" '
            f'({len(go)} frames)')

    try:
        # ---- non-training modes ---------------------------------------------
        if args.test_pretrained:
            misc = render_path(bundle, test_poses, scene.hwf, gt_imgs=test_images, **rp_kwargs)
            log(f"Pretrained test: TestLoss {misc['test_loss']:.4f} "
                f"TestPSNR {misc['test_psnr']:.4f} TestPSNRv2 {misc['test_psnr_v2']:.4f}")

        if args.render_only:
            t0 = time.time()
            if args.render_test:
                misc = render_path(bundle, test_poses, scene.hwf, gt_imgs=test_images,
                                   savedir=logger.gen_img_path, **rp_kwargs)
                log(f"[TEST] PSNR {misc['test_psnr']:.4f} PSNRv2 {misc['test_psnr_v2']:.4f} "
                    f"SSIM {misc['test_ssim']:.4f} LPIPS {misc['test_lpips']:.4f} "
                    f"FLIP {misc['test_flip']:.4f}")
            else:
                misc = render_path(bundle, video_poses, scene.hwf, **rp_kwargs)
            video_path = save_video(os.path.join(
                logger.gen_img_path, f"video_{logger.ExpID}_{args.video_tag}.mp4"), misc["rgbs"])
            log(f"Saved video {video_path} (total {time.time() - t0:.1f}s)")
            return misc

        if args.convert_to_onnx:
            return _export(bundle, logger)

        if args.benchmark:
            return _benchmark(args, bundle, video_poses, scene.hwf, near, far, log)

        # ---- training -------------------------------------------------------
        n_iters = max_iters or args.N_iters
        loop = _train_nerf if args.model_name == "nerf" else _train_r2l
        return loop(args, logger, scene, bundle, n_iters, rng, gen, rp_kwargs,
                    test_poses, test_images, video_poses, guard)
    finally:
        guard.restore()


class _PreemptionGuard:
    """Checkpoint-on-preemption: SIGTERM/SIGINT set a flag; the train loop
    saves and exits cleanly at the next step boundary. (The reference has no
    preemption handling at all — recovery is manual --resume, SURVEY §5.)"""

    def __init__(self):
        self.fired = False
        self._prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):  # non-main thread
                pass

    def _handler(self, signum, frame):
        self.fired = True

    def restore(self):
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev = {}


def _model_config(args) -> dict:
    """Arch metadata stored in checkpoints so tools (the streaming
    teacher loader) can rebuild the model without the original flags."""
    return {
        "model_name": args.model_name,
        "netdepth": args.netdepth, "netwidth": args.netwidth,
        "netdepth_fine": args.netdepth_fine, "netwidth_fine": args.netwidth_fine,
        "use_viewdirs": bool(args.use_viewdirs),
        "multires": args.multires, "multires_views": args.multires_views,
        "N_samples": args.N_samples, "N_importance": args.N_importance,
        "n_sample_per_ray": args.n_sample_per_ray,
        "skips": str(args.skips),
        "use_residual": bool(args.use_residual),
        "linear_tail": bool(args.linear_tail),
        "white_bkgd": bool(args.white_bkgd),
    }


def _save(args, logger, name, state, best_psnr, best_psnr_step, step) -> str:
    return save_checkpoint(os.path.join(logger.weights_path, name), state.model,
                           state.optimizer, step, best_psnr, best_psnr_step,
                           model_config=_model_config(args))


def _periodic(args, logger, bundle, state, step, hist_psnr, best_psnr, best_psnr_step,
              rp_kwargs, test_poses, test_images, video_poses, scene, timer):
    """i_testset / i_video / i_weights handling; returns the updated best
    PSNR and its step."""
    log = logger.info
    if step % args.i_testset == 0:
        testsavedir = os.path.join(logger.gen_img_path, f"testset_{logger.ExpID}_iter{step}")
        misc = render_path(bundle, test_poses, scene.hwf, gt_imgs=test_images,
                           savedir=testsavedir, **rp_kwargs)
        if misc["test_psnr_v2"] > best_psnr:
            best_psnr, best_psnr_step = misc["test_psnr_v2"], step
            _save(args, logger, "ckpt_best.tar", state, best_psnr, best_psnr_step, step)
        log(f"[TEST] Iter {step} TestPSNR {misc['test_psnr']:.4f} "
            f"TestPSNRv2 {misc['test_psnr_v2']:.4f} "
            f"BestPSNRv2 {best_psnr:.4f} (Iter {best_psnr_step}) "
            f"TestSSIM {misc['test_ssim']:.4f} TestFLIP {misc['test_flip']:.4f} "
            f"TrainHistPSNR {hist_psnr:.4f}")
        log(f"Predicted finish time: {timer()}")
    if step % args.i_video == 0:
        misc = render_path(bundle, video_poses, scene.hwf, **rp_kwargs)
        vp = save_video(os.path.join(
            logger.gen_img_path, f"video_{logger.ExpID}_iter{step}_{args.video_tag}.mp4"),
            misc["rgbs"])
        log(f"[VIDEO] saved {vp}")
    if step % args.i_weights == 0:
        name = f"ckpt_{step}.tar" if args.save_intermediate_models else "ckpt.tar"
        path = _save(args, logger, name, state, best_psnr, best_psnr_step, step)
        log(f"Iter {step} saved checkpoint {path}")
    return best_psnr, best_psnr_step


class _StepClock:
    """ms a step between two reads of a step's metrics (each read waits for
    the card): the time of every step in between, data included."""

    def __init__(self):
        self.t, self.i = None, None

    def mark(self, i: int) -> Optional[float]:
        now = time.perf_counter()
        ms = None if self.t is None else (now - self.t) / (i - self.i) * 1e3
        self.t, self.i = now, i
        return ms


def _init_state(bundle: Bundle):
    state = init_train_state(bundle.model, bundle.optimizer)
    if bundle.restored_opt_state is not None:
        bundle.optimizer.load_state_dict(bundle.restored_opt_state)
    return state._replace(step=bundle.history["start"])


def _preempted(args, logger, state, best_psnr, best_psnr_step, i) -> None:
    path = _save(args, logger, "ckpt_preempt.tar", state, best_psnr, best_psnr_step, i - 1)
    logger.info(f"Preemption signal: saved {path} at iter {i - 1}")


def _train_nerf(args, logger, scene, bundle, n_iters, rng, gen, rp_kwargs,
                test_poses, test_images, video_poses, guard):
    log, dev = logger.info, bundle.device
    H, W, focal = scene.hwf
    nets = bundle.model
    # raw world rays in; the step projects to NDC itself (viewdirs from the
    # pre-NDC dirs), like the reference feeds render() (main.py:148-162)
    step_fn = make_teacher_train_step(nets["coarse"], nets["fine"] if "fine" in nets else None,
                                      bundle.optimizer, bundle.cfg_train, hwf=(H, W, focal),
                                      schedule=bundle.schedule, device=dev)
    state = _init_state(bundle)
    start = state.step
    best_psnr, best_psnr_step = bundle.history["best_psnr"], bundle.history["best_psnr_step"]

    use_batching = not args.no_batching
    if use_batching:
        # pre-shuffled rays over all train images (reference main.py:1135-1162)
        rays = np.stack([np.stack(get_rays_np(H, W, focal, p), 0)
                         for p in scene.poses[scene.i_train]], 0)
        rgb = scene.images[scene.i_train][:, None]
        rays_rgb = np.concatenate([rays, rgb], 1)       # [N, 3, H, W, 3]
        rays_rgb = rays_rgb.transpose(0, 2, 3, 1, 4).reshape(-1, 3, 3)
        rng.shuffle(rays_rgb)
        i_batch = 0

    timer = Timer(max(1, (n_iters - start) // args.i_testset))
    batch_time = AverageMeter("batch", ":.4f")
    clock = _StepClock()
    hist_psnr = 0.0
    for i in range(start + 1, n_iters + 1):
        if guard.fired:
            _preempted(args, logger, state, best_psnr, best_psnr_step, i)
            break
        t0 = time.time()
        if use_batching:
            batch = rays_rgb[i_batch:i_batch + args.N_rand]
            i_batch += args.N_rand
            if i_batch >= rays_rgb.shape[0]:
                rng.shuffle(rays_rgb)
                i_batch = 0
            rays_o, rays_d, target = batch[:, 0], batch[:, 1], batch[:, 2]
        else:
            img_i = int(rng.choice(scene.i_train))
            ro_full, rd_full = get_rays_np(H, W, focal, scene.poses[img_i])
            precrop = args.precrop_frac if i < args.precrop_iters else None
            sel = _select_coords(rng, H, W, args.N_rand, args.select_pixel_mode, precrop)
            rays_o = ro_full[sel[:, 0], sel[:, 1]]
            rays_d = rd_full[sel[:, 0], sel[:, 1]]
            target = scene.images[img_i][sel[:, 0], sel[:, 1]]

        state, metrics = step_fn(state, gen, to_device(rays_o, dev), to_device(rays_d, dev),
                                 to_device(target[..., :3], dev))
        batch_time.update(time.time() - t0)

        # metrics are read only at print boundaries: a read waits for the card
        if i % args.i_print == 0 or i == start + 1:
            psnr = float(metrics["psnr"])
            step_ms = clock.mark(i)
            hist_psnr = psnr if i == start + 1 else hist_psnr * 0.95 + psnr * 0.05
        if i % args.i_print == 0:
            ll = LossLine()
            ll.update("loss", float(metrics["loss"]), ".6f")
            ll.update("psnr", psnr, ".4f")
            ll.update("hist_psnr", hist_psnr, ".4f")
            ll.update("ms/step", step_ms, ".3f")
            log(f"[TRAIN] Iter {i} {batch_time} " + ll.format())

        best_psnr, best_psnr_step = _periodic(
            args, logger, bundle, state, i, hist_psnr, best_psnr, best_psnr_step,
            rp_kwargs, test_poses, test_images, video_poses, scene, timer)
    return state


def _shard_iterator(args, datadir_kd, rng, log, use_native: bool, what: str):
    """(next_batch, reload, close) over RayShardDataset/ShardLoader."""
    holder = {}
    dim_rgb = {"": 3, "depth": 4, "surface": 6}[args.learn_depth or ""]

    def build():
        ds = RayShardDataset(datadir_kd, dim_rgb=dim_rgb, hold_ratio=args.pseudo_data_hold_ratio,
                             pseudo_ratio=args.pseudo_ratio, rng=rng)
        if not len(ds):   # the loader's endless index stream would spin on nothing
            raise ValueError(f"no .npy shards in {datadir_kd}")
        if "loader" in holder:
            holder["loader"].close()
        holder["loader"] = ShardLoader(ds, args.N_rand, rng=rng, use_native=use_native,
                                       num_threads=args.num_workers and 2)
        log(f"Loaded {what} dataset: {len(ds)} files "
            f"({ds.n_original} real / {ds.n_pseudo} pseudo)")

    build()

    def reload(step):
        if step % args.i_update_data == 0:
            build()
            return True
        return False

    return (lambda step=None: next(holder["loader"])), reload, lambda: holder["loader"].close()


def _make_r2l_data_iterator(args, scene, rng, logger, device: torch.device):
    """Returns (next_batch(step) -> (o, d, target) numpy arrays,
    reload(step) -> bool, close()).

    reload(step) returns True when it rebuilt the dataset (the caller must
    then re-fetch the in-flight batch); next_batch takes the 1-based train
    step so images mode can apply the precrop warmup; close() stops the
    loader's threads."""
    H, W, focal = scene.hwf
    log = logger.info

    if args.stream_pseudo_data:
        if not args.teacher_ckpt:
            raise ValueError("--stream_pseudo_data requires --teacher_ckpt")
        from .data.pseudo import StreamingPseudoGenerator, scene_pose_sampler

        targs = SimpleNamespace(**vars(args))
        targs.model_name = "nerf"
        targs.pretrained_ckpt = args.teacher_ckpt
        targs.resume = False
        # rebuild the teacher with the arch recorded in its checkpoint
        for k, v in (load_checkpoint(args.teacher_ckpt).get("model_config") or {}).items():
            if k != "model_name" and hasattr(targs, k):
                setattr(targs, k, v)
        teacher = create_models(targs, scene.near, scene.far, device=device)
        nets = teacher.model
        gen = StreamingPseudoGenerator(
            nets["coarse"], nets["fine"] if "fine" in nets else None, teacher.cfg_test,
            H, W, focal,
            batch_rays=args.N_rand * 4096, buffer_rays=args.stream_buffer_rays,
            warmup_frames=args.stream_warmup_frames,
            frames_per_batch=args.stream_frames_per_batch,
            use_rand_focal=args.use_rand_focal, learn_depth=args.learn_depth,
            trans_origin=args.trans_origin,
            pose_sampler=scene_pose_sampler(args.dataset_type, scene.poses),
            rng=rng, device=device)
        log(f"Streaming pseudo data from the teacher on {device}")
        return (lambda step=None: next(gen)), (lambda step: False), (lambda: None)

    datadir_kd = args.datadir_kd.split(":")[-1]
    if args.data_mode == "rays":
        return _shard_iterator(args, datadir_kd, rng, log, True, "shard")
    if args.data_mode == "patches":
        # [items, ph, pw, D] shards from the 16x16patches / 3x3rays /
        # rand_tworays modes feed the conv student; the native reader reads
        # 2-D shards only
        return _shard_iterator(args, datadir_kd, rng, log, False, "patch shard")

    # images mode: sample pixels from random (real or pseudo) frames
    holder = {}

    def build(pr=0.5):
        holder["ds"] = ImageFrameDataset(datadir_kd, pseudo_ratio=pr, rng=rng)
        holder["it"] = infinite_indices(len(holder["ds"]), rng)
        log(f"Loaded image dataset: {len(holder['ds'])} frames")

    build(args.pseudo_ratio if args.pseudo_ratio >= 0 else 0.5)

    def next_batch(step=None):
        # N_rand pixels per iteration, center-cropped during the precrop
        # warmup (reference main.py:1264-1302)
        img, pose, _ = holder["ds"][next(holder["it"])]
        ro, rd = get_rays_np(img.shape[0], img.shape[1], focal, pose[:3, :4])
        precrop = (args.precrop_frac
                   if step is not None and step < args.precrop_iters else None)
        sel = _select_coords(rng, img.shape[0], img.shape[1], args.N_rand,
                             args.select_pixel_mode, precrop)
        return (ro[sel[:, 0], sel[:, 1]], rd[sel[:, 0], sel[:, 1]],
                img[sel[:, 0], sel[:, 1]][..., :3])

    def reload(step):
        if args.pseudo_ratio_schedule and step % args.i_update_data == 0:
            build(pseudo_ratio_schedule(args.pseudo_ratio_schedule, step))
            return True
        return False

    return next_batch, reload, (lambda: None)


def _train_r2l(args, logger, scene, bundle, n_iters, rng, gen, rp_kwargs,
               test_poses, test_images, video_poses, guard):
    next_batch, reload, close = _make_r2l_data_iterator(args, scene, rng, logger,
                                                        bundle.device)
    try:
        return _r2l_loop(args, logger, scene, bundle, n_iters, gen, rp_kwargs,
                         test_poses, test_images, video_poses, guard, next_batch, reload)
    finally:
        close()


def _r2l_loop(args, logger, scene, bundle, n_iters, gen, rp_kwargs,
              test_poses, test_images, video_poses, guard, next_batch, reload):
    log, dev = logger.info, bundle.device
    state = _init_state(bundle)
    start = state.step
    best_psnr, best_psnr_step = bundle.history["best_psnr"], bundle.history["best_psnr_step"]
    patch_mode = args.data_mode == "patches" and not args.stream_pseudo_data
    hard, pool = None, None
    probe = next_batch(start + 1)
    if patch_mode:
        # the conv student over patch shards; hard mining is ray-granular and
        # does not apply; BatchNorm's statistics live in the model
        step_fn = make_patch_train_step(
            bundle.model, bundle.optimizer, near=scene.near, far=scene.far,
            n_sample=args.n_sample_per_ray, L=args.multires, perturb=args.perturb > 0,
            lw_rgb=args.lw_rgb, fast_embed=not args.exact_embed,
            schedule=bundle.schedule, device=dev)
    else:
        # hard mining config (reference main.py:1324-1337)
        batch_size = probe[0].shape[0]
        if args.hard_ratio:
            if isinstance(args.hard_ratio, list):
                n_hard_in = int(args.hard_ratio[0] * batch_size)
                n_hard_out = int(args.hard_ratio[1] * batch_size)
            else:
                n_hard_in = n_hard_out = int(args.hard_ratio * batch_size)
            n_hard_in = min(n_hard_in, n_hard_out)
            hard = (n_hard_in, n_hard_out)
            pool = hard_pool_init(int(batch_size * args.hard_mul),
                                  row_dim=3 + 3 + probe[2].shape[-1], device=dev)
        r2l_step = make_r2l_train_step(
            bundle.model, bundle.optimizer, near=scene.near, far=scene.far,
            n_sample=args.n_sample_per_ray, L=args.multires, perturb=args.perturb > 0,
            lw_rgb=args.lw_rgb, learn_depth=bool(args.learn_depth), lw_depth=args.lw_depth,
            plucker=args.plucker, hard=hard, fast_embed=not args.exact_embed,
            fused=False if args.no_pallas else None, schedule=bundle.schedule, device=dev)

    timer = Timer(max(1, (n_iters - start) // args.i_testset))
    batch_time = AverageMeter("batch", ":.4f")
    data_time = AverageMeter("data", ":.4f")
    clock = _StepClock()
    hist_psnr = hist_depth = 0.0
    batch = probe
    for i in range(start + 1, n_iters + 1):
        if guard.fired:
            _preempted(args, logger, state, best_psnr, best_psnr_step, i)
            break
        t0 = time.time()
        if reload(i):
            # dataset rebuilt: drop the batch prefetched from the old loader
            # and draw step i's batch from the fresh one (main.py:1255-1261)
            batch = next_batch(i)
        o, d, t = (to_device(x, dev) for x in batch)
        data_time.update(time.time() - t0)
        if patch_mode:
            state, metrics = step_fn(state, gen, o, d, t)
        else:
            state, pool, metrics = r2l_step(state, pool, gen, o, d, t)
        batch = next_batch(i + 1) if i < n_iters else batch
        batch_time.update(time.time() - t0)

        # metrics are read only at print boundaries: a read waits for the card
        if i % args.i_print == 0 or i == start + 1:
            psnr = float(metrics["psnr"])
            step_ms = clock.mark(i)
            if math.isfinite(psnr):
                hist_psnr = psnr if i == start + 1 else hist_psnr * 0.95 + psnr * 0.05
            if args.learn_depth:
                ld = float(metrics["loss_depth"])
                hist_depth = ld if i == start + 1 else hist_depth * 0.95 + ld * 0.05
        if i % args.i_print == 0:
            ll = LossLine()
            ll.update("psnr", psnr, ".4f")
            ll.update("hist_psnr", hist_psnr, ".4f")
            if args.learn_depth:
                ll.update(f"hist_depthloss (*{args.lw_depth})", hist_depth, ".4f")
            ll.update("ms/step", step_ms, ".3f")
            log(f"[TRAIN] Iter {i} {data_time} {batch_time} " + ll.format())

        best_psnr, best_psnr_step = _periodic(
            args, logger, bundle, state, i, hist_psnr, best_psnr, best_psnr_step,
            rp_kwargs, test_poses, test_images, video_poses, scene, timer)
    return state


def main(argv=None, device: DeviceLike = None):
    args = parse_args(argv)
    logger = Logger(args, basedir=args.basedir)
    return train(args, logger, device=device)


if __name__ == "__main__":
    main()
