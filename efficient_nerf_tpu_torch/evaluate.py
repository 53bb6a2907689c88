"""Evaluation: render poses, compute PSNR/SSIM/LPIPS/FLIP, dump artifacts,
after `efficient_nerf_tpu.evaluate`.

render_path parity (reference main.py:189-398): per-pose rendering for both
model families, per-frame PSNR/SSIM + error maps + PNG dumps (the port's own
PNG codec), then batch LPIPS (minibatch 8, inputs rescaled to [-1, 1]) and
FLIP at the 3840-px monitor ppd, on the bundle's device. LPIPS is
weight-file gated (metrics/lpips.py); without weights the field is NaN.
With `quant="int8"` the student's int8 activation scales are calibrated once
per call, on the first pose's rays or the first given-ray frame.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .core.rays import get_rays
from .device import to_device
from .metrics import (default_pixels_per_degree, flip, img2mse, lpips,
                      lpips_available, mse2psnr, ssim)
from .render.r2l_renderer import (calibrate_serving_scales, r2l_forward_rays,
                                  r2l_render_image)
from .render.renderer import render_image
from .utils.images import save_image

__all__ = ["render_path", "load_given_rays"]


def _rescale(x: torch.Tensor, ymin: float, ymax: float) -> torch.Tensor:
    return (ymax - ymin) / (x.max() - x.min() + 1e-12) * (x - x.min()) + ymin


def load_given_rays(path: str):
    """Load a DONeRF-style given-render-path ray dump
    (reference --given_render_path_rays, main.py:207-213): a dict with
    all_rays_o [N, H*W, 3], all_rays_d [N, H*W, 3] and optional
    gt_imgs [N, H, W, 3], as .npz/.npy or a torch .pt/.pth file of
    tensors."""
    if path.endswith((".npz", ".npy")):
        z = np.load(path, allow_pickle=True)
        d = dict(z) if hasattr(z, "files") else z.item()
    else:
        loaded = torch.load(path, map_location="cpu", weights_only=True)
        d = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
             for k, v in loaded.items()}
    gt = d.get("gt_imgs")
    return (np.asarray(d["all_rays_o"], np.float32),
            np.asarray(d["all_rays_d"], np.float32),
            None if gt is None else np.asarray(gt, np.float32))


def render_path(bundle, poses: Sequence[np.ndarray], hwf, *,
                model_name: str, n_sample_per_ray: int = 16,
                multires: int = 10, plucker: bool = False,
                gt_imgs: Optional[np.ndarray] = None,
                savedir: Optional[str] = None, render_factor: float = 0,
                given_rays=None, flip_reference_domain: bool = False,
                quant: str = "", allow_fused: bool = True, log=print) -> Dict:
    """Render every pose on the bundle's device; return {'rgbs': [N,H,W,3],
    metrics...}.

    given_rays: optional (all_rays_o [N,HW,3], all_rays_d [N,HW,3]) — render
    these exact rays instead of generating rays from `poses` (the DONeRF
    eval path; R2L only). allow_fused=False (--no_pallas) takes the
    student's unfused path."""
    H, W, focal = hwf
    if render_factor:
        H, W = int(H / render_factor), int(W / render_factor)
        focal = focal / render_factor

    dev, cfg = bundle.device, bundle.cfg_test
    model = bundle.model
    if model_name == "nerf":
        coarse, fine = model["coarse"], model["fine"] if "fine" in model else None
    rgbs, psnrs, ssims, errors, frame_times = [], [], [], [], []
    n_frames = len(poses) if given_rays is None else len(given_rays[0])

    act_scales = None
    if quant == "int8" and model_name != "nerf":
        # serving configuration: the int8 activation scales once per call,
        # outside the frame loop
        if given_rays is not None:
            cal_o, cal_d = given_rays[0][0], given_rays[1][0]
        else:
            cal_o, cal_d = get_rays(H, W, focal, np.asarray(poses[0])[:3, :4], device=dev)
            cal_o, cal_d = cal_o.reshape(-1, 3), cal_d.reshape(-1, 3)
        act_scales = calibrate_serving_scales(model, cal_o, cal_d, cfg.near, cfg.far,
                                              n_sample_per_ray, L=multires, device=dev)
    for i in range(n_frames):
        t0 = time.perf_counter()
        if given_rays is not None:
            rgb = r2l_forward_rays(model, given_rays[0][i], given_rays[1][i], cfg.near,
                                   cfg.far, n_sample_per_ray, L=multires, quant=quant,
                                   allow_fused=allow_fused, act_scales=act_scales,
                                   device=dev).reshape(H, W, -1)
        elif model_name == "nerf":
            rgb = render_image(coarse, fine, H, W, focal, np.asarray(poses[i])[:3, :4],
                               cfg, device=dev).rgb
        else:
            rgb = r2l_render_image(model, np.asarray(poses[i])[:3, :4], H, W, focal,
                                   cfg.near, cfg.far, n_sample_per_ray, L=multires,
                                   plucker=plucker, quant=quant, act_scales=act_scales,
                                   allow_fused=allow_fused, device=dev)
        rgb = rgb.float().cpu().numpy()     # waits for the frame
        frame_times.append(time.perf_counter() - t0)
        rgbs.append(rgb)

        if gt_imgs is not None:
            gt = np.asarray(gt_imgs[i])[:H, :W, :3]
            err = np.abs(rgb - gt)
            errors.append(err)
            psnrs.append(float(mse2psnr(torch.tensor(np.mean(err ** 2), dtype=torch.float32))))
            ssims.append(float(ssim(to_device(rgb, dev)[None], to_device(gt, dev)[None])))
        if savedir is not None:
            os.makedirs(savedir, exist_ok=True)
            save_image(os.path.join(savedir, f"{i:03d}.png"), rgb)
            if gt_imgs is not None:
                save_image(os.path.join(savedir, f"{i:03d}_gt.png"), np.asarray(gt_imgs[i]))
                save_image(os.path.join(savedir, f"{i:03d}_error.png"), errors[-1])
        note = " (incl. first-call set-up)" if i == 0 else ""
        log(f"[#{i}] frame rendered in {frame_times[-1]:.3f}s{note}")

    out: Dict = {"rgbs": np.stack(rgbs, 0), "frame_times": frame_times}
    # frame 0 pays the packing and first launches; report the steady-state
    # time separately
    steady = frame_times[1:] if len(frame_times) > 1 else frame_times
    out["frame_time_avg"] = float(np.mean(steady))
    if gt_imgs is not None:
        rec = to_device(out["rgbs"], dev)
        ref = to_device(np.asarray(gt_imgs)[:, :H, :W, :3], dev)
        test_loss = float(img2mse(rec, ref))
        out["test_loss"] = test_loss
        out["test_psnr"] = float(mse2psnr(torch.tensor(test_loss, dtype=torch.float32)))
        out["test_psnr_v2"] = float(np.mean(psnrs))
        out["test_ssim"] = float(np.mean(ssims))
        out["errors"] = np.stack(errors, 0)

        # batch perceptual metrics at [-1, 1] (reference main.py:355-379)
        rec_m = _rescale(rec, -1.0, 1.0)
        ref_m = _rescale(ref, -1.0, 1.0)
        if lpips_available():
            vals = [lpips(rec_m[s:s + 8], ref_m[s:s + 8]) for s in range(0, rec_m.shape[0], 8)]
            out["test_lpips"] = float(torch.cat(vals).mean())
        else:
            out["test_lpips"] = float("nan")
        # FLIP input domain: the reference feeds the [-1, 1]-rescaled tensors
        # straight into compute_flip (main.py:372-379), whose srgb2linrgb
        # clamps to [0, 1]; the default remaps back to [0, 1], and
        # flip_reference_domain=True reproduces the reference's numbers
        if flip_reference_domain:
            out["test_flip"] = float(flip(ref_m, rec_m, default_pixels_per_degree()))
        else:
            out["test_flip"] = float(flip(ref_m * 0.5 + 0.5, rec_m * 0.5 + 0.5,
                                          default_pixels_per_degree()))
    return out
