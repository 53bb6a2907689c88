#!/usr/bin/env python3
"""Drives the PyTorch port's R2L serving and training paths and the NeRF
teacher's rendering and pseudo-data paths on one CUDA card, and holds their
kernels against their plain versions.

    python3 chip_smoke.py [--seed N] [--phases build,kernel,...]

Phases, each of which fails the run (non-zero exit, no result line):
  build         nvcc builds every csrc/*.cu into build/kernels/ (one nvcc per
                source, all started together); prints the time and ptxas's
                report, and for the two forward kernels on the wgmma tile
                (csrc/r2l_wgmma.cuh) and the backward's pass 1 (its own
                wgmma tile in csrc/r2l_train.cu) each instantiation's
                registers, spill bytes and dynamic shared memory, and pass
                1's weight-ring stages at each width; the warpgroup MMAs in
                the SASS (cuobjdump): the two int8 kernels' must hold integer
                ones (IGMMA), each of pass 1's 8 instantiations bf16 ones
                (HGMMA).
  trig          the fast_sincos device helper (csrc/trig.cuh) against its
                plain torch version over |y| <= 4e3.
  kernel        the fused R2L kernel at W256 D88, n_sample 16, L 10, B 8192
                and the ragged B 1, 37, 64, 65, 192 (the last 64-ray tile
                partly filled, or whole), both use_residual
                settings, against r2l_forward_fused_ref; two calls bit for
                bit.
  main          r2l_render_image for 3 pose_spherical poses at 400x400
                through the public entry points, with the kernels' launch
                counters set to 0 just before and read just after; then the
                frame time, the kernel time beside its bound, the plain
                version and the unfused cuBLAS path (the library yardstick).
  kernel_int8   the W8A8 kernel at W256 D88, B 8192, static scales (from
                calibrate_r2l_int8 on 1024 of those rays) and dynamic ones,
                use_residual off and on, and a ragged B 37, against
                r2l_forward_int8_ref; max and mean error, the share of rays
                beyond 4e-3, two calls bit for bit in each mode, and the
                noise of the plain version on the CPU against on the card (B
                2048); the int8 student tile's registers and spills (ptxas,
                one line an instantiation), shared memory and ring stages.
  main_int8     calibrate_serving_scales once on the first 1024 rays of frame
                0, then r2l_render_image(quant="int8", act_scales=...) for
                the 3 poses as a user calls it, the launch counters set to 0
                just before and read just after (one int8 launch a frame, no
                bf16 launch); the frame against the plain version; frame and
                kernel time beside the bound, the plain version, the unfused
                torch._int_mm path (the library yardstick) and the bf16
                kernel; the int8 frame against the bf16 kernel's.
  train_kernel  the training kernels at W256 D88, embed_L 10, bf16, B 8192
                and a ragged B 37, use_residual and need_dx off and on:
                out and hs of the forward, every gradient and dx of the
                backward, against their plain versions; the forward also at
                the ragged B 1, 64, 65, 192, and two forward calls bit for
                bit; at B 8192 each backward pass against its plain version
                (pass 2 on pass 1's own scratch) and two backward calls bit
                for bit.
  train         make_r2l_train_step at the slice's configuration (98,304
                rays a step: 81,920 batch rays + 16,384 hard rays from an
                81,920-row pool, perturbed, Adam with the warmup schedule):
                10 steps on rays of pose_spherical frames with targets from
                a second R2L of another seed, the launch counters set to 0
                just before and read just after (one launch of the forward
                and of each backward pass a step); then the training
                kernels against their plain versions at the step's 98,304
                rays, each backward pass alone and the whole backward, and
                two backward calls bit for bit; the step time split into its
                parts, and each training kernel's time beside its bound, its
                plain version and its library yardstick: the unfused cuBLAS
                autograd forward, its backward against the two passes' sum,
                and one cuBLAS bmm of pass 2's body products.
  teacher_kernel  the teacher's field-eval kernel at W256 D8, L 10/4 (the lego
                config's NeRFMLP) on points of frame rays at 512 rays x 64,
                256 x 192 and a ragged 37 x 64 and 37 x 192 (one case
                channel-major), against nerf_forward_fused_ref as max |k - p|
                / max |p| for sigma and for rgb, beside the noise of the plain
                version on the CPU against on the card; at the main path's
                chunk shapes, 32,768 x 64 and 32,768 x 192, the same check,
                two calls bit for bit, and the time beside the bound; the
                wgmma tile's registers and spills (ptxas), shared memory and
                weight-ring stages; the inverse-CDF
                kernel on 32,768 rays of a coarse pass's own weights with
                degenerate rows (all-zero weights, a single spike, a CDF
                total that rounds above 1) against sample_pdf_det_fused_ref,
                bit for bit.
  teacher       render_image(..., cfg.eval_mode()) of the lego config (64 +
                128 samples, white background, near 2, far 6, chunk 32,768)
                for 3 pose_spherical frames of 400x400 as a user calls it,
                the launch counters set to 0 just before and read just after
                (2 field-eval and 1 sampler launch per chunk); frame checks,
                the frame's mean acc and its share of rays with acc in
                (0.01, 0.99); the frame against the same frame rendered on
                the card through the plain versions; the sampler on the
                main path's chunk (its coarse weights) against its plain
                version, bit for bit; frame time, and each kernel's time at
                the coarse and the fine chunk beside its bound, its plain
                version and (field eval) the unfused nerf_embed -> bf16
                NeRFMLP cuBLAS path.
  pseudo        StreamingPseudoGenerator over 6 frames through its one-frame
                pipeline (ms a frame beside render_image alone), and
                export_pseudo_shards for 4 poses into a temporary directory:
                156 shards of [4096, 9] whose rows are rows of the 4 frames.
  teacher_int8_kernel  the int8 field-eval kernel against nerf_forward_int8_ref
                at 512 x 64, 256 x 192, a ragged 37 x 64 (channel-major) and
                37 x 192, and at the main path's 32,768 x 64 and 32,768 x 192
                on the teacher phase's points, each with scales calibrated on
                its first 1024 points: max |k - p| / max |p| of sigma and
                rgb, the share of points beyond TEACHER_TOL, two calls bit
                for bit at the chunk shapes, and the noise of the plain
                version on the CPU against on the card; the int8 field tile's
                registers and spills, shared memory and ring stages.
  teacher_int8  render_image with teacher_quant="int8" for the 3 frames, the
                launch counters set to 0 just before and read just after (2
                int8 field-eval, no bf16 field-eval and 1 sampler launch per
                chunk); the frame against the same frame through the plain
                versions; the int8 frame against the bf16 frame (the share of
                rays whose acc flips, and the PSNR over the others);
                StreamingPseudoGenerator with the int8 config over 3 frames;
                frame time, and the kernel at the coarse and the fine chunk
                beside its bound, its plain version and the unfused
                torch._int_mm path.
  frame_kernel  the whole-ray kernel against nerf_render_rays_fused_ref on 37
                random rays and on a 32,768-ray chunk (share of rays beyond
                FRAME_TOL), its fine depths against sample_pdf_det_fused on
                the kernel's own coarse weights, bit for bit; its time at the
                chunk beside its bound, its plain version and the composed
                path's kernels (teacher phase); the tile's registers and
                spills, shared memory and weight-ring stages.
  teacher_frame render_image with frame_fused=True for the 3 frames (1
                whole-ray launch and no other teacher kernel per chunk); the
                frame against the composed kernel path's frame of the
                teacher phase; frame time beside the composed path's.
Before the last line it prints the card's name and power limit (nvidia-smi)
and one JSON line {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. --phases runs the named phases only (each
with the phases it reads from: main needs kernel, train train_kernel, ...)
and then prints the kernels line of those phases and no "ok" line.
Weights are random, made from --seed: the student's with each block's
second linear scaled by 0.1 so that the 88-layer output is not saturated
by the sigmoid; the teacher's lecun-normal kernels
(normal, std 1/sqrt(fan_in)) and normal biases of std 0.01, a bf16 NeRFMLP
(no teacher checkpoint is in the repository). Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import copy
import ctypes
import json
import math
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak, H100 SXM data sheet
H100_INT8_OPS = 1979e12    # dense int8 tensor-core peak, H100 SXM data sheet
H100_HBM_BYTES = 3.35e12   # HBM3 bandwidth, H100 SXM data sheet

# Flagship student: W256 D88, 16 samples, L 10 -> input 1008.
WIDTH, DEPTH, N_SAMPLE, L_FREQ = 256, 88, 16, 10
IN_DIM = 3 * N_SAMPLE * (2 * L_FREQ + 1)
NEAR, FAR = 2.0, 6.0
FRAME_H = FRAME_W = 400
FOCAL = 0.5 * FRAME_W / 0.4142135623730951   # 45-degree field of view
KERNEL_B = 8192
# Batches at the edges of the 64-ray tile: one ray, part of a tile, one
# tile, one ray past it, three tiles
RAGGED_B = (1, 37, 64, 65, 192)
NOISE_B = 2048
TRIG_N = 1 << 22

# Student training at the README's command on the lego config:
# --N_rand 20 (x 4096 rays), --hard_ratio 0.2, hard_mul 1, --lrate 5e-4,
# --lrate_decay 500, --warmup_lr 0.0001,200 (main.py:634-645).
TRAIN_BATCH = 20 * 4096
TRAIN_HARD = (16384, 16384)         # (n_hard_in, n_hard_out)
TRAIN_POOL = TRAIN_BATCH            # hard_mul 1
TRAIN_STEPS = 10
TRAIN_FRAMES = 4                    # 640,000 rays to draw the batches from
EVAL_B = 8192

# The helper rounds each operation as the plain version does (trig.cuh),
# so they should agree exactly; allow one f32 ulp near 1.
TRIG_TOL = 1.2e-7
# Kernel vs plain version: the same bf16 operands and f32 epilogues, but the
# tensor cores sum in another order than the f32 matmul; a one-ulp difference
# in an f32 activation can flip its bf16 rounding, and that noise grows
# through 88 layers. The plain version alone, on the CPU and on the card,
# differs by up to 6.7e-4 on 2048 rays (the noise line below); the kernel
# by up to 1.5e-3 over 8192 and 160,000 rays (PERF.md). 4e-3 is 6x that
# noise; a wrong layout or index moves outputs by 1e-1 and more.
KERNEL_TOL = 4e-3
# Training kernels vs their plain versions, as max |kernel - plain| over
# max |plain| of each tensor. The noise is the forward's (above) plus, in
# the backward, bf16 roundings of dg2, dg1 and dpre that flip with the
# summation order and carry through 43 blocks, and the weight gradients'
# f32 summation order (~1e-7 relative: negligible). The first card run
# measured at most 6.5e-3 (hs), 2.3e-3 (gradients) and 1.1e-2 (dx, whose
# embed chain multiplies by up to 2^9) over these shapes, and the plain
# version on the CPU against on the card differs by the amounts the noise
# line prints. The limits are 3-4x those; a wrong index or orientation gives
# errors of order 1. Pass 1's scratch (dg2, dg1, g1, dpre, the embed, the
# per-tile sums) carries the same noise and is held to "grad".
TRAIN_TOL = {"hs": 2e-2, "grad": 1e-2, "dx": 4e-2}
# Pass 2 against its plain version on the same scratch: the same bf16
# products, summed in f32 in another order over up to 98,304 rays, which
# moves a sum by some sqrt(n) ulps of the terms' scale. The first card runs
# measured 1.1e-5 and 1.5e-5 at 98,304 rays (4e-6 at 8192); 1e-4 is 7x that,
# and a wrong tile, index or orientation gives errors of order 1.
WGRAD_TOL = 1e-4
# int8 kernel vs its plain version: the int8 products are exact on both
# sides and the epilogues round alike, so they differ only where the bf16
# head's (or tail's) f32 sum lands an ulp apart and that ulp moves a value
# across a quantizer's rounding boundary: one int8 level of one activation,
# carried through the remaining blocks. The JAX package allows 1e-2 (static)
# and 1.5e-2 (dynamic) for its int8 kernel against its twin
# (tests/test_ops.py:259, :230). On the card the plain version alone, on the
# CPU against on the card, differs by up to 2.4e-3 (the noise line below),
# and the kernel by up to 4.7e-3 over 8192 and 160,000 rays, in 0.015% of
# rays beyond 4e-3 (PERF.md); 8e-3 is 1.7x that, and a wrong layout, scale or
# rounding moves outputs by 1e-1 and more.
INT8_TOL = {"static": 8e-3, "dynamic": 8e-3}
INT8_CAL = 1024   # calibration rays, as bench.py calibrates


# Teacher at the lego config (efficient_nerf_tpu/config/scenes/lego.txt):
# NeRFMLP D8 W256, skip after layer 4, viewdirs, multires 10 / 4, 64 coarse
# + 128 fine samples, white background, near 2, far 6, half_res 400x400 with
# the lego camera's field of view (camera_angle_x of its transforms files).
T_WIDTH, T_DEPTH, T_L, T_LV = 256, 8, 10, 4
T_SAMPLES, T_IMPORTANCE, T_CHUNK = 64, 128, 32768
LEGO_CAMERA_ANGLE_X = 0.6911112070083618
T_FOCAL = 0.5 * FRAME_W / math.tan(0.5 * LEGO_CAMERA_ANGLE_X)
PSEUDO_FRAMES = 6
PSEUDO_POSES = 4
# Field-eval kernel vs its plain version, as max |kernel - plain| over max
# |plain| of sigma and of rgb: the same bf16 operands and embed, but the
# tensor cores sum in another order and less exactly than an f32 matmul, so
# an f32 activation can land on the other side of a bf16 rounding and carry
# through 8 layers. The plain version alone, on the CPU and on the card,
# agrees to 2e-7 (its f32 sums hardly ever flip a rounding: the noise line
# below); the first card run measured the kernel at up to 5.4e-3 over these
# shapes. 2e-2 is 3.7x that; a wrong layout or index gives errors of order 1.
TEACHER_TOL = 2e-2
# The rendered frame against the same frame through the plain versions,
# per ray (absolute: rgb and acc in [0, 1], depth in [0, 6]). The last
# sample of each pass stands for an interval of length 1e10, so a ray whose
# last sigma is within the kernel's noise of 0 turns opaque or clear as the
# sign flips: the first card run found one such ray in 32,768. So at most
# FRAME_SHARE of a frame's rays may differ beyond FRAME_TOL.
FRAME_TOL = {"rgb": 2e-2, "acc": 2e-2, "depth": 1e-1}
FRAME_SHARE = 1e-4
# int8 field-eval kernel vs its plain version, as max |kernel - plain| over
# max |plain| of sigma and of rgb: the int8 products are exact on both sides
# and the epilogues round alike, but where a bf16 product's f32 sum (layer
# 0, the skip rows, the heads) lands an ulp apart, an activation can cross a
# quantizer's rounding boundary: one int8 level, s_i |w| in the next product,
# carried through the remaining layers. The plain version alone, on the CPU
# and on the card, agrees to 2e-7 (the noise line below: its f32 sums hardly
# ever flip a level; the tensor cores' sums do); the first card run measured
# the kernel at up to 2.7e-2 (sigma, a fine chunk of 6.29 M points) and
# 1.4e-2 (rgb), with 6 of those points beyond TEACHER_TOL. 6e-2 is 2.2x that;
# a wrong layout, scale or rounding gives errors of order 1.
INT8_TEACHER_TOL = 6e-2
# The int8 teacher frame against the bf16 one. The JAX package gates it at
# 30 dB PSNR (tests/test_quality_e2e.py:270), on a trained teacher. The
# random teacher here has its sigma near 0 everywhere (lecun-normal kernels,
# biases of std 0.01), so where a pass's last sigma, which stands for a
# 1e10-long interval, lies within the int8 noise (about 1e-2 on raw) of 0,
# the ray turns opaque in one frame and clear in the other: the first card
# run found 0.91% of the rays with their coarse acc moved by more than 0.5,
# which alone holds the whole frame at 26.8 dB. So the gate is that share,
# at most INT8_FLIP_SHARE (2.2x that run's), and the 30 dB over the rays
# whose coarse and fine acc stay.
INT8_PSNR_MIN = 30.0
INT8_FLIP_SHARE = 2e-2


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip()


def random_state_dict(seed: int, torch):
    """Reference-layout state_dict of a W256 D88 student: lecun-normal
    kernels, small normal biases, each block's second linear times 0.1."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def lin(fan_in, fan_out, scale=1.0):
        w = rng.normal(size=(fan_out, fan_in)) / np.sqrt(fan_in) * scale
        b = rng.normal(size=(fan_out,)) * 0.01
        return (torch.tensor(w.astype(np.float32)),
                torch.tensor(b.astype(np.float32)))

    sd = {}
    sd["head.0.weight"], sd["head.0.bias"] = lin(IN_DIM, WIDTH)
    for b in range((DEPTH - 2) // 2):
        sd[f"body.{b}.body.0.weight"], sd[f"body.{b}.body.0.bias"] = lin(WIDTH, WIDTH)
        sd[f"body.{b}.body.2.weight"], sd[f"body.{b}.body.2.bias"] = lin(WIDTH, WIDTH, 0.1)
    sd["tail.0.weight"], sd["tail.0.bias"] = lin(WIDTH, 3)
    return sd


def cuda_ms(torch, fn, n: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() over n calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(flops: float, nbytes: float, int8_ops: float = 0.0):
    """(bound ms, 'operations' or 'bytes') at the card's data-sheet peaks:
    flops at the bf16 rate, int8_ops at the int8 rate."""
    t_ops = (flops / H100_BF16_FLOPS + int8_ops / H100_INT8_OPS) * 1e3
    t_bytes = nbytes / H100_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def ptxas_report(name: str, kernel: str):
    """{instantiation: [ptxas lines]} of `kernel`'s instantiations in the
    build log of csrc/<name>.cu: registers, spill bytes, shared memory."""
    from efficient_nerf_tpu_torch.ops import _build

    cur, props = None, {}
    for line in _build.build_log(name).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
        elif cur and kernel in cur and ("spill" in line or "Used" in line):
            props.setdefault(cur, []).append(line.strip())
    return props


def print_tile(label: str, name: str, kernel: str, sizes):
    """Prints the field tile's registers and spills (one line an
    instantiation, W its width) and, for each (what, smem bytes, stages) of
    `sizes`, its dynamic shared memory and weight-ring stages."""
    for cur, lines in sorted(ptxas_report(name, kernel).items()):
        w = re.search(r"ILi(\d+)EE", cur)
        print(f"{label}: {kernel}<W={w.group(1) if w else '?'}>: " + "; ".join(lines),
              flush=True)
    for what, smem, stages in sizes:
        print(f"{label}: {kernel} at {what}: {smem} bytes of dynamic shared memory, "
              f"{stages} weight-ring stages of {T_WIDTH * 64 * 2} bytes", flush=True)


class Smoke:
    """The state the phases share: the card, the imports, the weights, the
    rays and the {"kernels": [...]} entries."""

    def __init__(self, args):
        import torch

        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is false; this script needs a card")
        from efficient_nerf_tpu_torch.core.poses import pose_spherical
        from efficient_nerf_tpu_torch.core.rays import get_rays

        self.torch = torch
        self.seed = args.seed
        self.dev = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.gpu = gpu_line()
        print(f"gpu: {self.gpu}  ({torch.cuda.get_device_name(0)}, torch "
              f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)
        self.gen = torch.Generator(device=self.dev).manual_seed(args.seed)
        self.sd = random_state_dict(args.seed, torch)
        self.poses = [pose_spherical(t, -30.0, 4.0) for t in (-150.0, -30.0, 90.0)]
        self.rays = [get_rays(FRAME_H, FRAME_W, FOCAL, p[:3, :4], device=self.dev)
                     for p in self.poses]
        all_o = torch.cat([o.reshape(-1, 3) for o, _ in self.rays])
        all_d = torch.cat([d.reshape(-1, 3) for _, d in self.rays])
        pick = torch.randint(0, all_o.shape[0], (KERNEL_B,), generator=self.gen,
                             device=self.dev)
        self.ko, self.kd = all_o[pick].contiguous(), all_d[pick].contiguous()
        self.entries = {}

    def model(self, sd, use_residual=False, dtype=None):
        from efficient_nerf_tpu_torch.models import R2LNet

        m = R2LNet(IN_DIM, DEPTH, WIDTH, use_residual=use_residual,
                   dtype=dtype or self.torch.float32)
        m.load_state_dict(sd)
        return m.to(self.dev)


def phase_build(sm: Smoke) -> None:
    from efficient_nerf_tpu_torch.ops import _build

    build_s = _build.build_all()
    print(f"build: {build_s:.1f} s for {', '.join(_build.SOURCES)}", flush=True)
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    # the two forward kernels on the wgmma tile, one line an instantiation
    # (NT output columns a warpgroup, W256 is NT 128; PARTS=1 runs the head
    # of an input wider than the embed's room in parts)
    for name, kernel, fn in (("r2l_forward", "r2l_forward_kernel", "r2l_forward_smem_bytes"),
                             ("r2l_train", "r2l_train_fwd_kernel", "r2l_train_fwd_smem_bytes")):
        props = ptxas_report(name, kernel)
        lib = ctypes.CDLL(str(_build.library_path(name)))
        getattr(lib, fn).restype = ctypes.c_longlong
        smem = getattr(lib, fn)(1024, WIDTH)
        for cur, lines in sorted(props.items()):
            nt = re.search(r"ILi(\d+)ELb([01])E", cur)
            name_args = f"NT={nt.group(1)}, PARTS={nt.group(2)}" if nt else "?"
            print(f"build: {kernel}<{name_args}>: " + "; ".join(lines), flush=True)
        print(f"build: {kernel} dynamic shared memory at W{WIDTH}, in_pad 1024: {smem} "
              f"bytes", flush=True)
    # the backward's pass 1 on its wgmma tile: one line an instantiation (NT
    # columns a warpgroup, W = 2 NT; NEED_DX=1 compiles the dx chain in), and
    # its shared memory and weight-ring stages at each width
    lib = ctypes.CDLL(str(_build.library_path("r2l_train")))
    lib.r2l_train_bwd_smem_bytes.restype = ctypes.c_longlong
    for cur, lines in sorted(ptxas_report("r2l_train", "r2l_train_bwd_kernel").items()):
        nt = re.search(r"ILi(\d+)ELb([01])E", cur)
        name_args = f"NT={nt.group(1)}, NEED_DX={nt.group(2)}" if nt else "?"
        print(f"build: r2l_train_bwd_kernel<{name_args}>: " + "; ".join(lines), flush=True)
    print("build: r2l_train_bwd_kernel at in_pad 1024: " + "; ".join(
        f"W{w} {lib.r2l_train_bwd_smem_bytes(1024, w)} bytes of dynamic shared memory, "
        f"{lib.r2l_train_bwd_stages(w)} ring stages of {w * 128} bytes"
        for w in (64, 128, 192, 256)), flush=True)
    # the warpgroup MMAs in the built SASS: integer ones (IGMMA) in the two
    # int8 kernels, bf16 ones (HGMMA) in every instantiation of pass 1
    cuobjdump = shutil.which("cuobjdump", path=str(Path(_build._nvcc()).parent))
    if cuobjdump is None:
        fail("cuobjdump not found beside nvcc")
    gmma = r"\b[A-Z]GMMA\.[0-9x]+\.[A-Z0-9]+\.[A-Z0-9]+\b"

    def sass_of(name):
        return subprocess.run([cuobjdump, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, check=True, timeout=300).stdout

    for name in ("r2l_int8", "nerf_int8"):
        ops = sorted(set(re.findall(gmma, sass_of(name))))
        print(f"build: {name} SASS warpgroup MMAs: {', '.join(ops)}", flush=True)
        if not any(op.startswith("IGMMA") for op in ops):
            fail(f"no integer warpgroup MMA (IGMMA) in the SASS of csrc/{name}.cu")
    bwd = {}
    for sec in re.split(r"\n\s*Function : ", sass_of("r2l_train"))[1:]:
        fn, body = sec.split("\n", 1)
        if "r2l_train_bwd_kernel" in fn:
            bwd[fn.strip()] = sorted(set(re.findall(gmma, body)))
    for fn, ops in sorted(bwd.items()):
        nt = re.search(r"ILi(\d+)ELb([01])E", fn)
        print(f"build: r2l_train_bwd_kernel<{nt.group(1) if nt else '?'}, "
              f"{nt.group(2) if nt else '?'}> SASS warpgroup MMAs: {', '.join(ops)}", flush=True)
    if len(bwd) != 8 or not all(any(op.startswith("HGMMA") for op in ops)
                                for ops in bwd.values()):
        fail(f"pass 1 (r2l_train_bwd_kernel) has not HGMMA in the SASS of each of its 8 "
             f"instantiations: {bwd}")


def phase_trig(sm: Smoke) -> None:
    from efficient_nerf_tpu_torch.ops.trig import fast_sincos, fast_sincos_cuda

    torch = sm.torch
    y = (torch.rand(TRIG_N, generator=sm.gen, device=sm.dev) * 2 - 1) * 4e3
    s_k, c_k = fast_sincos_cuda(y)
    s_p, c_p = fast_sincos(y)
    torch.cuda.synchronize()
    trig_err = max((s_k - s_p).abs().max().item(), (c_k - c_p).abs().max().item())
    n_diff = int((s_k != s_p).sum().item() + (c_k != c_p).sum().item())
    y64 = y.double()
    acc_err = max((s_k.double() - torch.sin(y64)).abs().max().item(),
                  (c_k.double() - torch.cos(y64)).abs().max().item())
    trig_ms = cuda_ms(torch, lambda: fast_sincos_cuda(y), 20)
    trig_plain_ms = cuda_ms(torch, lambda: fast_sincos(y), 5)
    print(f"trig: fast_sincos(degree=9) over |y|<=4e3, n={TRIG_N}: max |kernel - "
          f"plain| {trig_err:.3g} (tol {TRIG_TOL:g}), {n_diff} values differ; "
          f"max |kernel - float64 sin/cos| {acc_err:.3g}; {trig_ms:.4f} ms "
          f"for its test kernel", flush=True)
    if not trig_err <= TRIG_TOL:
        fail(f"trig helper differs from its plain version by {trig_err}")
    # a device helper: it runs inside each launch of the kernels that embed
    # (its launches are theirs, filled in at the end)
    sm.entries["fast_sincos"] = {
        "name": "fast_sincos", "route": "cuda",
        "source": "efficient_nerf_tpu_torch/csrc/trig.cuh",
        "replaces": "efficient_nerf_tpu/ops/pallas/trig.py:53",
        "launches": 0, "max_abs_err": trig_err, "ms": trig_ms,
        "plain_ms": trig_plain_ms,
        "bound_ms": TRIG_N * 12 / H100_HBM_BYTES * 1e3, "bound_by": "bytes",
        "library_ms": None}


def phase_kernel(sm: Smoke) -> None:
    from efficient_nerf_tpu_torch.ops.r2l_forward import (
        pack_r2l_weights, r2l_forward_fused, r2l_forward_fused_ref)

    torch, dev, ko, kd = sm.torch, sm.dev, sm.ko, sm.kd
    packed = pack_r2l_weights({k: v.to(dev) for k, v in sm.sd.items()}, N_SAMPLE, L_FREQ)
    max_err = 0.0
    for use_res in (False, True):
        got = r2l_forward_fused(packed, ko, kd, NEAR, FAR, N_SAMPLE, L_FREQ,
                                use_global_residual=use_res)
        want = r2l_forward_fused_ref(packed, ko, kd, NEAR, FAR, N_SAMPLE, L_FREQ,
                                     use_global_residual=use_res)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        mean_err = (got - want).abs().mean().item()
        unsat = ((want > 0.01) & (want < 0.99)).float().mean().item()
        print(f"kernel: W{WIDTH} D{DEPTH} B={KERNEL_B} use_residual={use_res}: "
              f"max |kernel - plain| {err:.3g} (mean {mean_err:.3g}, tol "
              f"{KERNEL_TOL:g}); unsaturated share {unsat:.4f}", flush=True)
        if got.shape != (KERNEL_B, 3) or not torch.isfinite(got).all():
            fail("kernel output has the wrong shape or is not finite")
        if not err <= KERNEL_TOL:
            fail(f"kernel differs from its plain version by {err}")
        max_err = max(max_err, err)
        again = r2l_forward_fused(packed, ko, kd, NEAR, FAR, N_SAMPLE, L_FREQ,
                                  use_global_residual=use_res)
        if not torch.equal(got, again):
            fail("two kernel calls on the same rays differ in their bits")
    # batches at the tile's edges
    ragged = {}
    for B in RAGGED_B:
        for use_res in (False, True):
            o, d = ko[-B:].contiguous(), kd[-B:].contiguous()
            got = r2l_forward_fused(packed, o, d, NEAR, FAR, N_SAMPLE, L_FREQ,
                                    use_global_residual=use_res)
            want = r2l_forward_fused_ref(packed, o, d, NEAR, FAR, N_SAMPLE, L_FREQ,
                                         use_global_residual=use_res)
            torch.cuda.synchronize()
            if got.shape != (B, 3) or not torch.isfinite(got).all():
                fail(f"kernel output at B={B} has the wrong shape or is not finite")
            ragged[(B, use_res)] = (got - want).abs().max().item()
    print("kernel: ragged batches, max |kernel - plain| (B, use_residual): "
          + " ".join(f"{k[0]}/{int(k[1])} {v:.3g}" for k, v in ragged.items())
          + "; two calls bit for bit: True", flush=True)
    if not max(ragged.values()) <= KERNEL_TOL:
        fail(f"kernel differs from its plain version by {max(ragged.values())} at a "
             "ragged batch")
    max_err = max(max_err, *ragged.values())
    # the noise that summation order alone makes: the same plain version on
    # the host CPU and on the card, on the first NOISE_B of these rays
    cpu_packed = {k: v.cpu() if torch.is_tensor(v) else v for k, v in packed.items()}
    want_cpu = r2l_forward_fused_ref(cpu_packed, ko[:NOISE_B].cpu(),
                                     kd[:NOISE_B].cpu(), NEAR, FAR, N_SAMPLE,
                                     L_FREQ)
    want = r2l_forward_fused_ref(packed, ko[:NOISE_B], kd[:NOISE_B], NEAR, FAR,
                                 N_SAMPLE, L_FREQ)
    got = r2l_forward_fused(packed, ko[:NOISE_B], kd[:NOISE_B], NEAR, FAR,
                            N_SAMPLE, L_FREQ)
    noise = (want.cpu() - want_cpu).abs().max().item()
    print(f"kernel: summation-order noise, plain version on the CPU vs on the "
          f"card, B={NOISE_B}: max {noise:.3g}; kernel vs plain on the same "
          f"rays {(got - want).abs().max().item():.3g}", flush=True)
    sm.packed = packed
    sm.serve_err = max_err


def phase_main(sm: Smoke) -> None:
    from efficient_nerf_tpu_torch.ops.r2l_forward import (
        r2l_forward_flops, r2l_forward_fused, r2l_forward_fused_ref)
    from efficient_nerf_tpu_torch.ops.trig import fast_sincos_cuda
    from efficient_nerf_tpu_torch.render import r2l_forward_rays, r2l_render_image

    torch, dev, rays = sm.torch, sm.dev, sm.rays
    packed = sm.packed
    model = sm.model(sm.sd).eval()
    c2ws = [p[:3, :4] for p in sm.poses]
    r2l_render_image(model, c2ws[0], FRAME_H, FRAME_W, FOCAL, NEAR, FAR,
                     N_SAMPLE, L_FREQ, device=dev)               # warm-up
    torch.cuda.synchronize()
    r2l_forward_fused.launches = 0
    fast_sincos_cuda.launches = 0
    # as a user calls it: numpy poses, the default device (CUDA)
    frames = [r2l_render_image(model, c2w, FRAME_H, FRAME_W, FOCAL, NEAR, FAR,
                               N_SAMPLE, L_FREQ) for c2w in c2ws]
    torch.cuda.synchronize()
    launches = r2l_forward_fused.launches
    print(f"main: 3 frames of {FRAME_H}x{FRAME_W}: r2l_forward_fused launches "
          f"{launches}", flush=True)
    if launches != len(frames):
        fail(f"expected one fused launch per frame, counted {launches}")
    for img in frames:
        if img.shape != (FRAME_H, FRAME_W, 3) or not torch.isfinite(img).all() \
                or img.min() < 0 or img.max() > 1:
            fail("frame has the wrong shape or values outside [0, 1]")

    frame_ms = cuda_ms(torch, lambda: r2l_render_image(
        model, c2ws[1], FRAME_H, FRAME_W, FOCAL, NEAR, FAR, N_SAMPLE, L_FREQ,
        device=dev), 10)
    n_rays = FRAME_H * FRAME_W
    fo, fd = rays[0][0].reshape(-1, 3).contiguous(), rays[0][1].reshape(-1, 3).contiguous()
    kern_ms = cuda_ms(torch, lambda: r2l_forward_fused(
        packed, fo, fd, NEAR, FAR, N_SAMPLE, L_FREQ), 10)
    got = r2l_forward_fused(packed, fo, fd, NEAR, FAR, N_SAMPLE, L_FREQ)
    want = r2l_forward_fused_ref(packed, fo, fd, NEAR, FAR, N_SAMPLE, L_FREQ)
    torch.cuda.synchronize()
    # the first rendered frame itself, against the plain version on its rays
    frame_err = max((got - want).abs().max().item(),
                    (frames[0].reshape(-1, 3) - want).abs().max().item())
    print(f"main: frame rays B={n_rays}: max |kernel - plain| {frame_err:.3g} "
          f"(tol {KERNEL_TOL:g}), for the kernel alone and for the frame "
          f"r2l_render_image rendered", flush=True)
    if not frame_err <= KERNEL_TOL:
        fail(f"kernel differs from its plain version by {frame_err} on a frame")
    plain_ms = cuda_ms(torch, lambda: r2l_forward_fused_ref(
        packed, fo, fd, NEAR, FAR, N_SAMPLE, L_FREQ), 3, warmup=1)

    # library yardstick: the unfused path (sample_ray_points -> ray_embed ->
    # R2LNet) with bf16 weights, so that every nn.Linear is a cuBLAS bf16 GEMM
    lib_model = copy.deepcopy(model).to(torch.bfloat16)
    for m in lib_model.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.bfloat16
    library_ms = cuda_ms(torch, lambda: r2l_forward_rays(
        lib_model, fo, fd, NEAR, FAR, N_SAMPLE, L_FREQ, allow_fused=False,
        device=dev), 5)

    flops = r2l_forward_flops(packed, n_rays)
    weight_bytes = sum(t.numel() * t.element_size() for k, t in packed.items()
                       if k in ("head_w", "head_b", "body_w", "body_b",
                                "tail_w", "tail_b"))
    bound_ms, bound_by = bound(flops, n_rays * (3 * 4 * 2 + 3 * 4) + weight_bytes)
    print(f"main: r2l_render_image {frame_ms:.3f} ms/frame "
          f"({n_rays / frame_ms * 1e3 / 1e6:.2f} M rays/s); kernel "
          f"{kern_ms:.3f} ms at B={n_rays}, bound {bound_ms:.3f} ms "
          f"({flops / 1e12:.3f} TFLOP at 989 TFLOP/s) -> "
          f"{bound_ms / kern_ms * 100:.1f}% of the bound; plain version "
          f"{plain_ms:.3f} ms (not a yardstick); unfused cuBLAS bf16 path "
          f"(library_ms) {library_ms:.3f} ms", flush=True)
    sm.entries["r2l_forward_fused"] = {
        "name": "r2l_forward_fused", "route": "cuda",
        "source": "efficient_nerf_tpu_torch/csrc/r2l_forward.cu",
        "replaces": "efficient_nerf_tpu/ops/pallas/r2l_forward.py:505",
        "launches": launches,
        "max_abs_err": max(sm.serve_err, frame_err),
        "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms}


def _int8_errors(torch, got, want):
    """(max, mean, share of rays beyond KERNEL_TOL) of |got - want|."""
    e = (got - want).abs()
    return (e.max().item(), e.mean().item(),
            (e.amax(-1) > KERNEL_TOL).float().mean().item())


def phase_kernel_int8(sm: Smoke) -> None:
    from efficient_nerf_tpu_torch.ops.r2l_int8 import (
        calibrate_r2l_int8, pack_r2l_weights_int8, r2l_forward_int8,
        r2l_forward_int8_ref)

    torch, dev, ko, kd = sm.torch, sm.dev, sm.ko, sm.kd
    sd = {k: v.to(dev) for k, v in sm.sd.items()}
    packed = pack_r2l_weights_int8(sd, N_SAMPLE, L_FREQ)
    act = calibrate_r2l_int8(sd, ko[:INT8_CAL], kd[:INT8_CAL], NEAR, FAR, N_SAMPLE, L_FREQ)
    errs = {"static": 0.0, "dynamic": 0.0}
    for mode, scales in (("static", act), ("dynamic", None)):
        for B, use_res in ((KERNEL_B, False), (KERNEL_B, True), (37, False)):
            o, d = ko[:B].contiguous(), kd[:B].contiguous()
            kw = dict(use_global_residual=use_res, act_scales=scales)
            got = r2l_forward_int8(packed, o, d, NEAR, FAR, N_SAMPLE, L_FREQ, **kw)
            want = r2l_forward_int8_ref(packed, o, d, NEAR, FAR, N_SAMPLE, L_FREQ, **kw)
            torch.cuda.synchronize()
            if got.shape != (B, 3) or not torch.isfinite(got).all():
                fail("int8 kernel output has the wrong shape or is not finite")
            e_max, e_mean, share = _int8_errors(torch, got, want)
            print(f"kernel_int8: W{WIDTH} D{DEPTH} {mode} B={B} use_residual="
                  f"{use_res}: max |kernel - plain| {e_max:.3g} (mean {e_mean:.3g}, "
                  f"tol {INT8_TOL[mode]:g}); share of rays beyond {KERNEL_TOL:g}: "
                  f"{share:.5f}", flush=True)
            if not e_max <= INT8_TOL[mode]:
                fail(f"int8 kernel ({mode}) differs from its plain version by {e_max}")
            errs[mode] = max(errs[mode], e_max)
        o, d = ko.contiguous(), kd.contiguous()
        same = torch.equal(r2l_forward_int8(packed, o, d, NEAR, FAR, N_SAMPLE, L_FREQ,
                                            act_scales=scales),
                           r2l_forward_int8(packed, o, d, NEAR, FAR, N_SAMPLE, L_FREQ,
                                            act_scales=scales))
        print(f"kernel_int8: {mode} B={KERNEL_B}: two calls bit for bit: {same}", flush=True)
        if not same:
            fail(f"two calls of the int8 kernel ({mode}) differ")
    # the noise of summation order alone: the plain version on the host CPU
    # and on the card, on the first NOISE_B of these rays
    cpu = {k: v.cpu() if torch.is_tensor(v) else v for k, v in packed.items()}
    o, d = ko[:NOISE_B], kd[:NOISE_B]
    for mode, scales in (("static", act), ("dynamic", None)):
        want_cpu = r2l_forward_int8_ref(cpu, o.cpu(), d.cpu(), NEAR, FAR, N_SAMPLE,
                                        L_FREQ, act_scales=None if scales is None
                                        else scales.cpu())
        want = r2l_forward_int8_ref(packed, o, d, NEAR, FAR, N_SAMPLE, L_FREQ,
                                    act_scales=scales)
        got = r2l_forward_int8(packed, o, d, NEAR, FAR, N_SAMPLE, L_FREQ,
                               act_scales=scales)
        n_max, n_mean, n_share = _int8_errors(torch, want.cpu(), want_cpu)
        k_max, _, _ = _int8_errors(torch, got, want)
        print(f"kernel_int8: summation-order noise ({mode}), plain version on the "
              f"CPU vs on the card, B={NOISE_B}: max {n_max:.3g} (mean {n_mean:.3g}, "
              f"share beyond {KERNEL_TOL:g} {n_share:.5f}); kernel vs plain on the "
              f"same rays {k_max:.3g}", flush=True)
    sm.int8_err = max(errs.values())
    # the int8 student tile (csrc/r2l_wgmma.cuh with Q 1 static, 2 dynamic;
    # NT output columns a warpgroup, W256 is NT 128; PARTS=1 runs a wide head
    # in parts), one line an instantiation
    from efficient_nerf_tpu_torch.ops import _build

    for cur, lines in sorted(ptxas_report("r2l_int8", "r2l_int8_kernel").items()):
        m = re.search(r"ILi(\d+)ELb([01])ELi(\d)E", cur)
        args = f"NT={m.group(1)}, PARTS={m.group(2)}, Q={m.group(3)}" if m else "?"
        print(f"kernel_int8: r2l_int8_kernel<{args}>: " + "; ".join(lines), flush=True)
    lib = ctypes.CDLL(str(_build.library_path("r2l_int8")))
    lib.r2l_int8_smem_bytes.restype = ctypes.c_longlong
    print(f"kernel_int8: r2l_int8_kernel at W{WIDTH}, in_pad 1024: "
          f"{lib.r2l_int8_smem_bytes(1024, WIDTH)} bytes of dynamic shared memory, 3 "
          f"weight-ring stages of {WIDTH * 64 * 2} bytes", flush=True)


def int8_library_forward(torch, packed, ro, rd, act, res_scale=1.0):
    """The static-scale W8A8 forward unfused, one library call per product:
    the embed and every quantize, dequantize and residual step as torch
    elementwise ops, the head and tail as cuBLAS bf16 GEMMs, each body
    product torch._int_mm (cuBLASLt int8 -> int32). The library yardstick;
    the port never calls it."""
    from efficient_nerf_tpu_torch.ops.r2l_forward import _doubling_embed, _zvals

    x = _doubling_embed(ro, rd, _zvals(NEAR, FAR, N_SAMPLE, ro.device), L_FREQ)
    head_w = packed["head_w"][:, :x.shape[1]]
    h = torch.relu((x.to(torch.bfloat16) @ head_w.t()).float() + packed["head_b"])
    qw, b = packed["body_qw"], packed["body_b"]
    dqs = act[:, :, None] * packed["body_sw"]
    inv = torch.reciprocal(act)
    c0, c1 = dqs[:, 0] * inv[:, 1:], b[:, 0] * inv[:, 1:]
    for i in range(qw.shape[0]):
        q = torch.clamp(torch.round(h * inv[i, 0]), -127, 127).to(torch.int8)
        t = torch._int_mm(q, qw[i, 0].t()).float() * c0[i] + c1[i]
        q = torch.clamp(torch.round(torch.relu(t)), -127, 127).to(torch.int8)
        h = (torch._int_mm(q, qw[i, 1].t()).float() * dqs[i, 1] + b[i, 1]) * res_scale + h
    t = (h.to(torch.bfloat16) @ packed["tail_w"].t()).float() + packed["tail_b"]
    return torch.sigmoid(t)


def phase_main_int8(sm: Smoke) -> None:
    import numpy as np

    from efficient_nerf_tpu_torch.ops import r2l_forward_fused
    from efficient_nerf_tpu_torch.ops.r2l_int8 import (
        pack_r2l_weights_int8, r2l_forward_int8, r2l_forward_int8_ref, r2l_int8_ops)
    from efficient_nerf_tpu_torch.ops.trig import fast_sincos_cuda
    from efficient_nerf_tpu_torch.render import calibrate_serving_scales, r2l_render_image

    torch, dev, rays = sm.torch, sm.dev, sm.rays
    model = sm.model(sm.sd).eval()
    c2ws = [np.asarray(p[:3, :4]) for p in sm.poses]
    fo = rays[0][0].reshape(-1, 3).contiguous()
    fd = rays[0][1].reshape(-1, 3).contiguous()
    # once per checkpoint, as bench.py:91 does: the first 1024 rays of frame 0
    scales = calibrate_serving_scales(model, fo[:INT8_CAL], fd[:INT8_CAL], NEAR, FAR,
                                      N_SAMPLE, L_FREQ)
    r2l_render_image(model, c2ws[0], FRAME_H, FRAME_W, FOCAL, NEAR, FAR, N_SAMPLE,
                     L_FREQ, quant="int8", act_scales=scales)          # warm-up
    torch.cuda.synchronize()
    r2l_forward_int8.launches = 0
    r2l_forward_fused.launches = 0
    fast_sincos_cuda.launches = 0
    # as a user calls it: numpy poses, the default device (CUDA)
    frames = [r2l_render_image(model, c2w, FRAME_H, FRAME_W, FOCAL, NEAR, FAR,
                               N_SAMPLE, L_FREQ, quant="int8", act_scales=scales)
              for c2w in c2ws]
    torch.cuda.synchronize()
    launches = r2l_forward_int8.launches
    print(f"main_int8: 3 frames of {FRAME_H}x{FRAME_W}: r2l_forward_int8 launches "
          f"{launches}, r2l_forward_fused launches {r2l_forward_fused.launches}",
          flush=True)
    if launches != len(frames) or r2l_forward_fused.launches:
        fail(f"expected one int8 launch per frame and no bf16 launch, counted "
             f"{launches} and {r2l_forward_fused.launches}")
    for img in frames:
        if img.shape != (FRAME_H, FRAME_W, 3) or not torch.isfinite(img).all() \
                or img.min() < 0 or img.max() > 1:
            fail("int8 frame has the wrong shape or values outside [0, 1]")

    packed = pack_r2l_weights_int8({k: v.to(dev) for k, v in sm.sd.items()},
                                   N_SAMPLE, L_FREQ)
    kw = dict(act_scales=scales)
    got = r2l_forward_int8(packed, fo, fd, NEAR, FAR, N_SAMPLE, L_FREQ, **kw)
    want = r2l_forward_int8_ref(packed, fo, fd, NEAR, FAR, N_SAMPLE, L_FREQ, **kw)
    torch.cuda.synchronize()
    e_max, e_mean, share = _int8_errors(torch, got, want)
    f_max, f_mean, f_share = _int8_errors(torch, frames[0].reshape(-1, 3), want)
    print(f"main_int8: frame rays B={fo.shape[0]}: max |kernel - plain| {e_max:.3g} "
          f"(mean {e_mean:.3g}, share beyond {KERNEL_TOL:g} {share:.5f}); the frame "
          f"r2l_render_image rendered: max {f_max:.3g} (mean {f_mean:.3g}, share "
          f"{f_share:.5f}); tol {INT8_TOL['static']:g}", flush=True)
    if not max(e_max, f_max) <= INT8_TOL["static"]:
        fail(f"int8 kernel differs from its plain version by {max(e_max, f_max)} "
             f"on a frame")

    n_rays = fo.shape[0]
    frame_ms = cuda_ms(torch, lambda: r2l_render_image(
        model, c2ws[1], FRAME_H, FRAME_W, FOCAL, NEAR, FAR, N_SAMPLE, L_FREQ,
        quant="int8", act_scales=scales), 10)
    kern_ms = cuda_ms(torch, lambda: r2l_forward_int8(
        packed, fo, fd, NEAR, FAR, N_SAMPLE, L_FREQ, **kw), 10)
    dyn_ms = cuda_ms(torch, lambda: r2l_forward_int8(
        packed, fo, fd, NEAR, FAR, N_SAMPLE, L_FREQ), 10)
    bf16_ms = cuda_ms(torch, lambda: r2l_forward_fused(
        sm.packed, fo, fd, NEAR, FAR, N_SAMPLE, L_FREQ), 10)
    plain_ms = cuda_ms(torch, lambda: r2l_forward_int8_ref(
        packed, fo, fd, NEAR, FAR, N_SAMPLE, L_FREQ, **kw), 3, warmup=1)
    lib = int8_library_forward(torch, packed, fo, fd, scales)
    lib_err = (lib - want).abs().max().item()
    library_ms = cuda_ms(torch, lambda: int8_library_forward(
        torch, packed, fo, fd, scales), 5)

    ops8, ops16 = r2l_int8_ops(packed, n_rays)
    weight_bytes = sum(t.numel() * t.element_size() for k, t in packed.items()
                       if k in ("head_w", "head_b", "body_qw", "body_sw", "body_b",
                                "tail_w", "tail_b")) + scales.numel() * 4
    bound_ms, bound_by = bound(ops16, n_rays * (3 * 4 * 2 + 3 * 4) + weight_bytes,
                               int8_ops=ops8)
    print(f"main_int8: r2l_render_image(quant='int8') {frame_ms:.3f} ms/frame "
          f"({n_rays / frame_ms * 1e3 / 1e6:.2f} M rays/s); kernel {kern_ms:.3f} ms "
          f"static, {dyn_ms:.3f} ms dynamic, at B={n_rays}; bound {bound_ms:.3f} ms "
          f"({ops8 / 1e12:.3f} T int8 operations at 1979 TOPS + {ops16 / 1e12:.4f} "
          f"TFLOP at 989 TFLOP/s) -> {bound_ms / kern_ms * 100:.1f}% of the bound; "
          f"bf16 kernel {bf16_ms:.3f} ms on the same rays; plain version "
          f"{plain_ms:.3f} ms (not a yardstick); unfused torch._int_mm path "
          f"(library_ms) {library_ms:.3f} ms (max {lib_err:.3g} from the plain "
          f"version)", flush=True)

    # quality: the int8 frame against the bf16 kernel's frame
    bf16 = r2l_forward_fused(sm.packed, fo, fd, NEAR, FAR, N_SAMPLE, L_FREQ)
    d = (frames[0].reshape(-1, 3) - bf16).abs()
    psnr = -10.0 * torch.log10((d ** 2).mean()).item()
    print(f"main_int8: int8 frame vs the bf16 kernel's frame: max {d.max().item():.3g}, "
          f"mean {d.mean().item():.3g}, PSNR {psnr:.2f} dB", flush=True)
    sm.entries["r2l_forward_int8"] = {
        "name": "r2l_forward_int8", "route": "cuda",
        "source": "efficient_nerf_tpu_torch/csrc/r2l_int8.cu",
        "replaces": "efficient_nerf_tpu/ops/pallas/r2l_int8.py:280",
        "launches": launches, "max_abs_err": max(sm.int8_err, e_max, f_max),
        "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms}


def _train_inputs(sm: Smoke, B: int):
    """Perturbed sample points [B, 48] of B random frame rays, and a random
    output cotangent [B, 3]."""
    from efficient_nerf_tpu_torch.core.ray_sampler import sample_ray_points

    torch = sm.torch
    all_o = torch.cat([o.reshape(-1, 3) for o, _ in sm.rays])
    all_d = torch.cat([d.reshape(-1, 3) for _, d in sm.rays])
    pick = torch.randint(0, all_o.shape[0], (B,), generator=sm.gen, device=sm.dev)
    x = sample_ray_points(all_o[pick], all_d[pick], NEAR, FAR, N_SAMPLE,
                          perturb=True, generator=sm.gen).contiguous()
    dout = torch.randn((B, 3), generator=sm.gen, device=sm.dev)
    return x, dout


def _pass_errors(sm: Smoke, packed, x, hs, dout, kw):
    """Each backward pass against its plain version, and whether two whole
    backward calls give the same gradient bits; fails on a miss. Pass 1 is
    held by the gradients that pass 2's plain version makes of its scratch
    and of the plain scratch (an operand can differ by its whole size where
    a relu mask flips with the summation order, which the ray sums average
    out), and dx; its operands' own max |k - p| / max |p| are printed. Pass 2
    runs on pass 1's own scratch against its plain version."""
    from efficient_nerf_tpu_torch.ops import r2l_train as rt

    torch = sm.torch
    act = rt.r2l_train_bwd_act(packed, x, hs, dout, **kw)
    act_p = rt.r2l_train_bwd_act_ref(packed, x, hs, dout, **kw)
    torch.cuda.synchronize()
    e_ops = {k: rel_err(act[k], act_p[k]) for k in ("dg2", "dg1", "g1", "dpre", "emb",
                                                     "part")}
    g_k, g_p = rt.r2l_train_wgrad_ref(act, hs), rt.r2l_train_wgrad_ref(act_p, hs)
    e_act = {"grad": max(rel_err(g_k[k], g_p[k]) for k in rt._OPERANDS)}
    if act_p["dx"] is not None:
        e_act["dx"] = rel_err(act["dx"], act_p["dx"])
    del act_p, g_k, g_p
    g = rt.r2l_train_wgrad(act, hs)
    g_p = rt.r2l_train_wgrad_ref(act, hs)
    torch.cuda.synchronize()
    e_w = max(rel_err(g[k], g_p[k]) for k in rt._OPERANDS)
    e_w_abs = max((g[k] - g_p[k]).abs().max().item() for k in rt._OPERANDS)
    del act, g, g_p
    # the weight and bias gradients; dx's embed chain sums in shared memory
    # with atomics, in an order that may change
    a = rt.r2l_train_bwd(packed, x, hs, dout, **kw)
    b = rt.r2l_train_bwd(packed, x, hs, dout, **kw)
    same = all(torch.equal(a[k], b[k]) for k in rt._OPERANDS)
    for k, v in e_act.items():
        if not v <= TRAIN_TOL[k]:
            fail(f"backward pass 1's {k} differs from its plain version's by {v:.3g} "
                 f"of its largest magnitude at B={x.shape[0]}")
    if not e_w <= WGRAD_TOL:
        fail(f"backward pass 2 differs from its plain version by {e_w:.3g} of the "
             f"largest magnitude at B={x.shape[0]} (tol {WGRAD_TOL:g})")
    if not same:
        fail(f"two backward calls on the same inputs differ in their bits at B={x.shape[0]}")
    return {"act": e_act, "ops": e_ops, "wgrad": e_w, "wgrad_abs": e_w_abs,
            "same_bits": same}


def phase_train_kernel(sm: Smoke) -> None:
    from efficient_nerf_tpu_torch.ops import r2l_train as rt

    torch = sm.torch
    model = sm.model(sm.sd, dtype=torch.bfloat16)
    packed = rt.pack_r2l_train_weights(rt._model_params(model), L_FREQ, torch.bfloat16)
    errs = {"out": 0.0, "hs": 0.0, "grad": 0.0, "dx": 0.0, "grad_abs": 0.0}
    for B in (KERNEL_B, 37):
        x, dout = _train_inputs(sm, B)
        for use_res in (False, True):
            kw = dict(res_scale=1.0, use_global_residual=use_res)
            out, hs = rt.r2l_train_fwd(packed, x, **kw)
            out_p, hs_p = rt.r2l_train_fwd_ref(packed, x, **kw)
            torch.cuda.synchronize()
            if out.shape != (B, 3) or not torch.isfinite(out).all() \
                    or not torch.isfinite(hs.float()).all():
                fail("training forward output has the wrong shape or is not finite")
            e_out = (out - out_p).abs().max().item()
            e_hs = rel_err(hs, hs_p)
            line = (f"train_kernel: B={B} use_residual={use_res}: forward out "
                    f"{e_out:.3g} (tol {KERNEL_TOL:g}), hs {e_hs:.3g}")
            errs["out"] = max(errs["out"], e_out)
            errs["hs"] = max(errs["hs"], e_hs)
            for need_dx in (False, True):
                # both backwards take the plain forward's hs
                g = rt.r2l_train_bwd(packed, x, hs_p, dout, need_dx=need_dx, **kw)
                g_p = rt.r2l_train_bwd_ref(packed, x, hs_p, dout, need_dx=need_dx, **kw)
                torch.cuda.synchronize()
                if (g["dx"] is None) != (not need_dx):
                    fail("dx is returned exactly when need_dx is on")
                e = {k: rel_err(g[k], g_p[k]) for k in g_p if g_p[k] is not None}
                errs["grad_abs"] = max(errs["grad_abs"], *(
                    (g[k] - g_p[k]).abs().max().item() for k in rt._OPERANDS))
                e_dx = e.pop("dx", 0.0)
                errs["grad"] = max(errs["grad"], *e.values())
                errs["dx"] = max(errs["dx"], e_dx)
                line += (f"; need_dx={need_dx}: gradients "
                         + " ".join(f"{k} {v:.3g}" for k, v in e.items())
                         + (f" dx {e_dx:.3g}" if need_dx else ""))
            print(line, flush=True)
    # the forward at batches at the tile's edges, and two forward calls bit
    # for bit
    for B in RAGGED_B[:1] + RAGGED_B[2:] + (KERNEL_B,):
        x, _ = _train_inputs(sm, B)
        for use_res in (False, True):
            kw = dict(res_scale=1.0, use_global_residual=use_res)
            out, hs = rt.r2l_train_fwd(packed, x, **kw)
            out2, hs2 = rt.r2l_train_fwd(packed, x, **kw)
            out_p, hs_p = rt.r2l_train_fwd_ref(packed, x, **kw)
            torch.cuda.synchronize()
            if out.shape != (B, 3) or hs.shape != hs_p.shape:
                fail(f"training forward output at B={B} has the wrong shape")
            if not (torch.equal(out, out2) and torch.equal(hs, hs2)):
                fail(f"two training forward calls differ in their bits at B={B}")
            errs["out"] = max(errs["out"], (out - out_p).abs().max().item())
            errs["hs"] = max(errs["hs"], rel_err(hs, hs_p))
    print(f"train_kernel: forward at B {', '.join(map(str, RAGGED_B[:1] + RAGGED_B[2:]))} "
          f"and {KERNEL_B}, both use_residual: out and hs within the errors below, two "
          f"calls bit for bit", flush=True)
    # each pass alone at KERNEL_B, and the bits of two backward calls
    x, dout = _train_inputs(sm, KERNEL_B)
    kw = dict(res_scale=1.0, use_global_residual=True, need_dx=True)
    _, hs = rt.r2l_train_fwd_ref(packed, x, use_global_residual=True)
    passes = _pass_errors(sm, packed, x, hs, dout, kw)
    print(f"train_kernel: B={KERNEL_B} pass 1 (r2l_train_bwd_act) vs its plain version: "
          + " ".join(f"{k} {v:.3g}" for k, v in passes["act"].items())
          + " (its operands: " + " ".join(f"{k} {v:.3g}" for k, v in passes["ops"].items())
          + ")"
          + f"; pass 2 (r2l_train_wgrad) on pass 1's scratch vs its plain version "
          f"{passes['wgrad']:.3g} (tol {WGRAD_TOL:g}); two backward calls bit for bit: "
          f"{passes['same_bits']}", flush=True)
    errs["dx"] = max(errs["dx"], passes["act"]["dx"])
    errs["grad"] = max(errs["grad"], passes["act"]["grad"])
    errs["wgrad"] = passes["wgrad"]
    errs["wgrad_abs"] = passes["wgrad_abs"]
    # the noise of summation order alone: the plain versions on the CPU
    # against on the card, on NOISE_B / 4 rays
    x, dout = _train_inputs(sm, NOISE_B // 4)
    cpu = {k: v.cpu() if torch.is_tensor(v) else v for k, v in packed.items()}
    out_p, hs_p = rt.r2l_train_fwd_ref(packed, x)
    out_c, hs_c = rt.r2l_train_fwd_ref(cpu, x.cpu())
    g_p = rt.r2l_train_bwd_ref(packed, x, hs_p, dout)
    g_c = rt.r2l_train_bwd_ref(cpu, x.cpu(), hs_p.cpu(), dout.cpu())
    noise = {k: rel_err(g_p[k].cpu(), g_c[k]) for k in g_p}
    print(f"train_kernel: summation-order noise, plain versions on the CPU vs on "
          f"the card, B={NOISE_B // 4}: out {(out_p.cpu() - out_c).abs().max().item():.3g} "
          f"hs {rel_err(hs_p.cpu(), hs_c):.3g} "
          + " ".join(f"{k} {v:.3g}" for k, v in noise.items()), flush=True)
    if not errs["out"] <= KERNEL_TOL:
        fail(f"training forward differs from its plain version by {errs['out']}")
    for k in ("hs", "grad", "dx"):
        if not errs[k] <= TRAIN_TOL[k]:
            fail(f"training kernels' {k} differs from the plain version by "
                 f"{errs[k]:.3g} of its largest magnitude (tol {TRAIN_TOL[k]})")
    print(f"train_kernel: max errors {json.dumps(errs)} within "
          f"{json.dumps(TRAIN_TOL)}", flush=True)
    sm.train_err = errs


def phase_train(sm: Smoke) -> None:
    from efficient_nerf_tpu_torch.core.ray_sampler import sample_ray_points
    from efficient_nerf_tpu_torch.core.poses import pose_spherical
    from efficient_nerf_tpu_torch.core.rays import get_rays
    from efficient_nerf_tpu_torch.ops import r2l_train as rt
    from efficient_nerf_tpu_torch.render import r2l_forward_rays
    from efficient_nerf_tpu_torch.train import (hard_pool_init, init_train_state,
                                                make_lr_schedule, make_r2l_train_step,
                                                parse_warmup, pick_hard_rays,
                                                update_hard_pool)

    torch, dev, gen = sm.torch, sm.dev, sm.gen
    n_rays = TRAIN_BATCH + TRAIN_HARD[1]
    # rays of TRAIN_FRAMES frames around the object; targets rendered by a
    # second random R2L (another seed) through the served path
    rays = [get_rays(FRAME_H, FRAME_W, FOCAL,
                     pose_spherical(t, -30.0, 4.0)[:3, :4], device=dev)
            for t in torch.linspace(-180.0, 180.0, TRAIN_FRAMES + 1)[:-1].tolist()]
    all_o = torch.cat([o.reshape(-1, 3) for o, _ in rays])
    all_d = torch.cat([d.reshape(-1, 3) for _, d in rays])
    teacher = sm.model(random_state_dict(sm.seed + 1, torch)).eval()
    all_t = r2l_forward_rays(teacher, all_o, all_d, NEAR, FAR, N_SAMPLE, L_FREQ)
    ev = torch.randint(0, all_o.shape[0], (EVAL_B,), generator=gen, device=dev)

    model = sm.model(sm.sd, use_residual=True, dtype=torch.bfloat16)
    # fused: one multi-tensor kernel; the default foreach Adam is bound by
    # the host's launches at these 176 tensors (PERF.md)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4, betas=(0.9, 0.999),
                           eps=1e-8, fused=True)
    schedule = make_lr_schedule(5e-4, 500, parse_warmup("0.0001,200"))
    step = make_r2l_train_step(model, opt, near=NEAR, far=FAR, n_sample=N_SAMPLE,
                               L=L_FREQ, perturb=True, hard=TRAIN_HARD,
                               schedule=schedule)
    state = init_train_state(model, opt)
    pool = hard_pool_init(TRAIN_POOL)

    def batch():
        i = torch.randint(0, all_o.shape[0], (TRAIN_BATCH,), generator=gen, device=dev)
        return all_o[i], all_d[i], all_t[i]

    def eval_mse():
        with torch.no_grad():
            rgb = r2l_forward_rays(model, all_o[ev], all_d[ev], NEAR, FAR,
                                   N_SAMPLE, L_FREQ)
            return ((rgb - all_t[ev]) ** 2).mean().item()

    batches = [batch() for _ in range(TRAIN_STEPS)]
    mse0 = eval_mse()
    torch.cuda.synchronize()
    rt.r2l_train_fwd.launches = 0
    rt.r2l_train_bwd_act.launches = 0
    rt.r2l_train_wgrad.launches = 0
    losses, counts = [], []
    for o, d, t in batches:
        state, pool, metrics = step(state, pool, gen, o, d, t)
        losses.append(metrics["loss_rgb"])
        counts.append(pool.count)
    torch.cuda.synchronize()
    launches = (rt.r2l_train_fwd.launches, rt.r2l_train_bwd_act.launches,
                rt.r2l_train_wgrad.launches)
    losses = [v.item() for v in losses]
    mse1 = eval_mse()
    print(f"train: {TRAIN_STEPS} steps of {n_rays} rays ({TRAIN_BATCH} + "
          f"{TRAIN_HARD[1]} hard, pool {TRAIN_POOL}): r2l_train_fwd launches "
          f"{launches[0]}, backward pass 1 (r2l_train_bwd_act) launches {launches[1]}, "
          f"pass 2 (r2l_train_wgrad) launches {launches[2]}; loss_rgb "
          + " ".join(f"{v:.5f}" for v in losses)
          + f"; pool count {counts}; held-out MSE of the served student on "
          f"{EVAL_B} rays {mse0:.6f} -> {mse1:.6f}", flush=True)
    if launches != (TRAIN_STEPS,) * 3:
        fail(f"expected one launch of each training kernel per step, counted {launches}")
    if not all(v == v and abs(v) != float("inf") for v in losses):
        fail("a training loss is not finite")
    # the step's own loss from step 6 on also carries the 16,384 hardest
    # rays of the pool, so the like-for-like check is the held-out loss of
    # the served student: it also shows that serving sees the trained
    # weights (it fell from 0.0508 to 0.0285 in the first card run; a stale
    # serving pack left it within 0.1%)
    if not mse1 < 0.9 * mse0:
        fail(f"the held-out loss did not fall by a tenth over {TRAIN_STEPS} "
             f"steps: {mse0:.6f} -> {mse1:.6f}")
    fill = -(-TRAIN_POOL // TRAIN_HARD[0])
    if counts[fill - 1:] != [TRAIN_POOL] * (TRAIN_STEPS - fill + 1) \
            or counts[fill - 2] >= TRAIN_POOL:
        fail(f"the pool should fill at step {fill}: counts {counts}")

    # ---- timing: the whole step, then its parts at the step's shapes
    o, d, t = batches[-1]
    step_ms = cuda_ms(torch, lambda: step(state, pool, gen, o, d, t), 5, warmup=1)
    rows = torch.cat([o, d, t], -1)
    o_aug = torch.cat([o, o[:TRAIN_HARD[1]]])
    d_aug = torch.cat([d, d[:TRAIN_HARD[1]]])
    x = sample_ray_points(o_aug, d_aug, NEAR, FAR, N_SAMPLE, perturb=True,
                          generator=gen).contiguous()
    packed = rt.pack_r2l_train_weights(rt._model_params(model), L_FREQ, torch.bfloat16)
    kw = dict(res_scale=model.res_scale, use_global_residual=model.use_residual)
    out, hs = rt.r2l_train_fwd(packed, x, **kw)
    dout = torch.randn(out.shape, generator=gen, device=dev) * 1e-5

    # ---- the kernels against their plain versions at the step's shape,
    # where pass 2 sums the weight gradients of every ray tile
    out_p, hs_p = rt.r2l_train_fwd_ref(packed, x, **kw)
    g = rt.r2l_train_bwd(packed, x, hs_p, dout, need_dx=False, **kw)
    g_p = rt.r2l_train_bwd_ref(packed, x, hs_p, dout, need_dx=False, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all() or not torch.isfinite(hs.float()).all():
        fail("training forward output is not finite at the step's shape")
    full = {"out": (out - out_p).abs().max().item(), "hs": rel_err(hs, hs_p),
            "grad": max(rel_err(g[k], g_p[k]) for k in rt._OPERANDS),
            "grad_abs": max((g[k] - g_p[k]).abs().max().item() for k in rt._OPERANDS)}
    del out_p, g, g_p
    passes = _pass_errors(sm, packed, x, hs_p, dout, dict(need_dx=False, **kw))
    del hs_p
    full["grad"] = max(full["grad"], passes["act"]["grad"])
    print(f"train: kernels vs plain versions at B={n_rays} ({-(-n_rays // 64)} "
          f"ray tiles): forward out {full['out']:.3g} (tol {KERNEL_TOL:g}), hs "
          f"{full['hs']:.3g}, gradients {full['grad']:.3g} of their largest "
          f"magnitude (tol {json.dumps(TRAIN_TOL)}); pass 1 alone "
          + " ".join(f"{k} {v:.3g}" for k, v in passes["act"].items())
          + " (its operands: " + " ".join(f"{k} {v:.3g}" for k, v in passes["ops"].items())
          + ")"
          + f"; pass 2 alone {passes['wgrad']:.3g} (tol {WGRAD_TOL:g}); two backward "
          f"calls bit for bit: {passes['same_bits']}", flush=True)
    if not full["out"] <= KERNEL_TOL:
        fail(f"training forward differs from its plain version by {full['out']} "
             f"at B={n_rays}")
    for k in ("hs", "grad"):
        if not full[k] <= TRAIN_TOL[k]:
            fail(f"training kernels' {k} differs from the plain version by "
                 f"{full[k]:.3g} of its largest magnitude at B={n_rays} "
                 f"(tol {TRAIN_TOL[k]})")
    parts = {
        "sampling": cuda_ms(torch, lambda: sample_ray_points(
            o_aug, d_aug, NEAR, FAR, N_SAMPLE, perturb=True, generator=gen), 10),
        "pack": cuda_ms(torch, lambda: rt.pack_r2l_train_weights(
            rt._model_params(model), L_FREQ, torch.bfloat16), 10),
        "forward kernel": cuda_ms(torch, lambda: rt.r2l_train_fwd(packed, x, **kw), 5),
        "backward (both passes)": cuda_ms(torch, lambda: rt.r2l_train_bwd(
            packed, x, hs, dout, need_dx=False, **kw), 5),
    }
    act = rt.r2l_train_bwd_act(packed, x, hs, dout, need_dx=False, **kw)
    pass_ms = (cuda_ms(torch, lambda: rt.r2l_train_bwd_act(packed, x, hs, dout,
                                                           need_dx=False, **kw), 5),
               cuda_ms(torch, lambda: rt.r2l_train_wgrad(act, hs), 5))
    mse = torch.rand(n_rays, generator=gen, device=dev)

    def mining():
        p, idx = pick_hard_rays(pool, gen, rows, TRAIN_HARD[1])
        update_hard_pool(pool, torch.cat([rows, p]), mse, idx, TRAIN_HARD[0],
                         TRAIN_BATCH)

    parts["hard mining"] = cuda_ms(torch, mining, 10)
    saved = [p.detach().clone() for p in model.parameters()]
    parts["Adam"] = cuda_ms(torch, opt.step, 10)       # on the last step's grads
    with torch.no_grad():
        for p, v in zip(model.parameters(), saved):
            p.copy_(v)
    parts["other (loss, concatenations, autograd)"] = step_ms - sum(parts.values())
    print(f"train: step {step_ms:.3f} ms ({n_rays / step_ms * 1e3 / 1e6:.3f} M "
          f"rays/s); parts, each timed alone at the step's shapes: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in parts.items()), flush=True)

    # ---- each kernel beside its bound, its plain version and cuBLAS
    fwd_flops, bwd_flops = rt.r2l_train_flops(packed, n_rays)
    act_flops, wgrad_flops = rt.r2l_train_pass_flops(packed, n_rays)
    w_bytes = sum(packed[k].numel() * packed[k].element_size()
                  for k in rt._OPERANDS)
    g_bytes = sum(packed[k].numel() * 4 for k in rt._OPERANDS)
    x_bytes, hs_bytes = x.numel() * 4, hs.numel() * 2
    fwd_bound = bound(fwd_flops, x_bytes + w_bytes + out.numel() * 4 + hs_bytes)
    bwd_bound = bound(bwd_flops, x_bytes + w_bytes + hs_bytes + dout.numel() * 4
                      + g_bytes)
    # the two passes' own floors: pass 1 reads the forward's inputs and
    # writes pass 2's scratch, which pass 2 reads with the body's h_in
    scratch = {k: act[k].numel() * act[k].element_size()
               for k in ("dg2", "dg1", "g1", "dpre", "emb", "part")}
    scratch_bytes = sum(scratch.values())
    h_in_bytes = hs[:-1].numel() * 2
    act_bound = bound(act_flops, x_bytes + w_bytes + hs_bytes + dout.numel() * 4
                      + scratch_bytes)
    wgrad_bound = bound(wgrad_flops, scratch_bytes + h_in_bytes + g_bytes)
    plain_fwd = cuda_ms(torch, lambda: rt.r2l_train_fwd_ref(packed, x, **kw), 2, warmup=1)
    plain_bwd = cuda_ms(torch, lambda: rt.r2l_train_bwd_ref(
        packed, x, hs, dout, need_dx=False, **kw), 2, warmup=1)
    plain_act = cuda_ms(torch, lambda: rt.r2l_train_bwd_act_ref(
        packed, x, hs, dout, need_dx=False, **kw), 2, warmup=1)
    plain_wgrad = cuda_ms(torch, lambda: rt.r2l_train_wgrad_ref(act, hs), 2, warmup=1)
    # pass 2's yardstick: one cuBLAS bmm of its 86 body products on the same
    # operands, stacked beforehand (bf16 out; the head's product and the
    # sums left out, 4% of its operations)
    nb = packed["body_w"].shape[0]
    lhs = torch.cat([act["dg1"], act["dg2"]]).transpose(1, 2)
    rhs = torch.cat([torch.nn.functional.pad(hs[:nb], (0, 0, 0, act["dg2"].shape[1] - n_rays)),
                     act["g1"]])
    lib_wgrad = cuda_ms(torch, lambda: torch.bmm(lhs, rhs), 5)
    del lhs, rhs, act
    # library yardstick: the unfused R2LNet with bf16 weights under autograd
    # (every nn.Linear a cuBLAS bf16 GEMM) on the embedded points
    from efficient_nerf_tpu_torch.core.encoding import ray_embed

    lib_model = copy.deepcopy(model).to(torch.bfloat16)
    emb = ray_embed(x, L_FREQ, fast=True)
    lib_fwd = cuda_ms(torch, lambda: lib_model(emb), 5)
    lib_out = lib_model(emb)
    lib_bwd = cuda_ms(torch, lambda: lib_out.backward(dout, retain_graph=True), 5)
    del lib_out, lib_model
    print(f"train: forward kernel {parts['forward kernel']:.3f} ms at B={n_rays}, "
          f"bound {fwd_bound[0]:.3f} ms ({fwd_bound[1]}; {fwd_flops / 1e12:.3f} "
          f"TFLOP), plain {plain_fwd:.3f} ms, unfused cuBLAS forward "
          f"{lib_fwd:.3f} ms; backward {parts['backward (both passes)']:.3f} ms "
          f"(pass 1 {pass_ms[0]:.3f} + pass 2 {pass_ms[1]:.3f} = {sum(pass_ms):.3f} ms "
          f"timed alone), bound {bwd_bound[0]:.3f} ms ({bwd_bound[1]}; "
          f"{bwd_flops / 1e12:.3f} TFLOP), plain {plain_bwd:.3f} ms, unfused cuBLAS "
          f"backward {lib_bwd:.3f} ms: the two passes' sum is "
          f"{'below' if sum(pass_ms) < lib_bwd else 'NOT below'} it", flush=True)
    print(f"train: pass 1 {pass_ms[0]:.3f} ms, bound {act_bound[0]:.3f} ms ({act_bound[1]}; "
          f"{act_flops / 1e12:.3f} TFLOP), plain {plain_act:.3f} ms; pass 2 "
          f"{pass_ms[1]:.3f} ms, bound {wgrad_bound[0]:.3f} ms ({wgrad_bound[1]}; "
          f"{wgrad_flops / 1e12:.3f} TFLOP), plain {plain_wgrad:.3f} ms, cuBLAS bmm of "
          f"its body products {lib_wgrad:.3f} ms; pass 1 writes "
          f"{scratch_bytes / 1e9:.3f} GB of scratch ("
          + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in scratch.items())
          + f"); byte floors: pass 1 {(act_bound[0] if act_bound[1] == 'bytes' else 0):.3f} "
          f"ms, pass 2 {(wgrad_bound[0] if wgrad_bound[1] == 'bytes' else 0):.3f} ms, "
          f"together {(x_bytes + w_bytes + hs_bytes + dout.numel() * 4 + 2 * scratch_bytes + h_in_bytes + g_bytes) / 1e9:.3f} GB, "
          f"{(x_bytes + w_bytes + hs_bytes + dout.numel() * 4 + 2 * scratch_bytes + h_in_bytes + g_bytes) / H100_HBM_BYTES * 1e3:.3f} ms at "
          f"the HBM rate", flush=True)
    errs = sm.train_err
    common = {"route": "cuda", "source": "efficient_nerf_tpu_torch/csrc/r2l_train.cu"}
    sm.entries["r2l_train_fwd"] = {
        "name": "r2l_train_fwd", **common,
        "replaces": "efficient_nerf_tpu/ops/pallas/r2l_train.py:261",
        "launches": launches[0], "max_abs_err": max(errs["out"], full["out"]),
        "ms": parts["forward kernel"], "plain_ms": plain_fwd,
        "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "library_ms": lib_fwd}
    # pass 1 keeps the backward's entry, with the whole backward's yardstick
    # (pass 1 + pass 2 against it is the comparison); the gradients' error
    # is the whole backward's
    sm.entries["r2l_train_bwd"] = {
        "name": "r2l_train_bwd", **common,
        "replaces": "efficient_nerf_tpu/ops/pallas/r2l_train.py:323",
        "launches": launches[1],
        "max_abs_err": max(errs["grad_abs"], full["grad_abs"]),
        "ms": pass_ms[0], "plain_ms": plain_act,
        "bound_ms": act_bound[0], "bound_by": act_bound[1], "library_ms": lib_bwd}
    sm.entries["r2l_train_wgrad"] = {
        "name": "r2l_train_wgrad", "route": "cuda",
        "source": "efficient_nerf_tpu_torch/csrc/r2l_wgrad.cu",
        "replaces": "efficient_nerf_tpu/ops/pallas/r2l_train.py:323",
        "launches": launches[2],
        "max_abs_err": max(errs["wgrad_abs"], passes["wgrad_abs"]),
        "ms": pass_ms[1], "plain_ms": plain_wgrad,
        "bound_ms": wgrad_bound[0], "bound_by": wgrad_bound[1], "library_ms": lib_wgrad}


def teacher_model(seed: int, torch, dev):
    """A random bf16 NeRFMLP D8 W256 on the card: lecun-normal kernels
    (std 1/sqrt(fan_in)) and normal biases of std 0.01."""
    import numpy as np

    from efficient_nerf_tpu_torch.models import NeRFMLP

    rng = np.random.default_rng(seed)
    model = NeRFMLP(depth=T_DEPTH, width=T_WIDTH, dtype=torch.bfloat16)
    with torch.no_grad():
        for name, v in model.named_parameters():
            std = 0.01 if name.endswith("bias") else v.shape[-1] ** -0.5
            v.copy_(torch.from_numpy(
                rng.normal(scale=std, size=tuple(v.shape)).astype(np.float32)))
    return model.to(dev).eval()


def teacher_config():
    from efficient_nerf_tpu_torch.render import RenderConfig

    return RenderConfig(n_samples=T_SAMPLES, n_importance=T_IMPORTANCE,
                        white_bkgd=True, near=NEAR, far=FAR, multires=T_L,
                        multires_views=T_LV, chunk=T_CHUNK)


def _teacher_rays(sm: Smoke, pose):
    from efficient_nerf_tpu_torch.core.rays import get_rays

    o, d = get_rays(FRAME_H, FRAME_W, T_FOCAL, pose[:3, :4], device=sm.dev)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    return o, d, (d / d.norm(dim=-1, keepdim=True)).contiguous()


def _frame_points(sm: Smoke, o, d, vd, n_rays: int, S: int):
    """Points of n_rays random frame rays at S sorted depths in [near, far]
    (the fine pass's depths are sorted, not even), and their directions."""
    torch = sm.torch
    i = torch.randint(0, o.shape[0], (n_rays,), generator=sm.gen, device=sm.dev)
    z = torch.sort(NEAR + (FAR - NEAR) * torch.rand(
        (n_rays, S), generator=sm.gen, device=sm.dev), dim=-1).values
    return (o[i, None] + d[i, None] * z[..., None]).contiguous(), vd[i].contiguous()


def _field_errors(got, want):
    """max |got - want| / max |want| of sigma (channel 3) and of rgb."""
    return {"sigma": rel_err(got[..., 3], want[..., 3]),
            "rgb": rel_err(got[..., :3], want[..., :3]),
            "abs": (got - want).abs().max().item()}


def phase_teacher_kernel(sm: Smoke) -> None:
    from efficient_nerf_tpu_torch.core.sampling import linear_zvals
    from efficient_nerf_tpu_torch.core.volume import raw2outputs
    from efficient_nerf_tpu_torch.ops import _build
    from efficient_nerf_tpu_torch.ops.nerf_forward import (
        nerf_forward_flops, nerf_forward_fused, nerf_forward_fused_ref, pack_nerf_weights)
    from efficient_nerf_tpu_torch.ops.sample_pdf import (
        sample_pdf_det_fused, sample_pdf_det_fused_ref)

    torch, dev, gen = sm.torch, sm.dev, sm.gen
    sm.teacher = teacher_model(sm.seed, torch, dev)
    packed = pack_nerf_weights(sm.teacher.state_dict(), dtype=torch.bfloat16)
    o, d, vd = _teacher_rays(sm, sm.poses[0])

    def points(n_rays, S):
        return _frame_points(sm, o, d, vd, n_rays, S)

    worst = {"sigma": 0.0, "rgb": 0.0, "abs": 0.0}
    for n_rays, S, cm in ((512, 64, False), (256, 192, False), (37, 64, True),
                          (37, 192, False)):
        pts, dirs = points(n_rays, S)
        x = pts.permute(2, 0, 1).contiguous() if cm else pts
        got = nerf_forward_fused(packed, x, dirs, T_L, T_LV, cm=cm)
        want = nerf_forward_fused_ref(packed, x, dirs, T_L, T_LV, cm=cm)
        torch.cuda.synchronize()
        if cm:
            got, want = got.permute(1, 2, 0), want.permute(1, 2, 0)
        if got.shape != (n_rays, S, 4) or not torch.isfinite(got).all():
            fail("field-eval kernel output has the wrong shape or is not finite")
        e = _field_errors(got, want)
        print(f"teacher_kernel: nerf_forward_fused W{T_WIDTH} D{T_DEPTH} {n_rays} x "
              f"{S}{' (cm)' if cm else ''}: sigma {e['sigma']:.3g}, rgb {e['rgb']:.3g} "
              f"of max |plain| (tol {TEACHER_TOL:g}); max abs {e['abs']:.3g}", flush=True)
        worst = {k: max(worst[k], v) for k, v in e.items()}
    # the noise that summation order alone makes: the plain version on the
    # host CPU against on the card
    pts, dirs = points(64, 64)
    cpu = {k: v.cpu() if torch.is_tensor(v) else v for k, v in packed.items()}
    want = nerf_forward_fused_ref(packed, pts, dirs, T_L, T_LV)
    want_cpu = nerf_forward_fused_ref(cpu, pts.cpu(), dirs.cpu(), T_L, T_LV)
    got = nerf_forward_fused(packed, pts, dirs, T_L, T_LV)
    noise, k_e = _field_errors(want.cpu(), want_cpu), _field_errors(got, want)
    print(f"teacher_kernel: summation-order noise, plain version on the CPU vs on "
          f"the card, 64 x 64: sigma {noise['sigma']:.3g}, rgb {noise['rgb']:.3g} "
          f"(abs {noise['abs']:.3g}); kernel vs plain on the same points: sigma "
          f"{k_e['sigma']:.3g}, rgb {k_e['rgb']:.3g}", flush=True)
    if not max(worst["sigma"], worst["rgb"]) <= TEACHER_TOL:
        fail(f"field-eval kernel differs from its plain version by {worst}")

    # the main path's chunk shapes (16,384 and 49,152 tiles): the kernel
    # against its plain version, two calls bit for bit, and its time
    # beside its bound
    lib = ctypes.CDLL(str(_build.library_path("nerf_forward")))
    lib.nerf_forward_smem_bytes.restype = ctypes.c_longlong
    sizes = []
    for S in (T_SAMPLES, T_SAMPLES + T_IMPORTANCE):
        pts, dirs = points(T_CHUNK, S)
        got = nerf_forward_fused(packed, pts, dirs, T_L, T_LV)
        again = nerf_forward_fused(packed, pts, dirs, T_L, T_LV)
        e = _field_errors(got, nerf_forward_fused_ref(packed, pts, dirs, T_L, T_LV))
        same = bool(torch.equal(got, again))
        del got, again
        torch.cuda.empty_cache()
        ms = cuda_ms(torch, lambda: nerf_forward_fused(packed, pts, dirs, T_L, T_LV), 5)
        b = bound(nerf_forward_flops(packed, T_CHUNK * S, T_CHUNK), T_CHUNK * S * 28 + T_CHUNK * 12)
        print(f"teacher_kernel: nerf_forward_fused {T_CHUNK} x {S}: sigma {e['sigma']:.3g}, rgb "
              f"{e['rgb']:.3g} of max |plain| (tol {TEACHER_TOL:g}); max abs {e['abs']:.3g}; two "
              f"calls bit for bit: {same}; {ms:.3f} ms against a bound of {b[0]:.3f} ms "
              f"({b[1]}) -> {b[0] / ms * 100:.1f}%", flush=True)
        if not max(e["sigma"], e["rgb"]) <= TEACHER_TOL or not same:
            fail(f"field-eval kernel at {T_CHUNK} x {S}: errors {e}, bit for bit {same}")
        worst = {k: max(worst[k], v) for k, v in e.items()}
        sizes.append((f"S={S}", lib.nerf_forward_smem_bytes(64, T_WIDTH, T_DEPTH, S),
                      lib.nerf_forward_ring_stages(64, T_WIDTH, T_DEPTH, S)))
    print_tile("teacher_kernel", "nerf_forward", "nerf_forward_kernel", sizes)

    # the sampler on a coarse pass's own weights at the chunk's 32,768 rays
    n = T_CHUNK
    z = linear_zvals(NEAR, FAR, T_SAMPLES, device=dev).expand(n, T_SAMPLES)
    ro, rdir, rvd = o[:n], d[:n], vd[:n]
    raw = nerf_forward_fused(packed, (ro[:, None] + rdir[:, None] * z[..., None]).contiguous(),
                             rvd, T_L, T_LV)
    weights = raw2outputs(raw, z, rdir, white_bkgd=True).weights
    bins = (0.5 * (z[:, 1:] + z[:, :-1])).contiguous()
    w = weights[:, 1:-1].contiguous()
    w[0] = 0.0                      # all-zero weights
    w[1] = 0.0
    w[1, 17] = 3.0                  # a single spike

    def cdf_total(rows):
        """Each row's CDF total, summed as both versions sum it."""
        rows = rows + 1e-5
        total = torch.zeros_like(rows[:, 0])
        for i in range(rows.shape[1]):
            total = total + rows[:, i]
        cdf = torch.zeros_like(total)
        for i in range(rows.shape[1]):
            cdf = cdf + rows[:, i] / total
        return cdf

    # a row whose CDF total rounds above 1: the first of uniform random rows
    cand = torch.rand((256, w.shape[1]), generator=gen, device=dev)
    above = (cdf_total(cand) > 1).nonzero()
    if above.numel() == 0:
        fail("found no weight row whose CDF total rounds above 1")
    w[2] = cand[above[0, 0]]
    n_above = int((cdf_total(w) > 1).sum().item())
    got = sample_pdf_det_fused(bins, w, T_IMPORTANCE)
    want = sample_pdf_det_fused_ref(bins, w, T_IMPORTANCE)
    torch.cuda.synchronize()
    n_diff = int((got != want).sum().item())
    pdf_err = (got - want).abs().max().item()
    sorted_ok = bool((got[:, 1:] >= got[:, :-1]).all().item())
    print(f"teacher_kernel: sample_pdf_det_fused on {n} rays of coarse weights "
          f"(C {bins.shape[1]}, n {T_IMPORTANCE}; row 0 all zero, row 1 one spike, "
          f"{n_above} rows with a CDF total above 1, row 2 among them): "
          f"{n_diff} values differ from the plain version, max {pdf_err:.3g} "
          f"(tol 0: bit for bit); sorted {sorted_ok}", flush=True)
    if n_diff or not sorted_ok:
        fail("inverse-CDF kernel differs from its plain version")
    sm.teacher_packed = packed
    sm.teacher_err = worst["abs"]
    sm.pdf_err = pdf_err


def _render_plain(sm: Smoke, model, c2w, cfg, chunk: int = 8192):
    """render_image with every kernel call of the renderer replaced by its
    plain version (on the card), `chunk` rays a chunk."""
    import dataclasses

    from efficient_nerf_tpu_torch.ops import nerf_frame, nerf_int8
    from efficient_nerf_tpu_torch.ops.nerf_forward import nerf_forward_fused_ref
    from efficient_nerf_tpu_torch.ops.sample_pdf import sample_pdf_det_fused_ref
    from efficient_nerf_tpu_torch.render import renderer

    names = ("nerf_forward_fused", "sample_pdf_det_fused", "nerf_forward_int8",
             "nerf_render_rays_fused")
    saved = [getattr(renderer, k) for k in names]
    for k, ref in zip(names, (nerf_forward_fused_ref, sample_pdf_det_fused_ref,
                              nerf_int8.nerf_forward_int8_ref,
                              nerf_frame.nerf_render_rays_fused_ref)):
        setattr(renderer, k, ref)
    try:
        return renderer.render_image(model, None, FRAME_H, FRAME_W, T_FOCAL, c2w,
                                     dataclasses.replace(cfg, chunk=chunk), device=sm.dev)
    finally:
        for k, fn in zip(names, saved):
            setattr(renderer, k, fn)


def _frame_diff(sm: Smoke, label: str, got, want) -> float:
    """Prints how far two renders of a frame lie apart, per ray under
    FRAME_TOL; returns the share of rays beyond it."""
    torch = sm.torch
    n_rays = FRAME_H * FRAME_W
    diff = {k: (getattr(got, k) - getattr(want, k)).abs().reshape(n_rays, -1).amax(-1)
            for k in FRAME_TOL}
    beyond = torch.zeros(n_rays, dtype=torch.bool, device=sm.dev)
    for k in FRAME_TOL:
        beyond |= diff[k] > FRAME_TOL[k]
    share = beyond.float().mean().item()
    print(f"{label}: "
          + ", ".join(f"{k} max {diff[k].max().item():.3g} mean {diff[k].mean().item():.3g}, "
                      f"{diff[k][~beyond].max().item():.3g} over the rays within tol "
                      f"{FRAME_TOL[k]:g}" for k in FRAME_TOL)
          + f"; {int(beyond.sum().item())} rays beyond (share {share:.2e}, at most "
          f"{FRAME_SHARE:g})", flush=True)
    return share


def phase_teacher(sm: Smoke) -> None:
    import numpy as np

    from efficient_nerf_tpu_torch.core.encoding import nerf_embed
    from efficient_nerf_tpu_torch.core.sampling import linear_zvals, merge_sorted
    from efficient_nerf_tpu_torch.core.volume import raw2outputs
    from efficient_nerf_tpu_torch.ops.nerf_forward import (
        nerf_forward_flops, nerf_forward_fused, nerf_forward_fused_ref)
    from efficient_nerf_tpu_torch.ops.sample_pdf import (
        sample_pdf_det_fused, sample_pdf_det_fused_ref)
    from efficient_nerf_tpu_torch.ops.trig import fast_sincos_cuda
    from efficient_nerf_tpu_torch.render import render_image

    torch, dev = sm.torch, sm.dev
    model, packed = sm.teacher, sm.teacher_packed
    cfg = teacher_config().eval_mode()
    c2ws = [np.asarray(p[:3, :4]) for p in sm.poses]
    render_image(model, None, FRAME_H, FRAME_W, T_FOCAL, c2ws[0], cfg)   # warm-up
    torch.cuda.synchronize()
    nerf_forward_fused.launches = 0
    sample_pdf_det_fused.launches = 0
    fast_sincos_cuda.launches = 0
    # as a user calls it: numpy poses, the default device (CUDA)
    frames = [render_image(model, None, FRAME_H, FRAME_W, T_FOCAL, c2w, cfg)
              for c2w in c2ws]
    torch.cuda.synchronize()
    launches = (nerf_forward_fused.launches, sample_pdf_det_fused.launches)
    n_rays = FRAME_H * FRAME_W
    chunks = -(-n_rays // T_CHUNK)
    print(f"teacher: 3 frames of {FRAME_H}x{FRAME_W} ({chunks} chunks of up to "
          f"{T_CHUNK} rays each): nerf_forward_fused launches {launches[0]}, "
          f"sample_pdf_det_fused launches {launches[1]}", flush=True)
    if launches != (2 * chunks * len(frames), chunks * len(frames)):
        fail(f"expected {2 * chunks} field-eval and {chunks} sampler launches a "
             f"frame, counted {launches} over {len(frames)} frames")
    for f in frames:
        if f.rgb.shape != (FRAME_H, FRAME_W, 3) or not torch.isfinite(f.rgb).all() \
                or f.rgb.min() < 0 or f.rgb.max() > 1 + 1e-6 \
                or not torch.isfinite(f.depth).all() or not torch.isfinite(f.acc).all():
            fail("teacher frame has the wrong shape, values that are not finite "
                 "or rgb outside [0, 1]")
    acc = frames[0].acc
    acc_mean = acc.mean().item()
    acc_mid = ((acc > 0.01) & (acc < 0.99)).float().mean().item()
    print(f"teacher: frame 0 mean acc {acc_mean:.4f}, share of rays with acc in "
          f"(0.01, 0.99) {acc_mid:.4f}, rgb in [{frames[0].rgb.min().item():.4f}, "
          f"{frames[0].rgb.max().item():.4f}]", flush=True)
    if not 0.01 < acc_mid:
        fail("the teacher frame is degenerate: almost no ray is partly opaque")

    plain = _render_plain(sm, model, c2ws[0], cfg)
    torch.cuda.synchronize()
    frame_share = _frame_diff(sm, "teacher: frame 0 against the same frame through the "
                              "plain versions", frames[0], plain)
    if frame_share > FRAME_SHARE:
        fail(f"teacher frame differs from the plain versions' frame in a share "
             f"{frame_share:.2e} of its rays")
    del plain
    sm.teacher_frame0 = frames[0]

    frame_ms = cuda_ms(torch, lambda: render_image(
        model, None, FRAME_H, FRAME_W, T_FOCAL, c2ws[1], cfg), 3, warmup=1)

    # ---- each kernel at the main path's chunk: the first 32,768 rays of
    # frame 1, coarse and fine, as render_rays builds them
    o, d, vd = _teacher_rays(sm, sm.poses[1])
    n = T_CHUNK
    o, d, vd = o[:n], d[:n], vd[:n]
    z_c = linear_zvals(NEAR, FAR, T_SAMPLES, device=dev).expand(n, T_SAMPLES)
    pts_c = (o[:, None] + d[:, None] * z_c[..., None]).contiguous()
    raw_c = nerf_forward_fused(packed, pts_c, vd, T_L, T_LV)
    w = raw2outputs(raw_c, z_c, d, white_bkgd=True).weights[:, 1:-1].contiguous()
    bins = (0.5 * (z_c[:, 1:] + z_c[:, :-1])).contiguous()
    z_f = merge_sorted(z_c, sample_pdf_det_fused(bins, w, T_IMPORTANCE))
    pts_f = (o[:, None] + d[:, None] * z_f[..., None]).contiguous()
    S_f = T_SAMPLES + T_IMPORTANCE
    sm.chunk = {"o": o, "d": d, "vd": vd, "coarse": pts_c, "fine": pts_f}

    # kernel 5 against its plain version on the same points, at the main
    # path's own chunk shapes (16,384 and 49,152 tiles)
    chunk_err = {"sigma": 0.0, "rgb": 0.0, "abs": 0.0}
    for name, pts in (("coarse", pts_c), ("fine", pts_f)):
        e = _field_errors(nerf_forward_fused(packed, pts, vd, T_L, T_LV),
                          nerf_forward_fused_ref(packed, pts, vd, T_L, T_LV))
        torch.cuda.empty_cache()
        print(f"teacher: nerf_forward_fused {name} chunk {n} x {pts.shape[1]} against "
              f"its plain version: sigma {e['sigma']:.3g}, rgb {e['rgb']:.3g} of max "
              f"|plain| (tol {TEACHER_TOL:g}); max abs {e['abs']:.3g}", flush=True)
        chunk_err = {k: max(chunk_err[k], v) for k, v in e.items()}
    if not max(chunk_err["sigma"], chunk_err["rgb"]) <= TEACHER_TOL:
        fail(f"field-eval kernel differs from its plain version at the chunk's "
             f"shape by {chunk_err}")

    def lib_path(pts):
        """The unfused field eval: nerf_embed -> bf16 NeRFMLP, each linear a
        cuBLAS bf16 GEMM (the library yardstick; the port never calls it)."""
        with torch.no_grad():
            emb = nerf_embed(pts, T_L, fast=True)
            de = nerf_embed(vd, T_LV, fast=True)[:, None].expand(pts.shape[:-1] + (27,))
            return model(torch.cat([emb, de], dim=-1))

    times = {}
    for name, pts in (("coarse", pts_c), ("fine", pts_f)):
        times[name] = {
            "ms": cuda_ms(torch, lambda: nerf_forward_fused(packed, pts, vd, T_L, T_LV), 5),
            "plain_ms": cuda_ms(torch, lambda: nerf_forward_fused_ref(
                packed, pts, vd, T_L, T_LV), 1, warmup=1),
            "library_ms": cuda_ms(torch, lambda: lib_path(pts), 3, warmup=1),
        }
        torch.cuda.empty_cache()
    lib_err = (lib_path(pts_c) - nerf_forward_fused_ref(packed, pts_c, vd, T_L, T_LV)
               ).abs().max().item()
    # kernel 6 on the main path's chunk (frame 1's own coarse weights)
    # against its plain version, bit for bit
    z_s, z_sp = sample_pdf_det_fused(bins, w, T_IMPORTANCE), sample_pdf_det_fused_ref(
        bins, w, T_IMPORTANCE)
    torch.cuda.synchronize()
    n_zdiff = int((z_s != z_sp).sum().item())
    print(f"teacher: sample_pdf_det_fused on the chunk's {n} rays: {n_zdiff} values differ "
          f"from the plain version (tol 0: bit for bit)", flush=True)
    if n_zdiff:
        fail("inverse-CDF kernel differs from its plain version on the main path's chunk")
    del z_s, z_sp
    pdf_ms = cuda_ms(torch, lambda: sample_pdf_det_fused(bins, w, T_IMPORTANCE), 20)
    pdf_plain_ms = cuda_ms(torch, lambda: sample_pdf_det_fused_ref(bins, w, T_IMPORTANCE),
                           2, warmup=1)

    w_bytes = sum(packed[k].numel() * packed[k].element_size() for k in packed
                  if torch.is_tensor(packed[k]))
    flops = {k: nerf_forward_flops(packed, n * S, n) for k, S in
             (("coarse", T_SAMPLES), ("fine", S_f))}
    nbytes = {k: n * S * (12 + 16) + n * 12 + w_bytes for k, S in
              (("coarse", T_SAMPLES), ("fine", S_f))}
    chunk_bound = bound(flops["coarse"] + flops["fine"],
                        nbytes["coarse"] + nbytes["fine"])
    frame_flops = nerf_forward_flops(packed, n_rays * (T_SAMPLES + S_f), 2 * n_rays)
    frame_bound = bound(frame_flops, n_rays * (T_SAMPLES + S_f) * 28 + 2 * n_rays * 12)
    pdf_bytes = n * (bins.shape[1] + w.shape[1] + T_IMPORTANCE) * 4 + T_IMPORTANCE * 4
    pdf_bound = bound(0, pdf_bytes)
    for k in ("coarse", "fine"):
        b = bound(flops[k], nbytes[k])
        t = times[k]
        print(f"teacher: nerf_forward_fused {k} chunk {n} x "
              f"{T_SAMPLES if k == 'coarse' else S_f}: kernel {t['ms']:.3f} ms, bound "
              f"{b[0]:.3f} ms ({flops[k] / 1e12:.3f} TFLOP, {b[1]}) -> "
              f"{b[0] / t['ms'] * 100:.1f}% of the bound; plain version "
              f"{t['plain_ms']:.3f} ms (not a yardstick); unfused nerf_embed -> bf16 "
              f"NeRFMLP cuBLAS path (library_ms) {t['library_ms']:.3f} ms", flush=True)
    print(f"teacher: render_image {frame_ms:.3f} ms/frame ({n_rays / frame_ms * 1e3 / 1e6:.3f} "
          f"M rays/s); the frame's field evals bound {frame_bound[0]:.3f} ms "
          f"({frame_flops / 1e12:.3f} TFLOP, {frame_bound[1]}); sample_pdf_det_fused "
          f"{pdf_ms:.4f} ms at {n} rays, bound {pdf_bound[0]:.4f} ms ({pdf_bound[1]}), "
          f"plain version {pdf_plain_ms:.3f} ms; the library path is {lib_err:.3g} from "
          f"the plain version on the coarse chunk", flush=True)
    sm.teacher_frame_ms = frame_ms
    sm.teacher_frame_bound = frame_bound[0]
    sm.entries["nerf_forward_fused"] = {
        "name": "nerf_forward_fused", "route": "cuda",
        "source": "efficient_nerf_tpu_torch/csrc/nerf_forward.cu",
        "replaces": "efficient_nerf_tpu/ops/pallas/nerf_forward.py:410",
        "launches": launches[0], "max_abs_err": max(sm.teacher_err, chunk_err["abs"]),
        # one coarse and one fine launch of a 32,768-ray chunk
        "ms": times["coarse"]["ms"] + times["fine"]["ms"],
        "plain_ms": times["coarse"]["plain_ms"] + times["fine"]["plain_ms"],
        "bound_ms": chunk_bound[0], "bound_by": chunk_bound[1],
        "library_ms": times["coarse"]["library_ms"] + times["fine"]["library_ms"]}
    sm.entries["sample_pdf_det_fused"] = {
        "name": "sample_pdf_det_fused", "route": "cuda",
        "source": "efficient_nerf_tpu_torch/csrc/sample_pdf.cu",
        "replaces": "efficient_nerf_tpu/ops/pallas/sample_pdf.py:138",
        "launches": launches[1], "max_abs_err": sm.pdf_err,
        "ms": pdf_ms, "plain_ms": pdf_plain_ms, "bound_ms": pdf_bound[0],
        "bound_by": pdf_bound[1], "library_ms": None}


def phase_pseudo(sm: Smoke) -> None:
    import os

    import numpy as np

    from efficient_nerf_tpu_torch.core.poses import random_spherical_pose
    from efficient_nerf_tpu_torch.data import (SHARD_ROWS, StreamingPseudoGenerator,
                                               export_pseudo_shards,
                                               make_pseudo_frame_renderer)
    from efficient_nerf_tpu_torch.ops.nerf_forward import nerf_forward_fused
    from efficient_nerf_tpu_torch.ops.sample_pdf import sample_pdf_det_fused

    torch, model = sm.torch, sm.teacher
    cfg = teacher_config()
    gen = StreamingPseudoGenerator(
        model, None, cfg, FRAME_H, FRAME_W, T_FOCAL, batch_rays=4096,
        buffer_rays=1_000_000, warmup_frames=1, frames_per_batch=1.0,
        rng=np.random.default_rng(sm.seed))
    next(gen)                               # one frame through the pipeline
    torch.cuda.synchronize()
    nerf_forward_fused.launches = 0
    sample_pdf_det_fused.launches = 0
    t0 = time.perf_counter()
    for _ in range(PSEUDO_FRAMES):
        o, d, t = next(gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / PSEUDO_FRAMES
    launches = (nerf_forward_fused.launches, sample_pdf_det_fused.launches)
    if o.shape != (4096, 3) or t.shape != (4096, 3) or not np.isfinite(t).all() \
            or gen.buffer.size == 0:
        fail("StreamingPseudoGenerator gave a malformed batch")
    print(f"pseudo: StreamingPseudoGenerator {ms:.3f} ms/frame over {PSEUDO_FRAMES} "
          f"frames (one new frame a batch, one-frame pipeline), against "
          f"render_image alone {sm.teacher_frame_ms:.3f} ms/frame; "
          f"nerf_forward_fused launches {launches[0]}, sample_pdf_det_fused launches "
          f"{launches[1]}; buffer {gen.buffer.size} rows", flush=True)
    chunks = -(-FRAME_H * FRAME_W // T_CHUNK)
    if launches != (PSEUDO_FRAMES * 2 * chunks, PSEUDO_FRAMES * chunks):
        fail(f"pseudo frames launched the field eval and the sampler {launches} times")
    del gen

    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        last = export_pseudo_shards(model, None, cfg, FRAME_H, FRAME_W, T_FOCAL, out,
                                    PSEUDO_POSES, seed=sm.seed)
        export_s = time.perf_counter() - t0
        files = sorted(os.listdir(out))
        shards = [np.load(os.path.join(out, f)) for f in files]
    n_rows = PSEUDO_POSES * FRAME_H * FRAME_W
    if last != n_rows // SHARD_ROWS or len(shards) != n_rows // SHARD_ROWS \
            or any(s.shape != (SHARD_ROWS, 9) for s in shards):
        fail(f"export_pseudo_shards wrote {len(shards)} files (last index {last})")
    # the frames' own rows, rendered again from the same poses and focal
    # scales (the exporter's generator, seeded alike)
    rng = np.random.default_rng(sm.seed)
    render = make_pseudo_frame_renderer(model, None, cfg, FRAME_H, FRAME_W, T_FOCAL)
    frame_rows = set()
    for _ in range(PSEUDO_POSES):
        pose = random_spherical_pose(rng)
        rows = render(pose[:3, :4], 1.0 + rng.random()).cpu().numpy()
        frame_rows.update(map(bytes, rows))
    shard_rows = np.concatenate(shards)
    in_frames = sum(bytes(r) in frame_rows for r in shard_rows)
    distinct = len(set(map(bytes, shard_rows)))
    print(f"pseudo: export_pseudo_shards for {PSEUDO_POSES} poses in {export_s:.2f} s: "
          f"{len(shards)} shards of [{SHARD_ROWS}, 9]; {in_frames} of "
          f"{shard_rows.shape[0]} rows are rows of the frames, {distinct} distinct",
          flush=True)
    if in_frames != shard_rows.shape[0] or distinct != shard_rows.shape[0]:
        fail("the shards' rows are not a permutation of the frames' rows")


def int8_teacher_library_forward(torch, packed, pts, vd, act):
    """The int8 field eval unfused, one library call per product: the embed
    and every quantize and dequantize as torch elementwise ops, the bf16
    products as cuBLAS GEMMs, each int8 product torch._int_mm (cuBLASLt int8
    -> int32). The library yardstick; the port never calls it."""
    from efficient_nerf_tpu_torch.ops.nerf_forward import _linearized_embed, embed_dirs
    from efficient_nerf_tpu_torch.ops.nerf_int8 import _fold

    bf, i8 = torch.bfloat16, torch.int8
    N, S = pts.shape[:2]
    ic, depth, skip = packed["in_ch"], packed["depth"], packed["skip"]
    k = _fold(packed, act)

    def levels(x):
        return torch.clamp(torch.round(x), -127, 127).to(i8)

    e = _linearized_embed(pts.reshape(-1, 3), T_L).to(bf)
    h = torch.relu((e @ packed["pts0_w"][:, :ic].t()).float() + packed["pts0_b"].float())
    q = levels(h * k["invs"][0])
    for i in range(1, depth):
        t = torch._int_mm(q, packed["body_qw"][i - 1].t()).float() * k["body_dqs"][i - 1] \
            + k["body_b"][i - 1]
        if i == skip + 1:
            t = t + (e @ k["skip_x_w"][:, :ic].t()).float()
        if i < depth - 1:
            q = levels(torch.relu(t))
        else:
            h = torch.relu(t)
    alpha = (h.to(bf) @ packed["alpha_w"][:, None]).float()
    feat = (torch._int_mm(levels(h * k["invs"][1]), packed["feat_qw"].t()).float()
            * k["feat_dqs"] + packed["feat_b_f32"]).to(bf)
    hv_d = (embed_dirs(vd, T_LV).to(bf) @ packed["views_d_w"].t()).float()
    hv = torch.relu((feat @ packed["views_h_w"].t()).float() + hv_d.repeat_interleave(S, 0)
                    + packed["views_b"].float())
    rgb = (hv.to(bf) @ packed["rgb_w"].t()).float()
    out_b = packed["out_b"]
    return torch.cat([rgb + out_b[:3], alpha + out_b[3:]], -1).reshape(N, S, 4)


def _int8_field_errors(got, want):
    """_field_errors and the share of points whose sigma or rgb lies beyond
    TEACHER_TOL (the bf16 kernel's tolerance) of max |plain|."""
    e = _field_errors(got, want)
    far = ((got[..., 3] - want[..., 3]).abs() > TEACHER_TOL * want[..., 3].abs().max()) | \
        ((got[..., :3] - want[..., :3]).abs().amax(-1) > TEACHER_TOL * want[..., :3].abs().max())
    e["share"] = far.float().mean().item()
    return e


def phase_teacher_int8_kernel(sm: Smoke) -> None:
    from efficient_nerf_tpu_torch.ops.nerf_forward import pack_nerf_weights
    from efficient_nerf_tpu_torch.ops.nerf_int8 import (
        calibrate_nerf_int8, nerf_forward_int8, nerf_forward_int8_ref, pack_nerf_weights_int8)

    torch = sm.torch
    sd = sm.teacher.state_dict()
    packed = pack_nerf_weights_int8(sd, skip=4, dtype=torch.bfloat16)
    packed32 = pack_nerf_weights(sd, skip=4, dtype=torch.float32)
    o, d, vd = _teacher_rays(sm, sm.poses[0])
    cases = [(f"{n} x {S}", *_frame_points(sm, o, d, vd, n, S), cm) for n, S, cm in (
        (512, 64, False), (256, 192, False), (37, 64, True), (37, 192, False))]
    c = sm.chunk
    cases += [(f"the {k} chunk {T_CHUNK} x {c[k].shape[1]}", c[k], c["vd"], False)
              for k in ("coarse", "fine")]
    worst = {"sigma": 0.0, "rgb": 0.0, "abs": 0.0, "share": 0.0}
    for label, pts, dirs, cm in cases:
        # the renderer's rule: scales from the call's first 1024 points
        act = calibrate_nerf_int8(packed32, pts.reshape(-1, 3)[:1024], T_L)
        x = pts.permute(2, 0, 1).contiguous() if cm else pts
        got = nerf_forward_int8(packed, x, dirs, T_L, T_LV, act_scales=act, cm=cm)
        if label.startswith("the "):   # the chunk shapes: two calls bit for bit
            same = torch.equal(got, nerf_forward_int8(packed, x, dirs, T_L, T_LV,
                                                      act_scales=act, cm=cm))
            print(f"teacher_int8_kernel: {label}: two calls bit for bit: {same}", flush=True)
            if not same:
                fail(f"two calls of the int8 field-eval kernel differ at {label}")
        want = nerf_forward_int8_ref(packed, x, dirs, T_L, T_LV, act_scales=act, cm=cm)
        torch.cuda.synchronize()
        if cm:
            got, want = got.permute(1, 2, 0), want.permute(1, 2, 0)
        if got.shape != pts.shape[:2] + (4,) or not torch.isfinite(got).all():
            fail("int8 field-eval kernel output has the wrong shape or is not finite")
        e = _int8_field_errors(got, want)
        del got, want
        torch.cuda.empty_cache()
        print(f"teacher_int8_kernel: nerf_forward_int8 W{T_WIDTH} D{T_DEPTH} {label}"
              f"{' (cm)' if cm else ''}: sigma {e['sigma']:.3g}, rgb {e['rgb']:.3g} of max "
              f"|plain| (tol {INT8_TEACHER_TOL:g}); max abs {e['abs']:.3g}; share of points "
              f"beyond {TEACHER_TOL:g} {e['share']:.2e}", flush=True)
        worst = {k: max(worst[k], v) for k, v in e.items()}
    # the noise of summation order alone: the plain version on the host CPU
    # against on the card, with the same scales
    pts, dirs = _frame_points(sm, o, d, vd, 64, 64)
    act = calibrate_nerf_int8(packed32, pts.reshape(-1, 3)[:1024], T_L)
    cpu = {k: v.cpu() if torch.is_tensor(v) else v for k, v in packed.items()}
    want = nerf_forward_int8_ref(packed, pts, dirs, T_L, T_LV, act_scales=act)
    want_cpu = nerf_forward_int8_ref(cpu, pts.cpu(), dirs.cpu(), T_L, T_LV, act_scales=act.cpu())
    got = nerf_forward_int8(packed, pts, dirs, T_L, T_LV, act_scales=act)
    noise, k_e = _int8_field_errors(want.cpu(), want_cpu), _int8_field_errors(got, want)
    print(f"teacher_int8_kernel: summation-order noise, plain version on the CPU vs on the "
          f"card, 64 x 64: sigma {noise['sigma']:.3g}, rgb {noise['rgb']:.3g} (abs "
          f"{noise['abs']:.3g}, share beyond {TEACHER_TOL:g} {noise['share']:.2e}); kernel vs "
          f"plain on the same points: sigma {k_e['sigma']:.3g}, rgb {k_e['rgb']:.3g}",
          flush=True)
    if not max(worst["sigma"], worst["rgb"]) <= INT8_TEACHER_TOL:
        fail(f"int8 field-eval kernel differs from its plain version by {worst}")
    from efficient_nerf_tpu_torch.ops import _build

    lib = ctypes.CDLL(str(_build.library_path("nerf_int8")))
    lib.nerf_int8_smem_bytes.restype = ctypes.c_longlong
    print_tile("teacher_int8_kernel", "nerf_int8", "nerf_int8_kernel",
               [(f"S={S}", lib.nerf_int8_smem_bytes(64, T_WIDTH, T_DEPTH, S),
                 lib.nerf_int8_ring_stages(64, T_WIDTH, T_DEPTH, S))
                for S in (T_SAMPLES, T_SAMPLES + T_IMPORTANCE)])
    sm.int8_teacher = {"packed": packed, "packed32": packed32, "err": worst["abs"]}


def phase_teacher_int8(sm: Smoke) -> None:
    import dataclasses

    import numpy as np

    from efficient_nerf_tpu_torch.data import StreamingPseudoGenerator
    from efficient_nerf_tpu_torch.ops.nerf_forward import nerf_forward_fused
    from efficient_nerf_tpu_torch.ops.nerf_int8 import (
        calibrate_nerf_int8, nerf_forward_int8, nerf_forward_int8_ref, nerf_int8_ops)
    from efficient_nerf_tpu_torch.ops.sample_pdf import sample_pdf_det_fused
    from efficient_nerf_tpu_torch.ops.trig import fast_sincos_cuda
    from efficient_nerf_tpu_torch.render import render_image

    torch, model = sm.torch, sm.teacher
    cfg8 = dataclasses.replace(teacher_config(), teacher_quant="int8")
    cfg = cfg8.eval_mode()
    c2ws = [np.asarray(p[:3, :4]) for p in sm.poses]
    chunks = -(-FRAME_H * FRAME_W // T_CHUNK)
    counters = (nerf_forward_int8, nerf_forward_fused, sample_pdf_det_fused)

    def counts():
        return tuple(f.launches for f in counters)

    def reset():
        for f in counters + (fast_sincos_cuda,):
            f.launches = 0

    render_image(model, None, FRAME_H, FRAME_W, T_FOCAL, c2ws[0], cfg)   # warm-up
    torch.cuda.synchronize()
    reset()
    # as a user calls it: numpy poses, the default device (CUDA)
    frames = [render_image(model, None, FRAME_H, FRAME_W, T_FOCAL, c2w, cfg) for c2w in c2ws]
    torch.cuda.synchronize()
    launches = counts()
    print(f"teacher_int8: 3 frames of {FRAME_H}x{FRAME_W} with teacher_quant='int8' "
          f"({chunks} chunks each): nerf_forward_int8 launches {launches[0]}, "
          f"nerf_forward_fused {launches[1]}, sample_pdf_det_fused {launches[2]}", flush=True)
    if launches != (2 * chunks * 3, 0, chunks * 3):
        fail(f"expected 2 int8 field-eval, no bf16 field-eval and 1 sampler launch a "
             f"chunk, counted {launches} over 3 frames")
    for f in frames:
        if f.rgb.shape != (FRAME_H, FRAME_W, 3) or not torch.isfinite(f.rgb).all() \
                or f.rgb.min() < 0 or f.rgb.max() > 1 + 1e-6 \
                or not torch.isfinite(f.depth).all() or not torch.isfinite(f.acc).all():
            fail("int8 teacher frame has the wrong shape, values that are not finite "
                 "or rgb outside [0, 1]")
    # the plain versions in the same chunks, so that each call calibrates on
    # the same points
    plain = _render_plain(sm, model, c2ws[0], cfg, chunk=T_CHUNK)
    torch.cuda.synchronize()
    share = _frame_diff(sm, "teacher_int8: frame 0 against the same frame through the "
                        "plain versions", frames[0], plain)
    del plain
    if share > FRAME_SHARE:
        fail(f"int8 teacher frame differs from the plain versions' frame in a share "
             f"{share:.2e} of its rays")
    # quality: the int8 frame against the bf16 frame of the teacher phase
    bf = sm.teacher_frame0
    n_rays = FRAME_H * FRAME_W
    flip = ((frames[0].acc0 - bf.acc0).abs() > 0.5) | ((frames[0].acc - bf.acc).abs() > 0.5)
    flip = flip.reshape(n_rays)
    d2 = ((frames[0].rgb - bf.rgb) ** 2).reshape(n_rays, 3)
    psnr = -10.0 * math.log10(max(d2.mean().item(), 1e-30))
    psnr_kept = -10.0 * math.log10(max(d2[~flip].mean().item(), 1e-30))
    flips = flip.float().mean().item()
    coarse_flips = ((frames[0].acc0 - bf.acc0).abs() > 0.5).float().mean().item()
    print(f"teacher_int8: int8 frame 0 against the bf16 frame 0: rgb max "
          f"{(frames[0].rgb - bf.rgb).abs().max().item():.3g}, PSNR {psnr:.2f} dB; rays whose "
          f"coarse or fine acc moves by more than 0.5: share {flips:.2e} (coarse alone "
          f"{coarse_flips:.2e}; at most {INT8_FLIP_SHARE:g}); PSNR over the other rays "
          f"{psnr_kept:.2f} dB (at least {INT8_PSNR_MIN:g})", flush=True)
    if not (flips <= INT8_FLIP_SHARE and psnr_kept >= INT8_PSNR_MIN):
        fail(f"the int8 teacher frame lies {psnr_kept:.2f} dB from the bf16 frame over the "
             f"rays that keep their acc, and {flips:.2e} of the rays flip")
    del frames

    # pseudo-data from the int8 teacher: 3 frames through the one-frame pipeline
    gen = StreamingPseudoGenerator(
        model, None, cfg8, FRAME_H, FRAME_W, T_FOCAL, batch_rays=4096,
        buffer_rays=1_000_000, warmup_frames=1, frames_per_batch=1.0,
        rng=np.random.default_rng(sm.seed))
    next(gen)
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    for _ in range(3):
        o, d, t = next(gen)
    torch.cuda.synchronize()
    pseudo_ms = (time.perf_counter() - t0) * 1e3 / 3
    p_launches = counts()
    del gen
    print(f"teacher_int8: StreamingPseudoGenerator with teacher_quant='int8' {pseudo_ms:.3f} "
          f"ms/frame over 3 frames; launches (int8, bf16 field eval, sampler) {p_launches}",
          flush=True)
    if p_launches != (2 * chunks * 3, 0, chunks * 3) or t.shape != (4096, 3) \
            or not np.isfinite(t).all():
        fail(f"int8 pseudo frames launched {p_launches} or gave a malformed batch")

    # ---- times: the frame, and the kernel at the main path's chunk
    frame_ms = cuda_ms(torch, lambda: render_image(
        model, None, FRAME_H, FRAME_W, T_FOCAL, c2ws[1], cfg), 3, warmup=1)
    packed, packed32 = sm.int8_teacher["packed"], sm.int8_teacher["packed32"]
    c, n = sm.chunk, T_CHUNK
    times, ops, nbytes = {}, {}, {}
    w_bytes = sum(packed[k].numel() * packed[k].element_size() for k in (
        "pts0_w", "pts0_b", "body_qw", "skip_x_w", "feat_qw", "views_h_w", "views_d_w",
        "views_b", "rgb_w", "alpha_w", "out_b", "body_sw", "feat_sw", "body_b_f32",
        "feat_b_f32"))
    lib_err = 0.0
    for k in ("coarse", "fine"):
        pts, vd = c[k], c["vd"]
        act = calibrate_nerf_int8(packed32, pts.reshape(-1, 3)[:1024], T_L)
        lib_err = max(lib_err, (int8_teacher_library_forward(torch, packed, pts, vd, act)
                                - nerf_forward_int8_ref(packed, pts, vd, T_L, T_LV,
                                                        act_scales=act)).abs().max().item())
        torch.cuda.empty_cache()
        times[k] = {
            "ms": cuda_ms(torch, lambda: nerf_forward_int8(packed, pts, vd, T_L, T_LV,
                                                           act_scales=act), 5),
            "plain_ms": cuda_ms(torch, lambda: nerf_forward_int8_ref(
                packed, pts, vd, T_L, T_LV, act_scales=act), 1, warmup=1),
            "library_ms": cuda_ms(torch, lambda: int8_teacher_library_forward(
                torch, packed, pts, vd, act), 3, warmup=1)}
        torch.cuda.empty_cache()
        ops[k] = nerf_int8_ops(packed, n * pts.shape[1], n)
        nbytes[k] = n * pts.shape[1] * (12 + 16) + n * 12 + w_bytes
        b = bound(ops[k][1], nbytes[k], int8_ops=ops[k][0])
        t = times[k]
        print(f"teacher_int8: nerf_forward_int8 {k} chunk {n} x {pts.shape[1]}: kernel "
              f"{t['ms']:.3f} ms, bound {b[0]:.3f} ms ({ops[k][0] / 1e12:.3f} T int8 operations "
              f"at 1979 TOPS + {ops[k][1] / 1e12:.3f} TFLOP at 989 TFLOP/s, {b[1]}) -> "
              f"{b[0] / t['ms'] * 100:.1f}% of the bound; plain version {t['plain_ms']:.3f} ms "
              f"(not a yardstick); unfused torch._int_mm path (library_ms) "
              f"{t['library_ms']:.3f} ms", flush=True)
    chunk_bound = bound(ops["coarse"][1] + ops["fine"][1], nbytes["coarse"] + nbytes["fine"],
                        int8_ops=ops["coarse"][0] + ops["fine"][0])
    n_rays = FRAME_H * FRAME_W
    f8, f16 = nerf_int8_ops(packed, n_rays * (2 * T_SAMPLES + T_IMPORTANCE), 2 * n_rays)
    frame_bound = bound(f16, n_rays * (2 * T_SAMPLES + T_IMPORTANCE) * 28, int8_ops=f8)
    print(f"teacher_int8: render_image(teacher_quant='int8') {frame_ms:.3f} ms/frame "
          f"({n_rays / frame_ms * 1e3 / 1e6:.3f} M rays/s) against the bf16 frame's "
          f"{sm.teacher_frame_ms:.3f}; the frame's int8 field evals bound {frame_bound[0]:.3f} "
          f"ms; the library path is {lib_err:.3g} from the plain version", flush=True)
    sm.entries["nerf_forward_int8"] = {
        "name": "nerf_forward_int8", "route": "cuda",
        "source": "efficient_nerf_tpu_torch/csrc/nerf_int8.cu",
        "replaces": "efficient_nerf_tpu/ops/pallas/nerf_int8.py:306",
        "launches": launches[0], "max_abs_err": sm.int8_teacher["err"],
        # one coarse and one fine launch of a 32,768-ray chunk
        "ms": times["coarse"]["ms"] + times["fine"]["ms"],
        "plain_ms": times["coarse"]["plain_ms"] + times["fine"]["plain_ms"],
        "bound_ms": chunk_bound[0], "bound_by": chunk_bound[1],
        "library_ms": times["coarse"]["library_ms"] + times["fine"]["library_ms"]}


FRAME_FIELDS = ("rgb", "disp", "acc", "depth", "rgb0", "disp0", "acc0", "z_std")


def phase_frame_kernel(sm: Smoke) -> None:
    from efficient_nerf_tpu_torch.ops import _build
    from efficient_nerf_tpu_torch.ops import nerf_frame as fr
    from efficient_nerf_tpu_torch.ops.nerf_forward import nerf_forward_flops
    from efficient_nerf_tpu_torch.ops.sample_pdf import sample_pdf_det_fused

    torch, dev, packed = sm.torch, sm.dev, sm.teacher_packed
    o, d, vd = _teacher_rays(sm, sm.poses[0])
    _, bins, u = fr._consts(NEAR, FAR, T_SAMPLES, T_IMPORTANCE, False, dev)
    tol = dict(FRAME_TOL, rgb0=FRAME_TOL["rgb"], acc0=FRAME_TOL["acc"])
    pick = torch.randint(0, o.shape[0], (37,), generator=sm.gen, device=dev)
    worst = 0.0
    for label, idx in (("a ragged 37 rays", pick), (f"a {T_CHUNK}-ray chunk", slice(0, T_CHUNK))):
        ro, rd, rv = o[idx].contiguous(), d[idx].contiguous(), vd[idx].contiguous()
        n = ro.shape[0]
        args = (packed, None, ro, rd, rv, NEAR, FAR, T_SAMPLES, T_IMPORTANCE, T_L, T_LV)
        got = dict(zip(FRAME_FIELDS + ("w", "zf"),
                       fr.nerf_render_rays_fused(*args, white_bkgd=True, taps=True)))
        want = dict(zip(FRAME_FIELDS + ("w", "zf"),
                        fr.nerf_render_rays_fused_ref(*args, white_bkgd=True, taps=True)))
        # the fine depths: kernel 6's walk on the kernel's own coarse weights
        zf6 = sample_pdf_det_fused(bins.expand(n, -1).contiguous(),
                                   got["w"][:, 1:-1].contiguous(), T_IMPORTANCE, levels=u)
        torch.cuda.synchronize()
        n_zdiff = int((zf6 != got["zf"]).sum().item())
        if not all(torch.isfinite(got[k]).all() for k in ("rgb", "acc", "depth", "rgb0",
                                                          "acc0", "z_std")):
            fail("whole-ray kernel output is not finite")
        beyond = torch.zeros(n, dtype=torch.bool, device=dev)
        errs = {}
        for k in FRAME_FIELDS:
            g, w = got[k].reshape(n, -1), want[k].reshape(n, -1)
            nan = torch.isnan(g) | torch.isnan(w)
            e = torch.where(nan, torch.zeros_like(g), (g - w).abs()).amax(-1)
            errs[k] = e.max().item()
            beyond |= (torch.isnan(g) != torch.isnan(w)).any(-1)
            if k in tol:
                beyond |= e > tol[k]
        share = beyond.float().mean().item()
        del got, want, zf6
        torch.cuda.empty_cache()
        print(f"frame_kernel: nerf_render_rays_fused W{T_WIDTH} D{T_DEPTH} {T_SAMPLES} + "
              f"{T_IMPORTANCE} samples, {label}: max |kernel - plain| "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f"; {int(beyond.sum().item())} rays beyond {json.dumps(tol)} or with another "
              f"NaN mask (share {share:.2e}, at most {FRAME_SHARE:g}); fine depths against "
              f"sample_pdf_det_fused on the kernel's own weights: {n_zdiff} of "
              f"{n * T_IMPORTANCE} differ (bit for bit)", flush=True)
        if n_zdiff or share > FRAME_SHARE:
            fail(f"whole-ray kernel differs from its plain version ({share:.2e} of the rays) "
                 f"or its fine depths from the sampler's ({n_zdiff})")
        worst = max(worst, errs["rgb"], errs["acc"], errs["rgb0"], errs["acc0"])

    # ---- time at the main path's chunk beside the bound and the plain version
    ro, rd, rv = (x[:T_CHUNK].contiguous() for x in (o, d, vd))
    args = (packed, None, ro, rd, rv, NEAR, FAR, T_SAMPLES, T_IMPORTANCE, T_L, T_LV)
    ms = cuda_ms(torch, lambda: fr.nerf_render_rays_fused(*args, white_bkgd=True), 5)
    plain_ms = cuda_ms(torch, lambda: fr.nerf_render_rays_fused_ref(*args, white_bkgd=True),
                       1, warmup=1)
    torch.cuda.empty_cache()
    n, S_f = T_CHUNK, T_SAMPLES + T_IMPORTANCE
    flops = nerf_forward_flops(packed, n * T_SAMPLES, n) + nerf_forward_flops(packed, n * S_f, n)
    w_bytes = sum(packed[k].numel() * packed[k].element_size() for k in packed
                  if torch.is_tensor(packed[k]))
    # o, d and the embedded directions in; the 12 floats of the fields out
    b = bound(flops, n * (6 + 3 * (2 * T_LV + 1)) * 4 + n * 12 * 4 + w_bytes)
    composed = [sm.entries[k]["ms"] for k in ("nerf_forward_fused", "sample_pdf_det_fused")
                if k in sm.entries]
    print(f"frame_kernel: nerf_render_rays_fused at a {n}-ray chunk: {ms:.3f} ms, bound "
          f"{b[0]:.3f} ms ({flops / 1e12:.3f} TFLOP, {b[1]}) -> {b[0] / ms * 100:.1f}% of the "
          f"bound; plain version {plain_ms:.3f} ms (not a yardstick); no single torch call "
          f"computes it; the composed path's kernels (field eval coarse + fine, sampler; "
          f"teacher phase) "
          + (f"{sum(composed):.3f} ms" if len(composed) == 2 else "not measured in this run"),
          flush=True)
    lib = ctypes.CDLL(str(_build.library_path("nerf_frame")))
    lib.nerf_frame_smem_bytes.restype = ctypes.c_longlong
    R = fr._rays_per_block(T_SAMPLES)
    print_tile("frame_kernel", "nerf_frame", "nerf_frame_kernel", [
        (f"R={R}, {T_SAMPLES} + {T_IMPORTANCE} samples",
         lib.nerf_frame_smem_bytes(64, T_WIDTH, T_DEPTH, R, T_SAMPLES, T_IMPORTANCE),
         lib.nerf_frame_ring_stages(64, T_WIDTH, T_DEPTH, R, T_SAMPLES, T_IMPORTANCE))])
    sm.entries["nerf_render_rays_fused"] = {
        "name": "nerf_render_rays_fused", "route": "cuda",
        "source": "efficient_nerf_tpu_torch/csrc/nerf_frame.cu",
        "replaces": "efficient_nerf_tpu/ops/pallas/nerf_frame.py:479",
        "launches": 0, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b[0], "bound_by": b[1], "library_ms": None}


def phase_teacher_frame(sm: Smoke) -> None:
    import dataclasses

    import numpy as np

    from efficient_nerf_tpu_torch.ops.nerf_forward import nerf_forward_fused
    from efficient_nerf_tpu_torch.ops.nerf_frame import nerf_render_rays_fused
    from efficient_nerf_tpu_torch.ops.sample_pdf import sample_pdf_det_fused
    from efficient_nerf_tpu_torch.ops.trig import fast_sincos_cuda
    from efficient_nerf_tpu_torch.render import render_image

    torch, model = sm.torch, sm.teacher
    cfg = dataclasses.replace(teacher_config(), frame_fused=True).eval_mode()
    c2ws = [np.asarray(p[:3, :4]) for p in sm.poses]
    chunks = -(-FRAME_H * FRAME_W // T_CHUNK)
    counters = (nerf_render_rays_fused, nerf_forward_fused, sample_pdf_det_fused)
    render_image(model, None, FRAME_H, FRAME_W, T_FOCAL, c2ws[0], cfg)   # warm-up
    torch.cuda.synchronize()
    for f in counters + (fast_sincos_cuda,):
        f.launches = 0
    # as a user calls it: numpy poses, the default device (CUDA)
    frames = [render_image(model, None, FRAME_H, FRAME_W, T_FOCAL, c2w, cfg) for c2w in c2ws]
    torch.cuda.synchronize()
    launches = tuple(f.launches for f in counters)
    print(f"teacher_frame: 3 frames of {FRAME_H}x{FRAME_W} with frame_fused ({chunks} chunks "
          f"each): nerf_render_rays_fused launches {launches[0]}, nerf_forward_fused "
          f"{launches[1]}, sample_pdf_det_fused {launches[2]}", flush=True)
    if launches != (chunks * 3, 0, 0):
        fail(f"expected one whole-ray launch a chunk and no other teacher kernel, counted "
             f"{launches} over 3 frames")
    for f in frames:
        if f.rgb.shape != (FRAME_H, FRAME_W, 3) or not torch.isfinite(f.rgb).all() \
                or f.rgb.min() < 0 or f.rgb.max() > 1 + 1e-6 \
                or not torch.isfinite(f.depth).all() or not torch.isfinite(f.acc).all():
            fail("whole-ray frame has the wrong shape, values that are not finite or rgb "
                 "outside [0, 1]")
    share = _frame_diff(sm, "teacher_frame: frame 0 against the composed kernel path's "
                        "frame 0 (teacher phase)", frames[0], sm.teacher_frame0)
    if share > FRAME_SHARE:
        fail(f"the whole-ray frame differs from the composed path's in a share {share:.2e} "
             f"of its rays")
    del frames
    frame_ms = cuda_ms(torch, lambda: render_image(
        model, None, FRAME_H, FRAME_W, T_FOCAL, c2ws[1], cfg), 3, warmup=1)
    print(f"teacher_frame: render_image(frame_fused=True) {frame_ms:.3f} ms/frame "
          f"({FRAME_H * FRAME_W / frame_ms * 1e3 / 1e6:.3f} M rays/s) against the composed "
          f"kernel path's {sm.teacher_frame_ms:.3f} ms; the frame's field evals bound "
          f"{sm.teacher_frame_bound:.3f} ms", flush=True)
    sm.entries["nerf_render_rays_fused"]["launches"] = launches[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args()
    phases = (phase_build, phase_trig, phase_kernel, phase_main,
              phase_kernel_int8, phase_main_int8, phase_train_kernel, phase_train,
              phase_teacher_kernel, phase_teacher, phase_pseudo,
              phase_teacher_int8_kernel, phase_teacher_int8, phase_frame_kernel,
              phase_teacher_frame)
    chosen = [p for p in args.phases.split(",") if p]
    unknown = set(chosen) - {p.__name__[len("phase_"):] for p in phases}
    if unknown:
        fail(f"unknown phases {sorted(unknown)}")

    sm = Smoke(args)
    for phase in phases:
        if chosen and phase.__name__[len("phase_"):] not in chosen:
            continue
        t0 = time.perf_counter()
        phase(sm)
        print(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    if chosen:
        print(json.dumps({"kernels": list(sm.entries.values())}))
        print(sm.gpu)
        print(f"chip_smoke: partial run of {','.join(chosen)}: no result line")
        return
    # the helper runs inside every launch of the kernels that embed
    sm.entries["fast_sincos"]["launches"] = sum(
        sm.entries[k]["launches"] for k in ("r2l_forward_fused", "r2l_forward_int8",
                                            "r2l_train_fwd", "r2l_train_bwd",
                                            "nerf_forward_fused", "nerf_forward_int8",
                                            "nerf_render_rays_fused"))
    print(json.dumps({"kernels": [sm.entries[k] for k in (
        "r2l_forward_fused", "fast_sincos", "r2l_forward_int8", "r2l_train_fwd",
        "r2l_train_bwd", "r2l_train_wgrad", "nerf_forward_fused", "sample_pdf_det_fused",
        "nerf_forward_int8",
        "nerf_render_rays_fused")]}))
    print(sm.gpu)  # the card, as nvidia-smi names it and its power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": sm.torch.cuda.get_device_name(0),
        "count": sm.torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
