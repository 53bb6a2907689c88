#!/usr/bin/env python3
"""Drives the PyTorch port's R2L serving and training paths on one CUDA card
and holds their kernels against their plain versions.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (non-zero exit, no result line):
  build         nvcc builds every csrc/*.cu into build/kernels/ (one nvcc per
                source, all started together); prints the time and ptxas's
                report.
  trig          the fast_sincos device helper (csrc/trig.cuh) against its
                plain torch version over |y| <= 4e3.
  kernel        the fused R2L kernel at W256 D88, n_sample 16, L 10, B 8192,
                both use_residual settings, against r2l_forward_fused_ref.
  main          r2l_render_image for 3 pose_spherical poses at 400x400
                through the public entry points, with the kernels' launch
                counters set to 0 just before and read just after; then the
                frame time, the kernel time beside its bound, the plain
                version and the unfused cuBLAS path (the library yardstick).
  kernel_int8   the W8A8 kernel at W256 D88, B 8192, static scales (from
                calibrate_r2l_int8 on 1024 of those rays) and dynamic ones,
                use_residual off and on, and a ragged B 37, against
                r2l_forward_int8_ref; max and mean error, the share of rays
                beyond 4e-3, and the noise of the plain version on the CPU
                against on the card (B 2048).
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
                backward, against their plain versions.
  train         make_r2l_train_step at the slice's configuration (98,304
                rays a step: 81,920 batch rays + 16,384 hard rays from an
                81,920-row pool, perturbed, Adam with the warmup schedule):
                10 steps on rays of pose_spherical frames with targets from
                a second R2L of another seed, the launch counters set to 0
                just before and read just after; then both training kernels
                against their plain versions at the step's 98,304 rays; the
                step time split into its parts, and each training kernel's
                time beside its bound, its plain version and the unfused
                cuBLAS autograd path.
Before the last line it prints the card's name and power limit (nvidia-smi)
and one JSON line {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Weights are random, made from --seed, with
each block's second linear scaled by 0.1 so that the 88-layer output is not
saturated by the sigmoid. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import time

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
# summation order and carry through 43 blocks, and the atomics' run-to-run
# order of the weight-gradient sums (f32, ~1e-7 relative: negligible). The
# first card run measured at most 6.5e-3 (hs), 2.3e-3 (gradients) and
# 1.1e-2 (dx, whose embed chain multiplies by up to 2^9) over these shapes,
# and the plain version on the CPU against on the card differs by the
# amounts the noise line prints. The limits are 3-4x those; a wrong index or
# orientation gives errors of order 1.
TRAIN_TOL = {"hs": 2e-2, "grad": 1e-2, "dx": 4e-2}
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
    rt.r2l_train_bwd.launches = 0
    losses, counts = [], []
    for o, d, t in batches:
        state, pool, metrics = step(state, pool, gen, o, d, t)
        losses.append(metrics["loss_rgb"])
        counts.append(pool.count)
    torch.cuda.synchronize()
    launches = (rt.r2l_train_fwd.launches, rt.r2l_train_bwd.launches)
    losses = [v.item() for v in losses]
    mse1 = eval_mse()
    print(f"train: {TRAIN_STEPS} steps of {n_rays} rays ({TRAIN_BATCH} + "
          f"{TRAIN_HARD[1]} hard, pool {TRAIN_POOL}): r2l_train_fwd launches "
          f"{launches[0]}, r2l_train_bwd launches {launches[1]}; loss_rgb "
          + " ".join(f"{v:.5f}" for v in losses)
          + f"; pool count {counts}; held-out MSE of the served student on "
          f"{EVAL_B} rays {mse0:.6f} -> {mse1:.6f}", flush=True)
    if launches != (TRAIN_STEPS, TRAIN_STEPS):
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

    # ---- both kernels against their plain versions at the step's shape,
    # where the backward sums the weight gradients of every ray tile
    out_p, hs_p = rt.r2l_train_fwd_ref(packed, x, **kw)
    g = rt.r2l_train_bwd(packed, x, hs_p, dout, need_dx=False, **kw)
    g_p = rt.r2l_train_bwd_ref(packed, x, hs_p, dout, need_dx=False, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all() or not torch.isfinite(hs.float()).all():
        fail("training forward output is not finite at the step's shape")
    full = {"out": (out - out_p).abs().max().item(), "hs": rel_err(hs, hs_p),
            "grad": max(rel_err(g[k], g_p[k]) for k in rt._OPERANDS),
            "grad_abs": max((g[k] - g_p[k]).abs().max().item() for k in rt._OPERANDS)}
    del out_p, hs_p, g, g_p
    print(f"train: kernels vs plain versions at B={n_rays} ({-(-n_rays // 64)} "
          f"ray tiles): forward out {full['out']:.3g} (tol {KERNEL_TOL:g}), hs "
          f"{full['hs']:.3g}, gradients {full['grad']:.3g} of their largest "
          f"magnitude (tol {json.dumps(TRAIN_TOL)})", flush=True)
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
        "backward kernel": cuda_ms(torch, lambda: rt.r2l_train_bwd(
            packed, x, hs, dout, need_dx=False, **kw), 5),
    }
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
    w_bytes = sum(packed[k].numel() * packed[k].element_size()
                  for k in rt._OPERANDS)
    g_bytes = sum(packed[k].numel() * 4 for k in rt._OPERANDS)
    x_bytes, hs_bytes = x.numel() * 4, hs.numel() * 2
    fwd_bound = bound(fwd_flops, x_bytes + w_bytes + out.numel() * 4 + hs_bytes)
    bwd_bound = bound(bwd_flops, x_bytes + w_bytes + hs_bytes + dout.numel() * 4
                      + g_bytes)
    n_tiles = -(-n_rays // 64)
    atomic_bytes = n_tiles * g_bytes
    plain_fwd = cuda_ms(torch, lambda: rt.r2l_train_fwd_ref(packed, x, **kw), 2, warmup=1)
    plain_bwd = cuda_ms(torch, lambda: rt.r2l_train_bwd_ref(
        packed, x, hs, dout, need_dx=False, **kw), 2, warmup=1)
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
          f"{lib_fwd:.3f} ms; backward kernel {parts['backward kernel']:.3f} ms, "
          f"bound {bwd_bound[0]:.3f} ms ({bwd_bound[1]}; {bwd_flops / 1e12:.3f} "
          f"TFLOP), plain {plain_bwd:.3f} ms, unfused cuBLAS backward "
          f"{lib_bwd:.3f} ms; the weight gradients' atomics move "
          f"{atomic_bytes / 1e9:.1f} GB into the L2-resident {g_bytes / 1e6:.1f} MB "
          f"buffer ({n_tiles} tiles of 64 rays), {atomic_bytes / H100_HBM_BYTES * 1e3:.3f} "
          f"ms at the HBM rate", flush=True)
    errs = sm.train_err
    common = {"route": "cuda", "source": "efficient_nerf_tpu_torch/csrc/r2l_train.cu"}
    sm.entries["r2l_train_fwd"] = {
        "name": "r2l_train_fwd", **common,
        "replaces": "efficient_nerf_tpu/ops/pallas/r2l_train.py:261",
        "launches": launches[0], "max_abs_err": max(errs["out"], full["out"]),
        "ms": parts["forward kernel"], "plain_ms": plain_fwd,
        "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "library_ms": lib_fwd}
    sm.entries["r2l_train_bwd"] = {
        "name": "r2l_train_bwd", **common,
        "replaces": "efficient_nerf_tpu/ops/pallas/r2l_train.py:323",
        "launches": launches[1],
        "max_abs_err": max(errs["grad_abs"], full["grad_abs"]),
        "ms": parts["backward kernel"], "plain_ms": plain_bwd,
        "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1], "library_ms": lib_bwd}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    sm = Smoke(args)
    for phase in (phase_build, phase_trig, phase_kernel, phase_main,
                  phase_kernel_int8, phase_main_int8, phase_train_kernel, phase_train):
        t0 = time.perf_counter()
        phase(sm)
        print(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    # the helper runs inside every launch of the kernels that embed
    sm.entries["fast_sincos"]["launches"] = sum(
        sm.entries[k]["launches"] for k in ("r2l_forward_fused", "r2l_forward_int8",
                                            "r2l_train_fwd", "r2l_train_bwd"))
    print(json.dumps({"kernels": [sm.entries[k] for k in (
        "r2l_forward_fused", "fast_sincos", "r2l_forward_int8", "r2l_train_fwd",
        "r2l_train_bwd")]}))
    print(sm.gpu)  # the card, as nvidia-smi names it and its power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": sm.torch.cuda.get_device_name(0),
        "count": sm.torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
