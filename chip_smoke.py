#!/usr/bin/env python3
"""Drives the PyTorch port's R2L serving path on one CUDA card and holds its
kernels against their plain versions.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (non-zero exit, no result line):
  build   nvcc builds every csrc/*.cu into build/kernels/ (one nvcc per
          source, all started together); prints the time and ptxas's report.
  trig    the fast_sincos device helper (csrc/trig.cuh) against its plain
          torch version over |y| <= 4e3.
  kernel  the fused R2L kernel at W256 D88, n_sample 16, L 10, B 8192, both
          use_residual settings, against r2l_forward_fused_ref on the card.
  main    r2l_render_image for 3 pose_spherical poses at 400x400 through the
          public entry points, with the kernels' launch counters set to 0
          just before and read just after; then the frame time, the kernel
          time beside its bound, the plain version and the unfused cuBLAS
          path (the library yardstick).
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
import sys

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak, H100 SXM data sheet
H100_HBM_BYTES = 3.35e12   # HBM3 bandwidth, H100 SXM data sheet

# Flagship student: W256 D88, 16 samples, L 10 -> input 1008.
WIDTH, DEPTH, N_SAMPLE, L_FREQ = 256, 88, 16, 10
NEAR, FAR = 2.0, 6.0
FRAME_H = FRAME_W = 400
FOCAL = 0.5 * FRAME_W / 0.4142135623730951   # 45-degree field of view
KERNEL_B = 8192
NOISE_B = 2048
TRIG_N = 1 << 22

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
    in_dim = 3 * N_SAMPLE * (2 * L_FREQ + 1)

    def lin(fan_in, fan_out, scale=1.0):
        w = rng.normal(size=(fan_out, fan_in)) / np.sqrt(fan_in) * scale
        b = rng.normal(size=(fan_out,)) * 0.01
        return (torch.tensor(w.astype(np.float32)),
                torch.tensor(b.astype(np.float32)))

    sd = {}
    sd["head.0.weight"], sd["head.0.bias"] = lin(in_dim, WIDTH)
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a card")

    from efficient_nerf_tpu_torch.core.poses import pose_spherical
    from efficient_nerf_tpu_torch.core.rays import get_rays
    from efficient_nerf_tpu_torch.models import R2LNet
    from efficient_nerf_tpu_torch.ops import _build
    from efficient_nerf_tpu_torch.ops.r2l_forward import (
        pack_r2l_weights, r2l_forward_flops, r2l_forward_fused,
        r2l_forward_fused_ref)
    from efficient_nerf_tpu_torch.ops.trig import fast_sincos, fast_sincos_cuda
    from efficient_nerf_tpu_torch.render import r2l_forward_rays, r2l_render_image

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    print(f"gpu: {gpu}  ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)

    # ---- build
    build_s = _build.build_all()
    print(f"build: {build_s:.1f} s for {', '.join(_build.SOURCES)}", flush=True)
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ---- trig: the device helper against its plain version
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    y = (torch.rand(TRIG_N, generator=gen, device=dev) * 2 - 1) * 4e3
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
    trig_bound_ms = TRIG_N * 12 / H100_HBM_BYTES * 1e3
    print(f"trig: fast_sincos(degree=9) over |y|<=4e3, n={TRIG_N}: max |kernel - "
          f"plain| {trig_err:.3g} (tol {TRIG_TOL:g}), {n_diff} values differ; "
          f"max |kernel - float64 sin/cos| {acc_err:.3g}", flush=True)
    print("trig_helper " + json.dumps({
        "name": "fast_sincos", "route": "cuda",
        "source": "efficient_nerf_tpu_torch/csrc/trig.cuh",
        "replaces": "efficient_nerf_tpu/ops/pallas/trig.py:53",
        "max_abs_err": trig_err, "ms": trig_ms, "plain_ms": trig_plain_ms,
        "bound_ms": trig_bound_ms, "bound_by": "bytes", "library_ms": None}))
    if not trig_err <= TRIG_TOL:
        fail(f"trig helper differs from its plain version by {trig_err}")

    # ---- kernel: fused forward vs plain version at the flagship width
    sd = random_state_dict(args.seed, torch)
    poses = [pose_spherical(t, -30.0, 4.0) for t in (-150.0, -30.0, 90.0)]
    rays = [get_rays(FRAME_H, FRAME_W, FOCAL, p[:3, :4], device=dev) for p in poses]
    all_o = torch.cat([o.reshape(-1, 3) for o, _ in rays])
    all_d = torch.cat([d.reshape(-1, 3) for _, d in rays])
    pick = torch.randint(0, all_o.shape[0], (KERNEL_B,), generator=gen, device=dev)
    ko, kd = all_o[pick].contiguous(), all_d[pick].contiguous()
    packed = pack_r2l_weights({k: v.to(dev) for k, v in sd.items()}, N_SAMPLE, L_FREQ)
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

    # ---- main path: r2l_render_image at 400x400 through the public API
    model = R2LNet(3 * N_SAMPLE * (2 * L_FREQ + 1), DEPTH, WIDTH)
    model.load_state_dict(sd)
    model = model.to(dev).eval()
    c2ws = [p[:3, :4] for p in poses]
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
    max_err = max(max_err, frame_err)
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
    nbytes = n_rays * (3 * 4 * 2 + 3 * 4) + weight_bytes
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_HBM_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    print(f"main: r2l_render_image {frame_ms:.3f} ms/frame "
          f"({n_rays / frame_ms * 1e3 / 1e6:.2f} M rays/s); kernel "
          f"{kern_ms:.3f} ms at B={n_rays}, bound {bound_ms:.3f} ms "
          f"({flops / 1e12:.3f} TFLOP at 989 TFLOP/s) -> "
          f"{bound_ms / kern_ms * 100:.1f}% of the bound; plain version "
          f"{plain_ms:.3f} ms (not a yardstick); unfused cuBLAS bf16 path "
          f"(library_ms) {library_ms:.3f} ms", flush=True)

    print(json.dumps({"kernels": [{
        "name": "r2l_forward_fused", "route": "cuda",
        "source": "efficient_nerf_tpu_torch/csrc/r2l_forward.cu",
        "replaces": "efficient_nerf_tpu/ops/pallas/r2l_forward.py:505",
        "launches": launches, "max_abs_err": max_err, "ms": kern_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms}]}))
    print(gpu)  # the card, as nvidia-smi names it and its power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
