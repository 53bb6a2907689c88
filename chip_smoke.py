#!/usr/bin/env python3
"""Drives the PyTorch port's R2L serving and training paths, the NeRF
teacher's rendering, pseudo-data and training paths, the distillation from
the teacher's shards, the CLI driver and parallel/ on one CUDA card, on the
benchmark's workload: the configurations, weights, camera and batch of
perfbench/.

    python3 chip_smoke.py [--seed N] [--phases build,main,...]

The card tests (pytest -m cuda) hold each kernel against its plain version
at its tile's edges; this script holds each one again on the main path, at
the main path's shapes, through the port's public entry points, and prints
one kernels line of what it read. chip_breakdown.py's shipped variants time
each kernel beside its bound, chip_compare.py across two trees, and the
cells of BENCHMARK.json time the student's frame, the distillation step and
the teacher's step; this script times only what none of those measures.

Phases, each of which fails the run (non-zero exit, no result line):
  build         nvcc builds every csrc/*.cu into build/kernels/ (one nvcc per
                source, all started together); prints the time and ptxas's
                report, and for each tile (the student's forward, int8 and
                training tiles, the teacher's field, int8 field and whole-ray
                tiles) each instantiation's registers and spill bytes, and its
                dynamic shared memory and weight-ring stages at the
                configurations' widths; the warpgroup MMAs in the SASS
                (cuobjdump): the two int8 kernels' must hold integer ones
                (IGMMA), each of pass 1's 8 instantiations bf16 ones (HGMMA).
  main          r2l_render_image of the flagship (r2l_w256d88: perfbench's
                weights and build, bf16, the global residual) for 3 orbit
                poses of serve_orbit's camera at 400x400 through the public
                entry points, with the launch counter set to 0 just before
                and read just after (one fused launch a frame); the first
                frame against the plain version on its rays.
  main_int8     calibrate_serving_scales once on the first 1024 rays of frame
                0, then r2l_render_image(quant="int8", act_scales=...) for
                the 3 poses as a user calls it, the launch counters set to 0
                just before and read just after (one int8 launch a frame, no
                bf16 launch); the frame against the plain version; ms a
                frame; the int8 frame against the bf16 kernel's.
  train         make_r2l_train_step at distill_shards' batch (98,304 rays a
                step: 81,920 batch rays + 16,384 hard rays from an
                81,920-row pool, perturbed, Adam with the warmup schedule):
                10 steps on rays of orbit frames with targets from a second
                R2L of another seed, the launch counters set to 0 just before
                and read just after (one launch of the forward and of each
                backward pass a step); the held-out MSE of the served
                student falls; the pool fills at its step. Then, on the last
                batch's sample points (with 16,384 of its rays as the hard
                ones) and the trained weights, r2l_train_fwd against its
                plain version (out to KERNEL_TOL, hs to HS_TOL), pass 1
                through pass 2's plain version (its gradients to GRAD_TOL),
                pass 2 on pass 1's scratch (WGRAD_TOL), and two whole
                backward calls bit for bit.
  train_mlp     the README student command's own network (body_arch "mlp":
                head, 86 plain linears, global residual, sigmoid tail; flax's
                init from --seed), which no kernel covers: one f32 step of
                make_r2l_train_step on the card against the same step on the
                CPU (2,048 rays with injected t_rand and hard-pool draws;
                exact and fast embeds: the loss, every gradient, the weights
                after Adam); fused=True
                raising ValueError; 10 f32 steps at the train phase's batch
                and targets with the held-out MSE after each; ms a step and
                rays/s in f32 and bf16 (fused Adam) beside the step's floor
                (perfbench's yardstick); one bf16 r2l_render_image frame of
                the trained student; no kernel's launch counter may move in
                the phase. Needs train in the same run.
  teacher       render_image(..., cfg.eval_mode()) of nerf_lego (perfbench's
                coarse and fine weights, f32, which the renderer packs in
                bf16 for its kernels; 64 + 128 samples, white background,
                near 2, far 6, chunk 32,768) for the 3 poses at lego's
                camera as a user calls it, the launch counters set to 0 just
                before and read just after (2 field-eval and 1 sampler launch
                per chunk); frame checks, the frame's mean acc and its share
                of rays with acc in (0.01, 0.99); the frame against the same
                frame rendered on the card through the plain versions; ms a
                frame.
  pseudo        StreamingPseudoGenerator over 6 frames through its one-frame
                pipeline (ms a frame beside render_image alone), and
                export_pseudo_shards for 4 poses into a temporary directory:
                156 shards of [4096, 9] whose rows are rows of the 4 frames.
                Needs teacher.
  teacher_int8  render_image with teacher_quant="int8" for the 3 frames, the
                launch counters set to 0 just before and read just after (2
                int8 field-eval, no bf16 field-eval and 1 sampler launch per
                chunk); the frame against the same frame through the plain
                versions; the int8 frame against the bf16 frame (the share of
                rays whose acc flips, and the PSNR over the others);
                StreamingPseudoGenerator with the int8 config over 3 frames;
                ms a frame. Needs teacher.
  teacher_frame render_image with frame_fused=True for the 3 frames (1
                whole-ray launch and no other teacher kernel per chunk); the
                frame against the same frame through the whole-ray kernel's
                plain version, and against the composed kernel path's frame
                of the teacher phase; frame time beside the composed path's.
                Needs teacher.
  teacher_train make_teacher_train_step on the lego config (coarse and fine
                NeRFMLP D8 W256 from torch's seeded init, f32, Adam at 5e-4
                with lrate_decay 500) on 20 sphere frames of 400x400 made in
                memory (data.synthetic.render_sphere_frame): first one step
                on the card against the same step on the CPU (f32 without
                TF32, the same weights and t_rand/u draws: the loss, every
                gradient and the weights after Adam); then 1000 steps of 1024
                pixels of a random frame (the central half for the first
                500), ms a step by CUDA events, the loss and PSNR every 50
                steps (the last 50 below the first 50); the held-out frames'
                PSNR and SSIM (metrics) before and after, f32 unfused (at
                least 3 dB gained) and through the bf16 kernels (the launch
                counters set to 0 just before and read just after: 2 field
                evals and 1 sampler launch a chunk); the trained teacher's
                int8 frame against its bf16 frame (reported, not gated).
  distill       the trained teacher's pseudo shards (export_pseudo_shards, 8
                poses, the bf16 kernels) and its 20 training frames as
                train_ shards (data.convert.rays_to_shards) in a temporary
                directory; the native shard reader built from
                runtime/shard_reader.cpp into build/runtime/, a batch of 20
                shards from it against the numpy path's, bit for bit, its
                time beside the host link's; RayShardDataset and
                ShardLoader(use_native=True) feeding 20 make_r2l_train_step
                steps of the flagship (98,304 rays), the launch
                counters set to 0 just before and read just after (one of
                each training kernel a step), the loss falling, the step's
                waits on the loader, the student's held-out frame against
                the teacher's. Needs teacher_train in the same run.
  driver        the README pipeline through the port's own CLI, in process
                (efficient_nerf_tpu_torch.main.main / create_data.main with
                the README's argv plus iteration limits) on a 400x400 sphere
                scene written by data.synthetic.make_synthetic_scene into a
                temporary directory (--half_res False: no cv2 on the card's
                machine): the untrained teacher's test frames, then the
                teacher (lego.txt) for 1000 steps (its test PSNR at least 3
                dB over the untrained one's); create_data rand (8 poses,
                --test_teacher) and rand with --teacher_quant int8 (2
                poses); the README student command (mlp, f32) and the
                flagship (--trial.ON --trial.body_arch resmlp
                --compute_dtype bf16) for 30 steps each (3a, pass 1 and pass
                2 once a step); from the flagship's checkpoint --render_only
                --render_test, --benchmark (bf16, --inference_quant int8,
                --no_pallas: no kernel launch) and --convert_to_onnx (the
                reloaded torch.export program against eager); the
                flagship's weights re-saved in the reference's .tar layout
                (the whole module pickled under network_fn, its classes in a
                module that exists only while saving): the read time of
                that file beside the plain ckpt.tar's, then --render_only
                --render_test (r2l_forward_fused; PSNR/SSIM equal to the
                plain checkpoint's) and --benchmark --inference_quant int8
                (r2l_forward_int8) from it, and the stub's module absent
                from sys.modules after; create_data
                16x16patches (2 poses) and the conv student (resblock, BN,
                3x3) for 10 steps, then its --render_only --render_test.
                Each command's wall seconds and kernel launches (counters set
                to 0 just before, read just after), the driver's ms a step
                beside the direct phases', the int8 benchmark frame beside
                main_int8's, every test render's PSNR/SSIM.
  parallel      parallel/ over torch.distributed. (a) A one-rank NCCL group
                (make_mesh(n_data=1)): the flagship's sharded step
                (make_sharded_r2l_train_step, the train phase's model, batch
                and pool) against the direct step from the same weights and
                generator seed (loss, gradients, pool rows, bit for bit or
                not); ms a step of each, in turns, and the collectives
                alone (the batch's gather, the gradient bucket's cat and
                all_reduce, per_ray_mse's gather). (b) Two gloo ranks, both
                on cuda:0 (NCCL refuses two ranks on one card), spawned
                processes that return their results through a temporary
                directory, run the four stages of dryrun_multichip: the
                fused flagship step over data x 2 (49,152 rows a rank
                through kernels 3a and 3b), the f32 flagship's
                tensor-parallel step over model x 2 at 4,096 rows, sharded
                serving of a 400x400 frame through kernel 1 and kernel 4
                (int8), and dryrun stage 4's NDC
                teacher step; each against its single-process counterpart
                here (loss 1e-5, gradients in norm, the pool rows and the
                gathered frames equal), each kernel's launches on every
                rank that runs it (counters set to 0 just before each
                stage and read just after); wall times only: gloo stages
                CUDA tensors through the host. The batch
                comes from the phase's own generator, seeded from --seed,
                so its figures repeat whichever phases ran before it.
After the phases it prints one JSON line {"kernels": [...]}: for each
kernel the phases held, its launches on its phase's path, its largest
absolute error against its plain version there and the tolerance it was
held to (the teacher's kernels: the frame's rgb over the rays within
FRAME_TOL, and the share beyond). Then the card's name and power limit
(nvidia-smi); the last line is {"ok": true, "device": {...}}. --phases
runs the named phases only (each with the phases it reads from, as stated
above) and prints no "ok" line. Weights are random, made from --seed: the
flagship's and the teacher's by perfbench/reference's init_params, as the
benchmark's cells make them; the teacher_train phase trains its own teacher.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from perfbench import inputs
from perfbench import yardstick as Y

ROOT = Path(__file__).resolve().parent


def _bench_file(rel: str) -> dict:
    return json.loads((ROOT / "perfbench" / rel).read_text())


# The benchmark's workload: the flagship student and the lego teacher, the
# served frame and the distillation batch
R2L = _bench_file("configs/r2l_w256d88.json")
TEACHER = _bench_file("configs/nerf_lego.json")
SERVE = _bench_file("traffic/serve_orbit.json")
DISTILL = _bench_file("traffic/distill_shards.json")

NEAR, FAR, N_SAMPLE, L_FREQ = R2L["near"], R2L["far"], R2L["n_sample"], R2L["multires"]
FRAME_H, FRAME_W = SERVE["H"], SERVE["W"]
FOCAL = inputs.focal_of(SERVE)
INT8_CAL = SERVE["calibrate_n"]   # calibration rays, as the serving cell calibrates


def orbit(theta: float):
    """The served orbit's camera-to-world at azimuth theta (degrees)."""
    return inputs.pose_spherical(theta, SERVE["phi"], SERVE["radius"])


# The README student batch (--N_rand 20 shards of 4096 rays, --hard_ratio
# 0.2, hard_mul 1), as distill_shards states it
TRAIN_BATCH = DISTILL["shards_per_batch"] * DISTILL["shard_rows"]
TRAIN_HARD = (int(DISTILL["hard_ratio"] * TRAIN_BATCH),) * 2   # (n_hard_in, n_hard_out)
TRAIN_POOL = int(TRAIN_BATCH * DISTILL["hard_mul"])
TRAIN_STEPS = 10
TRAIN_FRAMES = 4                    # 640,000 rays to draw the batches from
EVAL_B = 8192

# The kernels' tolerances against their plain versions, which
# chip_breakdown.py and chip_compare.py hold their variants and trees to
# and the frame checks below use. R2L kernels: the same bf16 operands and
# f32 epilogues, but the tensor cores sum in another order than the f32
# matmul; a one-ulp difference in an f32 activation can flip its bf16
# rounding, and that noise grows through 88 layers. The plain version
# alone, on the CPU and on the card, differed by up to 6.7e-4 on 2048 rays,
# the kernel by up to 1.5e-3 over 8192 and 160,000 rays (PERF.md). 4e-3 is
# 6x that noise; a wrong layout or index moves outputs by 1e-1 and more.
KERNEL_TOL = 4e-3
# The training forward's bf16 activations (hs), as max |kernel - plain|
# over max |plain|: the forward's noise, measured at most 6.5e-3.
HS_TOL = 2e-2
# The training backward's gradients, as max |kernel - plain| over max
# |plain|: the forward's noise plus bf16 roundings of dg2, dg1 and dpre
# that flip with the summation order through 43 blocks; the first card run
# measured at most 2.3e-3. A wrong index or orientation gives errors of
# order 1.
GRAD_TOL = 1e-2
# The backward's pass 2 against its plain version on the same scratch: the
# same bf16 products, summed in f32 in another order over up to 98,304
# rays, which moves a sum by some sqrt(n) ulps of the terms' scale:
# measured 1.1e-5 and 1.5e-5 at 98,304 rays.
WGRAD_TOL = 1e-4
# int8 kernel: the int8 products are exact on both sides and the epilogues
# round alike, so they differ only where the bf16 head's (or tail's) f32 sum
# lands an ulp apart and moves a value across a quantizer's rounding
# boundary: one int8 level, carried through the remaining blocks. The kernel
# measured up to 4.7e-3 over 8192 and 160,000 rays (PERF.md); a wrong
# layout, scale or rounding moves outputs by 1e-1 and more.
INT8_TOL = 8e-3
# Field-eval kernel, as max |kernel - plain| over max |plain| of sigma and of
# rgb: an f32 activation can land on the other side of a bf16 rounding and
# carry through 8 layers; the first card run measured up to 5.4e-3. A wrong
# layout or index gives errors of order 1.
TEACHER_TOL = 2e-2
# int8 field eval: where a bf16 product's f32 sum lands an ulp apart, an
# activation can cross a quantizer's rounding boundary and carry through the
# remaining layers: measured up to 2.7e-2 over a fine chunk of 6.29 M points.
INT8_TEACHER_TOL = 6e-2
# A rendered frame against the same frame through the plain versions, per
# ray (absolute: rgb and acc in [0, 1], depth in [0, 6]). The last sample of
# each pass stands for an interval of length 1e10, so a ray whose last sigma
# is within the kernel's noise of 0 turns opaque or clear as the sign flips:
# the first card run found one such ray in 32,768. So at most FRAME_SHARE
# of a frame's rays may differ beyond FRAME_TOL.
FRAME_TOL = {"rgb": 2e-2, "acc": 2e-2, "depth": 1e-1}
FRAME_SHARE = 1e-4

# The README student command's own network (README.md:88-91, no
# --trial.ON: factory.py:62 builds body_arch 'mlp'): head 1008 -> 256, 86
# plain linears, a global residual (--use_residual), sigmoid tail, f32
# (--compute_dtype's default). It trains at the train phase's batch and
# targets. MLP_STEPS steps give the held-out MSE's trend.
MLP_STEPS = 10
# One step on the card against the same step on the CPU (f32, TF32 off, the
# same weights and t_rand/hard-pool draws) on MLP_CHECK_RAYS rays, with
# exact embeds and with the command's fast embed. The loss: f32 sums in
# another order (6.4e-8 relative with exact embeds, 1.4e-6 with the fast
# one, in the first card runs). Gradients: the backward passes 86 relu
# masks, and a pre-activation within the two sides' rounding of 0 flips its
# mask and moves that ray's whole gradient below it, so the error grows
# from the tail down to body.0 (printed by layer). The first card runs
# measured body.0's gradient 8.2e-3 apart at its largest entry and 6.9e-3
# in norm with exact embeds; with the fast embed, whose doubling recurrence
# turns a one-ulp difference of the CUDA and CPU sin/cos into 2^9 ulps of a
# high-frequency feature and so flips more masks, 2.65e-2 and 2.48e-2. So
# each tensor's gradient is held in norm, ||card - cpu|| / ||cpu||: 2e-2
# with exact embeds, 5e-2 with the fast one; a wrong layer, mask or
# orientation gives errors of order 1. Weights after Adam, in units of lr,
# where the gradients agree to a tenth: at most a tenth of lr (0.021 and
# 0.024 measured); the other entries' gradients are noise-level and their
# share is printed.
MLP_CHECK_RAYS, MLP_CHECK_HARD = 2048, 512
MLP_CHECK_TOL = {"loss": 1e-5, "grad_norm": {False: 2e-2, True: 5e-2},
                 "update_lr": 0.1}
# the layers whose gradient error the check prints, from the tail down
MLP_CHECK_LAYERS = ("tail.0.weight", f"body.{2 * (R2L['depth'] - 3)}.weight",
                    f"body.{2 * ((R2L['depth'] - 2) // 2)}.weight", "body.0.weight",
                    "head.0.weight")

# The teacher at the lego config (perfbench/configs/nerf_lego.json): its
# frames at lego's camera, half_res 400x400
T_WIDTH, T_DEPTH = TEACHER["width"], TEACHER["depth"]
T_SAMPLES, T_IMPORTANCE = TEACHER["n_samples"], TEACHER["n_importance"]
T_CHUNK = TEACHER["chunk"]
T_FOCAL = inputs.focal_of(TEACHER["scene"])
PSEUDO_FRAMES = 6
PSEUDO_POSES = 4
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

# Teacher training at the lego config (config/scenes/lego.txt, main.py's
# no_batching loop): N_rand 1024 pixels of one random frame a step, from the
# central precrop_frac 0.5 for the first precrop_iters 500 steps, Adam at
# lrate 5e-4 with lrate_decay 500, f32 (--compute_dtype's default). 1000
# steps: the precrop's 500 and as many on the whole frame, whose edge the
# crop never shows (the sphere spans ~380 of the 400 pixels) and which the
# held-out frames and the loss of the last steps cover.
TT_TRAIN_FRAMES, TT_HELD_OUT = 20, 2
TT_N_RAND, TT_STEPS, TT_WARMUP = 1024, 1000, 10
TT_PRECROP_ITERS, TT_PRECROP_FRAC = 500, 0.5
TT_LRATE, TT_LRATE_DECAY = 5e-4, 500
TT_PSNR_GAIN = 3.0        # dB over the untrained teacher, held-out frames
# One step on the card against the same step on the CPU, f32 without TF32,
# the same weights and t_rand/u draws, on TT_CHECK_RAYS rays; with exact
# embeds (the step's own arithmetic) and with the training config's fast
# embed. The loss: f32 sums in another order (cuBLAS against the CPU's
# BLAS), measured 1.2e-7 relative in the first card run. Gradients, as
# max |card - cpu| over max |cpu| of each tensor: the fast embed's
# double-angle recurrence carries a one-ulp difference of the CUDA and CPU
# sin/cos (or of an FMA) through 9 doublings, 2^9 ulps of a high-frequency
# feature: the first run measured 1.5e-3 on the coarse network (1.4e-6
# with exact embeds), and 5e-3 is 3.3x that. The fine network sees the
# coarse weights through the inverse CDF, where a depth in a low-weight
# interval moves by up to ~1e-3 with them and the embed's 2^9 frequency
# turns that into a few per cent of a gradient's largest entry (2.1e-2
# measured; 9.1e-4 with exact embeds): it is held by ||card - cpu|| /
# ||cpu|| (9.7e-3 measured; 3e-2). Weights after Adam, whose first step
# moves each weight by lr * g / (|g| + eps): where the two gradients agree
# to a tenth (|card - cpu| <= |cpu| / 10) the updates agree to a tenth of
# lr at most; the other entries are noise-level gradients whose sign is
# not determined, and their share is printed.
TT_CHECK_RAYS = 128
TT_CHECK_TOL = {"loss": 1e-5, "coarse_grad": 5e-3, "fine_grad_norm": 3e-2,
                "update_lr": 0.1}
# The student distilled from the trained teacher's shards: 8 poses of pseudo
# shards (the bf16 teacher through kernels 5 and 6) and the 20 training
# frames as train_ shards, 20 shards a batch (--N_rand 20), the train
# phase's student and step (hard_ratio 0.2, --warmup_lr 0.0001,200).
DISTILL_POSES, DISTILL_STEPS = 8, 20
DISTILL_SHARDS = DISTILL["shards_per_batch"]
# The card's host link: PCIe Gen5 x16, 64 GB/s a direction (data sheet)
H100_HOST_BYTES = 64e9


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip()


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
    """The state the phases share: the card, the imports, the flagship's
    weights, the served frames' poses and rays, and the kernels line's
    entries."""

    def __init__(self, args):
        import torch

        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is false; this script needs a card")
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
        self.params = self.student_params(0)
        self.poses = [orbit(t) for t in (-150.0, -30.0, 90.0)]
        self.rays = [get_rays(FRAME_H, FRAME_W, FOCAL, p[:3, :4], device=self.dev)
                     for p in self.poses]
        self._teacher = None
        self.entries = {}

    def kernel(self, name: str, launches: int, err: float, **more) -> None:
        """The kernels line's entry of `name`: its launches on the phase's
        path, its largest absolute error against its plain version there and
        `more` (the tolerance it is held to: `tol` on that error, `rel_tol`
        on `rel_err`)."""
        self.entries[name] = {"name": name, "launches": launches, "max_abs_err": err, **more}

    def student_params(self, k: int):
        """The flagship's weights of seed --seed + k (k 0: the r2l cells')."""
        from perfbench.reference import r2l_w256d88

        return r2l_w256d88.init_params(R2L, inputs.torch_generator(self.seed + k, self.dev, 0))

    def teacher(self):
        """The teacher_train cell's coarse and fine networks (f32), made once."""
        if self._teacher is None:
            from perfbench.drivers.teacher_step import build_teacher
            from perfbench.reference import nerf_lego

            params = nerf_lego.init_params(TEACHER, inputs.torch_generator(self.seed, self.dev, 0))
            self._teacher = tuple(m.eval().requires_grad_(False)
                                  for m in build_teacher(TEACHER, params, self.dev))
        return self._teacher


def r2l_student(params, dev, **over):
    """The flagship R2LNet as the benchmark builds it, with `params`; `over`
    replaces keys of its configuration (dtype, use_residual)."""
    from perfbench.drivers.r2l_frames import build_student

    return build_student({**R2L, **over}, params, dev)


def phase_build(sm: Smoke) -> None:
    from efficient_nerf_tpu_torch.ops import _build, nerf_forward, nerf_frame, r2l_forward

    build_s = _build.build_all()
    print(f"build: {build_s:.1f} s for {', '.join(_build.SOURCES)}", flush=True)
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    # each student tile's instantiations, one line each (NT output columns a
    # warpgroup, W256 is NT 128; PARTS=1 runs the head of an input wider than
    # the embed's room in parts; NEED_DX=1 compiles pass 1's dx chain in; Q 1
    # static, 2 dynamic int8 scales), and its dynamic shared memory at the
    # flagship's width and padded input
    width = R2L["width"]
    in_pad = r2l_forward.pack_r2l_weights(sm.params, N_SAMPLE, L_FREQ)["head_w"].shape[1]
    for name, kernel, args in (("r2l_forward", "r2l_forward_kernel", ("NT", "PARTS")),
                               ("r2l_train", "r2l_train_fwd_kernel", ("NT", "PARTS")),
                               ("r2l_train", "r2l_train_bwd_kernel", ("NT", "NEED_DX")),
                               ("r2l_int8", "r2l_int8_kernel", ("NT", "PARTS", "Q"))):
        for cur, lines in sorted(ptxas_report(name, kernel).items()):
            m = re.search(r"ILi(\d+)ELb([01])E(?:Li(\d)E)?", cur)
            vals = ", ".join(f"{a}={v}" for a, v in zip(args, m.groups())) if m else "?"
            print(f"build: {kernel}<{vals}>: " + "; ".join(lines), flush=True)
        lib = ctypes.CDLL(str(_build.library_path(name)))
        smem = getattr(lib, kernel.replace("_kernel", "_smem_bytes"))
        smem.restype = ctypes.c_longlong
        print(f"build: {kernel} at W{width}, in_pad {in_pad}: {smem(in_pad, width)} bytes of "
              f"dynamic shared memory", flush=True)
    # pass 1's weight ring at each width it takes
    lib = ctypes.CDLL(str(_build.library_path("r2l_train")))
    print("build: r2l_train_bwd_kernel's weight ring: " + "; ".join(
        f"W{w} {lib.r2l_train_bwd_stages(w)} stages of {w * 128} bytes"
        for w in (64, 128, 192, 256)), flush=True)
    # the teacher's tiles: the field tile (bf16 and int8) at the lego
    # config's coarse and fine samples, the whole-ray tile at its rays a
    # block
    t_pad = nerf_forward.pack_nerf_weights(sm.teacher()[0].state_dict(),
                                           dtype=sm.torch.bfloat16)["in_pad"]
    for name in ("nerf_forward", "nerf_int8"):
        lib = ctypes.CDLL(str(_build.library_path(name)))
        smem, stages = getattr(lib, f"{name}_smem_bytes"), getattr(lib, f"{name}_ring_stages")
        smem.restype = ctypes.c_longlong
        print_tile("build", name, f"{name}_kernel", [
            (f"S={S}", smem(t_pad, T_WIDTH, T_DEPTH, S), stages(t_pad, T_WIDTH, T_DEPTH, S))
            for S in (T_SAMPLES, T_SAMPLES + T_IMPORTANCE)])
    lib = ctypes.CDLL(str(_build.library_path("nerf_frame")))
    lib.nerf_frame_smem_bytes.restype = ctypes.c_longlong
    R = nerf_frame._rays_per_block(T_SAMPLES)
    print_tile("build", "nerf_frame", "nerf_frame_kernel", [
        (f"R={R}, {T_SAMPLES} + {T_IMPORTANCE} samples",
         lib.nerf_frame_smem_bytes(t_pad, T_WIDTH, T_DEPTH, R, T_SAMPLES, T_IMPORTANCE),
         lib.nerf_frame_ring_stages(t_pad, T_WIDTH, T_DEPTH, R, T_SAMPLES, T_IMPORTANCE))])
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


def _frame_rays(sm: Smoke, i: int):
    """Frame i's rays, each [H * W, 3]."""
    return tuple(r.reshape(-1, 3).contiguous() for r in sm.rays[i])


def _check_frames(frames, label: str) -> None:
    for img in frames:
        if img.shape != (FRAME_H, FRAME_W, 3) or not img.isfinite().all() \
                or img.min() < 0 or img.max() > 1:
            fail(f"{label} has the wrong shape or values outside [0, 1]")


def phase_main(sm: Smoke) -> None:
    from efficient_nerf_tpu_torch.ops.r2l_forward import (
        pack_r2l_weights, r2l_forward_fused, r2l_forward_fused_ref)
    from efficient_nerf_tpu_torch.render import r2l_render_image

    torch, dev = sm.torch, sm.dev
    model = r2l_student(sm.params, dev).eval()
    c2ws = [p[:3, :4] for p in sm.poses]
    r2l_render_image(model, c2ws[0], FRAME_H, FRAME_W, FOCAL, NEAR, FAR,
                     N_SAMPLE, L_FREQ, device=dev)               # warm-up
    torch.cuda.synchronize()
    r2l_forward_fused.launches = 0
    # as a user calls it: numpy poses, the default device (CUDA)
    frames = [r2l_render_image(model, c2w, FRAME_H, FRAME_W, FOCAL, NEAR, FAR,
                               N_SAMPLE, L_FREQ) for c2w in c2ws]
    torch.cuda.synchronize()
    launches = r2l_forward_fused.launches
    print(f"main: 3 frames of {FRAME_H}x{FRAME_W}: r2l_forward_fused launches "
          f"{launches}", flush=True)
    if launches != len(frames):
        fail(f"expected one fused launch per frame, counted {launches}")
    _check_frames(frames, "frame")
    # the frame the renderer made, against the plain version on its rays
    fo, fd = _frame_rays(sm, 0)
    want = r2l_forward_fused_ref(pack_r2l_weights(model.state_dict(), N_SAMPLE, L_FREQ),
                                 fo, fd, NEAR, FAR, N_SAMPLE, L_FREQ, res_scale=model.res_scale,
                                 use_global_residual=model.use_residual)
    err = (frames[0].reshape(-1, 3).float() - want).abs().max().item()
    print(f"main: the frame r2l_render_image rendered against the plain version on its "
          f"{fo.shape[0]} rays: max {err:.3g} (tol {KERNEL_TOL:g})", flush=True)
    sm.kernel("r2l_forward_fused", launches, err, tol=KERNEL_TOL)
    if not err <= KERNEL_TOL:
        fail(f"the rendered frame differs from the plain version by {err}")


def phase_main_int8(sm: Smoke) -> None:
    from efficient_nerf_tpu_torch.ops import r2l_forward_fused
    from efficient_nerf_tpu_torch.ops.r2l_int8 import (
        pack_r2l_weights_int8, r2l_forward_int8, r2l_forward_int8_ref)
    from efficient_nerf_tpu_torch.render import (calibrate_serving_scales, r2l_forward_rays,
                                                 r2l_render_image)

    torch = sm.torch
    model = r2l_student(sm.params, sm.dev).eval()
    c2ws = [p[:3, :4] for p in sm.poses]
    fo, fd = _frame_rays(sm, 0)
    # once per checkpoint, as the serving cell calibrates: the first rays of frame 0
    scales = calibrate_serving_scales(model, fo[:INT8_CAL], fd[:INT8_CAL], NEAR, FAR,
                                      N_SAMPLE, L_FREQ)
    r2l_render_image(model, c2ws[0], FRAME_H, FRAME_W, FOCAL, NEAR, FAR, N_SAMPLE,
                     L_FREQ, quant="int8", act_scales=scales)          # warm-up
    torch.cuda.synchronize()
    r2l_forward_int8.launches = 0
    r2l_forward_fused.launches = 0
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
    _check_frames(frames, "int8 frame")

    # the frame the renderer made, against the plain version on its rays
    want = r2l_forward_int8_ref(pack_r2l_weights_int8(model.state_dict(), N_SAMPLE, L_FREQ),
                                fo, fd, NEAR, FAR, N_SAMPLE, L_FREQ, res_scale=model.res_scale,
                                use_global_residual=model.use_residual, act_scales=scales)
    e = (frames[0].reshape(-1, 3).float() - want).abs()
    print(f"main_int8: the frame r2l_render_image rendered against the plain version on "
          f"its {fo.shape[0]} rays: max {e.max().item():.3g} (mean {e.mean().item():.3g}, "
          f"share beyond {KERNEL_TOL:g} {(e.amax(-1) > KERNEL_TOL).float().mean().item():.5f}); "
          f"tol {INT8_TOL:g}", flush=True)
    sm.kernel("r2l_forward_int8", launches, e.max().item(), tol=INT8_TOL)
    if not e.max().item() <= INT8_TOL:
        fail(f"the int8 frame differs from its plain version by {e.max().item()}")

    frame_ms = cuda_ms(torch, lambda: r2l_render_image(
        model, c2ws[1], FRAME_H, FRAME_W, FOCAL, NEAR, FAR, N_SAMPLE, L_FREQ,
        quant="int8", act_scales=scales), 10)
    sm.int8_frame_ms = frame_ms
    # quality: the int8 frame against the bf16 kernel's frame
    d = (frames[0].reshape(-1, 3) - r2l_forward_rays(model, fo, fd, NEAR, FAR, N_SAMPLE,
                                                     L_FREQ)).abs()
    psnr = -10.0 * torch.log10((d ** 2).mean()).item()
    print(f"main_int8: r2l_render_image(quant='int8') {frame_ms:.3f} ms/frame "
          f"({fo.shape[0] / frame_ms * 1e3 / 1e6:.2f} M rays/s); the int8 frame against "
          f"the bf16 kernel's: max {d.max().item():.3g}, mean {d.mean().item():.3g}, PSNR "
          f"{psnr:.2f} dB ({sm.gpu})", flush=True)


def _train_kernel_errors(sm: Smoke, packed, x, kw) -> dict:
    """The training kernels against their plain versions on the sample
    points x: the forward's out (max |k - p|) and hs, pass 1 through the
    gradients pass 2's plain version makes of its scratch and of the plain
    scratch (an operand can differ by its whole size where a relu mask flips
    with the summation order, which the sums over rays average out), pass 2
    on pass 1's own scratch (each as max |k - p| / max |p|, and its largest
    absolute gap), both on the plain forward's hs; and whether two whole
    backward calls give the same gradient bits."""
    from efficient_nerf_tpu_torch.ops import r2l_train as rt

    torch = sm.torch
    out, hs = rt.r2l_train_fwd(packed, x, **kw)
    out_p, hs_p = rt.r2l_train_fwd_ref(packed, x, **kw)
    dout = torch.randn(out.shape, generator=sm.gen, device=sm.dev) * 1e-5
    err = {"out": (out - out_p).abs().max().item(), "hs": rel_err(hs, hs_p),
           "finite": bool(torch.isfinite(out).all() and torch.isfinite(hs.float()).all())}
    del out, out_p, hs
    kw = dict(need_dx=False, **kw)
    act = rt.r2l_train_bwd_act(packed, x, hs_p, dout, **kw)
    act_p = rt.r2l_train_bwd_act_ref(packed, x, hs_p, dout, **kw)
    g_k, g_p = rt.r2l_train_wgrad_ref(act, hs_p), rt.r2l_train_wgrad_ref(act_p, hs_p)
    err["pass 1"] = max(rel_err(g_k[k], g_p[k]) for k in rt._OPERANDS)
    err["pass 1 abs"] = max((g_k[k] - g_p[k]).abs().max().item() for k in rt._OPERANDS)
    del act_p, g_k, g_p
    g, g_p = rt.r2l_train_wgrad(act, hs_p), rt.r2l_train_wgrad_ref(act, hs_p)
    err["pass 2"] = max(rel_err(g[k], g_p[k]) for k in rt._OPERANDS)
    err["pass 2 abs"] = max((g[k] - g_p[k]).abs().max().item() for k in rt._OPERANDS)
    del act, g, g_p
    a = rt.r2l_train_bwd(packed, x, hs_p, dout, **kw)
    b = rt.r2l_train_bwd(packed, x, hs_p, dout, **kw)
    err["same_bits"] = all(torch.equal(a[k], b[k]) for k in rt._OPERANDS)
    return err


def phase_train(sm: Smoke) -> None:
    from efficient_nerf_tpu_torch.core.ray_sampler import sample_ray_points
    from efficient_nerf_tpu_torch.core.rays import get_rays
    from efficient_nerf_tpu_torch.ops import r2l_train as rt
    from efficient_nerf_tpu_torch.render import r2l_forward_rays
    from efficient_nerf_tpu_torch.train import (hard_pool_init, init_train_state,
                                                make_lr_schedule, make_r2l_train_step,
                                                parse_warmup)

    torch, dev, gen = sm.torch, sm.dev, sm.gen
    n_rays = TRAIN_BATCH + TRAIN_HARD[1]
    # rays of TRAIN_FRAMES frames around the object; targets rendered by a
    # second random R2L (another seed) through the served path
    rays = [get_rays(FRAME_H, FRAME_W, FOCAL, orbit(t)[:3, :4], device=dev)
            for t in torch.linspace(-180.0, 180.0, TRAIN_FRAMES + 1)[:-1].tolist()]
    all_o = torch.cat([o.reshape(-1, 3) for o, _ in rays])
    all_d = torch.cat([d.reshape(-1, 3) for _, d in rays])
    teacher = r2l_student(sm.student_params(1), dev, dtype="float32",
                          use_residual=False).eval()
    all_t = r2l_forward_rays(teacher, all_o, all_d, NEAR, FAR, N_SAMPLE, L_FREQ)
    ev = torch.randint(0, all_o.shape[0], (EVAL_B,), generator=gen, device=dev)
    sm.train_data = (all_o, all_d, all_t, ev)

    model = r2l_student(sm.params, dev)
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

    # the kernels against their plain versions at the step's shape, where
    # pass 2 sums the weight gradients of 1,536 ray tiles: the last batch's
    # rays with as many hard rays, and the trained weights
    o, d, _ = batches[-1]
    x = sample_ray_points(torch.cat([o, o[:TRAIN_HARD[1]]]), torch.cat([d, d[:TRAIN_HARD[1]]]),
                          NEAR, FAR, N_SAMPLE, perturb=True, generator=gen).contiguous()
    packed = rt.pack_r2l_train_weights(rt._model_params(model), L_FREQ, torch.bfloat16)
    err = _train_kernel_errors(sm, packed, x, dict(res_scale=model.res_scale,
                                                   use_global_residual=model.use_residual))
    print(f"train: the kernels against their plain versions at B={n_rays}: r2l_train_fwd out "
          f"{err['out']:.3g} (tol {KERNEL_TOL:g}), hs {err['hs']:.3g} (tol {HS_TOL:g}); "
          f"pass 1 (r2l_train_bwd_act), its gradients {err['pass 1']:.3g} (tol {GRAD_TOL:g}); "
          f"pass 2 (r2l_train_wgrad) {err['pass 2']:.3g} (tol {WGRAD_TOL:g}), each of its "
          f"largest magnitude; two backward calls bit for bit: {err['same_bits']}", flush=True)
    sm.kernel("r2l_train_fwd", launches[0], err["out"], tol=KERNEL_TOL)
    sm.kernel("r2l_train_bwd_act", launches[1], err["pass 1 abs"], rel_err=err["pass 1"],
              rel_tol=GRAD_TOL)
    sm.kernel("r2l_train_wgrad", launches[2], err["pass 2 abs"], rel_err=err["pass 2"],
              rel_tol=WGRAD_TOL)
    if not (err["finite"] and err["out"] <= KERNEL_TOL and err["hs"] <= HS_TOL):
        fail(f"the training forward differs from its plain version at B={n_rays}: {err}")
    if not (err["pass 1"] <= GRAD_TOL and err["pass 2"] <= WGRAD_TOL):
        fail(f"a backward pass differs from its plain version at B={n_rays}: {err}")
    if not err["same_bits"]:
        fail(f"two backward calls on the same inputs differ in their bits at B={n_rays}")


def mlp_state_dict(seed: int, torch):
    """Reference-layout state_dict of the README student command's network
    (body_arch 'mlp', W256 D88, input 1008), initialised as flax initialises
    it: lecun-normal kernels (a normal truncated at 2 std, of std
    1/sqrt(fan_in) after the truncation) and zero biases."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def lin(fan_in, fan_out):
        w = rng.normal(size=(fan_out, fan_in))
        out = np.abs(w) > 2.0
        while out.any():
            w[out] = rng.normal(size=int(out.sum()))
            out = np.abs(w) > 2.0
        w *= 1.0 / np.sqrt(fan_in) / 0.87962566103423978
        return torch.tensor(w.astype(np.float32)), torch.zeros(fan_out)

    sd = {}
    w = R2L["width"]
    sd["head.0.weight"], sd["head.0.bias"] = lin(R2L["input_dim"], w)
    for i in range(R2L["depth"] - 2):
        sd[f"body.{2 * i}.weight"], sd[f"body.{2 * i}.bias"] = lin(w, w)
    sd["tail.0.weight"], sd["tail.0.bias"] = lin(w, 3)
    return sd


def _kernel_fns():
    """Every kernel wrapper of the port (each counts its launches)."""
    from efficient_nerf_tpu_torch.ops import (nerf_forward, nerf_frame, nerf_int8,
                                              r2l_forward, r2l_int8, r2l_train,
                                              sample_pdf, trig)

    return (r2l_forward.r2l_forward_fused, r2l_int8.r2l_forward_int8,
            r2l_train.r2l_train_fwd, r2l_train.r2l_train_bwd_act,
            r2l_train.r2l_train_wgrad, nerf_forward.nerf_forward_fused,
            nerf_int8.nerf_forward_int8, sample_pdf.sample_pdf_det_fused,
            nerf_frame.nerf_render_rays_fused, trig.fast_sincos_cuda)


def _kernel_launches():
    """{kernel: launch count} of every wrapper of the port."""
    return {f.__name__: f.launches for f in _kernel_fns()}


def _mlp_step_check(sm: Smoke, sd, schedule, fast_embed: bool) -> dict:
    """One step of the mlp student (f32) on the card against the same step
    on the CPU, from the same weights and t_rand/hard-pool draws, on
    MLP_CHECK_RAYS rays: the loss's relative error; the gradients as max
    |card - cpu| / max |cpu| and in norm, with the worst tensor, and in norm
    for MLP_CHECK_LAYERS; the weights
    after Adam in units of lr where the gradients agree to a tenth, and the
    share of entries where they do not."""
    from efficient_nerf_tpu_torch.models import R2LNet
    from efficient_nerf_tpu_torch.train import (hard_pool_init, init_train_state,
                                                make_r2l_train_step)

    torch = sm.torch
    all_o, all_d, all_t, _ = sm.train_data
    n_hard = MLP_CHECK_HARD
    n_batch = MLP_CHECK_RAYS - n_hard
    g = torch.Generator().manual_seed(sm.seed)
    pick = torch.randint(0, all_o.shape[0], (n_batch,), generator=g).to(sm.dev)
    batch = [x[pick].cpu() for x in (all_o, all_d, all_t)]
    noise = {"t_rand": torch.rand(MLP_CHECK_RAYS, N_SAMPLE, generator=g),
             "idx_out": torch.randperm(n_batch, generator=g)[:n_hard],
             "batch_idx": torch.randint(0, n_batch, (n_hard,), generator=g)}
    out = []
    for dev in (sm.dev, torch.device("cpu")):
        model = R2LNet(R2L["input_dim"], R2L["depth"], R2L["width"], body_arch="mlp",
                       use_residual=True)
        model.load_state_dict(sd)
        model.to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=5e-4, betas=(0.9, 0.999), eps=1e-8)
        step = make_r2l_train_step(model, opt, near=NEAR, far=FAR, n_sample=N_SAMPLE,
                                   L=L_FREQ, perturb=True, hard=(n_hard, n_hard),
                                   fast_embed=fast_embed, schedule=schedule,
                                   device=dev)
        _, _, met = step(init_train_state(model, opt), hard_pool_init(n_batch, device=dev),
                         None, *[x.to(dev) for x in batch],
                         noise={k: v.to(dev) for k, v in noise.items()})
        out.append({"loss": met["loss_rgb"].item(),
                    "params": {k: (p.detach().cpu(), p.grad.cpu())
                               for k, p in model.named_parameters()}})
    card, cpu = out
    err = {"loss": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
           "loss_value": cpu["loss"],
           **_grad_agreement(card["params"], cpu["params"], schedule(0))}
    err["by_layer"] = {k: ((card["params"][k][1] - cpu["params"][k][1]).norm()
                           / cpu["params"][k][1].norm()).item()
                       for k in MLP_CHECK_LAYERS}
    return err


def phase_train_mlp(sm: Smoke) -> None:
    """The README student command's own network (body_arch 'mlp', no
    kernel covers it: the unfused cuBLAS path), trained on the train
    phase's rays and targets and served."""
    from efficient_nerf_tpu_torch.models import R2LNet
    from efficient_nerf_tpu_torch.render import r2l_forward_rays, r2l_render_image
    from efficient_nerf_tpu_torch.train import (hard_pool_init, init_train_state,
                                                make_lr_schedule, make_r2l_train_step,
                                                parse_warmup)

    torch, dev, gen = sm.torch, sm.dev, sm.gen
    if not hasattr(sm, "train_data"):
        fail("train_mlp reads the train phase's rays and targets: run both")
    all_o, all_d, all_t, ev = sm.train_data
    n_rays = TRAIN_BATCH + TRAIN_HARD[1]
    sd = mlp_state_dict(sm.seed, torch)
    schedule = make_lr_schedule(5e-4, 500, parse_warmup("0.0001,200"))
    before = _kernel_launches()

    # ---- agreement: one f32 step on the card against the CPU
    for fast in (False, True):
        err = _mlp_step_check(sm, sd, schedule, fast)
        tol = dict(MLP_CHECK_TOL, grad_norm=MLP_CHECK_TOL["grad_norm"][fast])
        print(f"train_mlp: one f32 step on the card against the CPU, "
              f"{'fast' if fast else 'exact'} embed ({MLP_CHECK_RAYS} rays, "
              f"{MLP_CHECK_HARD} of them hard, the same weights and draws): loss "
              f"{err['loss_value']:.6f}, relative error {err['loss']:.3g} (tol "
              f"{tol['loss']:g}); gradients ||card - cpu|| / ||cpu|| "
              f"{err['grad_norm']:.3g} at {err['grad_norm_at']} (tol "
              f"{tol['grad_norm']:g}), by layer from the tail down "
              + ", ".join(f"{k} {v:.3g}" for k, v in err["by_layer"].items())
              + f"; max |card - cpu| / max |cpu| {err['grad']:.3g} at "
              f"{err['grad_at']}; weights after Adam {err['update_lr']:.3g} lr at "
              f"{err['update_lr_at']} where the gradients agree to a tenth (tol "
              f"{tol['update_lr']:g}), {err['undetermined'] * 100:.3f}% of the "
              f"entries where they do not", flush=True)
        for key in ("loss", "grad_norm", "update_lr"):
            if not err[key] <= tol[key]:
                fail(f"the mlp step on the card differs from the CPU's "
                     f"({'fast' if fast else 'exact'} embed): {key} {err[key]:.3g} "
                     f"(tol {tol[key]})")

    def student(dtype):
        m = R2LNet(R2L["input_dim"], R2L["depth"], R2L["width"], body_arch="mlp",
                   use_residual=True, dtype=dtype)
        m.load_state_dict(sd)
        return m.to(dev)

    def eval_mse(m):
        with torch.no_grad():
            rgb = r2l_forward_rays(m, all_o[ev], all_d[ev], NEAR, FAR, N_SAMPLE, L_FREQ)
            return ((rgb - all_t[ev]) ** 2).mean().item()

    def batch():
        i = torch.randint(0, all_o.shape[0], (TRAIN_BATCH,), generator=gen, device=dev)
        return all_o[i], all_d[i], all_t[i]

    # ---- the command's step: fused=True has no kernel to take
    model = student(torch.float32)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4, betas=(0.9, 0.999),
                           eps=1e-8, fused=True)
    try:
        make_r2l_train_step(model, opt, near=NEAR, far=FAR, n_sample=N_SAMPLE,
                            L=L_FREQ, hard=TRAIN_HARD, fused=True)
        fail("make_r2l_train_step(fused=True) accepted the mlp student")
    except ValueError as e:
        print(f"train_mlp: fused=True on the mlp student raises ValueError: {e}",
              flush=True)

    steps_ms = {}
    # the forward and the backward without the input gradient; the mlp body
    # has the resmlp's 86 body linears, so the yardstick's counts hold
    flop = 2 * (Y.r2l_forward_macs(R2L) + Y.r2l_backward_macs(R2L)) * n_rays
    peak = {"bfloat16": Y.PEAK_BF16_FLOPS, "float32": Y.PEAK_F32_FLOPS}
    floor = {k: flop / v * 1e3 for k, v in peak.items()}
    for dtype in (torch.float32, torch.bfloat16):
        if dtype is torch.bfloat16:
            trained = {k: v.detach().clone() for k, v in model.state_dict().items()}
            model = student(dtype)
            model.load_state_dict(trained)
            opt = torch.optim.Adam(model.parameters(), lr=5e-4, betas=(0.9, 0.999),
                                   eps=1e-8, fused=True)
        step = make_r2l_train_step(model, opt, near=NEAR, far=FAR, n_sample=N_SAMPLE,
                                   L=L_FREQ, perturb=True, hard=TRAIN_HARD,
                                   schedule=schedule)
        state = init_train_state(model, opt)
        pool = hard_pool_init(TRAIN_POOL)
        name = str(dtype).split(".")[-1]
        if dtype is torch.float32:
            # the held-out MSE over the command's first steps
            mses = [eval_mse(model)]
            losses = []
            for _ in range(MLP_STEPS):
                state, pool, met = step(state, pool, gen, *batch())
                losses.append(met["loss_rgb"])
                mses.append(eval_mse(model))
            losses = [v.item() for v in losses]
            print(f"train_mlp: {MLP_STEPS} f32 steps of {n_rays} rays: loss_rgb "
                  + " ".join(f"{v:.5f}" for v in losses) + f"; held-out MSE on "
                  f"{EVAL_B} rays " + " ".join(f"{v:.6f}" for v in mses)
                  + f" ({'fell' if mses[-1] < mses[0] else 'did NOT fall'})",
                  flush=True)
            if not all(math.isfinite(v) for v in losses + mses):
                fail("a loss or held-out MSE of the mlp student is not finite")
        o, d, t = batch()
        steps_ms[name] = cuda_ms(torch, lambda: step(state, pool, gen, o, d, t), 5,
                                 warmup=2)
        print(f"train_mlp: {name} step {steps_ms[name]:.3f} ms at {n_rays} rays "
              f"({n_rays / steps_ms[name] * 1e3 / 1e6:.3f} M rays/s); floor "
              f"{floor[name]:.3f} ms ({flop / 1e12:.3f} TFLOP at "
              f"{peak[name] / 1e12:.0f} "
              f"TFLOP/s) -> {floor[name] / steps_ms[name] * 100:.1f}% of it; TF32 "
              f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}",
              flush=True)

    sm.mlp_steps_ms = steps_ms
    # ---- serving the trained student in bf16 (the model above)
    model.eval()
    c2w = sm.poses[1][:3, :4]
    img = r2l_render_image(model, c2w, FRAME_H, FRAME_W, FOCAL, NEAR, FAR,
                           N_SAMPLE, L_FREQ)
    torch.cuda.synchronize()
    _check_frames([img], "the mlp student's frame")
    frame_ms = cuda_ms(torch, lambda: r2l_render_image(
        model, c2w, FRAME_H, FRAME_W, FOCAL, NEAR, FAR, N_SAMPLE, L_FREQ), 5)
    print(f"train_mlp: r2l_render_image of the trained mlp student, bf16 unfused "
          f"(cuBLAS): {frame_ms:.3f} ms/frame ({FRAME_H * FRAME_W / frame_ms * 1e3 / 1e6:.2f} "
          f"M rays/s)", flush=True)

    after = _kernel_launches()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    print(f"train_mlp: kernel launches in this phase: {moved or 'none'}", flush=True)
    if moved:
        fail(f"a kernel launched for the mlp student: {moved}")


def teacher_config():
    """The teacher's RenderConfig, as the teacher_train cell makes it."""
    from perfbench.drivers.teacher_step import render_config

    return render_config(TEACHER)


def _render_plain(sm: Smoke, nets, c2w, cfg, chunk: int = 8192):
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
        return renderer.render_image(*nets, FRAME_H, FRAME_W, T_FOCAL, c2w,
                                     dataclasses.replace(cfg, chunk=chunk), device=sm.dev)
    finally:
        for k, fn in zip(names, saved):
            setattr(renderer, k, fn)


def _frame_diff(sm: Smoke, label: str, got, want) -> tuple:
    """Prints how far two renders of a frame lie apart, per ray under
    FRAME_TOL; returns the share of rays beyond it and rgb's largest gap
    over the other rays."""
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
    return share, diff["rgb"][~beyond].max().item()


def _check_teacher_frames(frames, label: str) -> None:
    for f in frames:
        if f.rgb.shape != (FRAME_H, FRAME_W, 3) or not f.rgb.isfinite().all() \
                or f.rgb.min() < 0 or f.rgb.max() > 1 + 1e-6 \
                or not f.depth.isfinite().all() or not f.acc.isfinite().all():
            fail(f"{label} has the wrong shape, values that are not finite or rgb "
                 f"outside [0, 1]")


def phase_teacher(sm: Smoke) -> None:
    import numpy as np

    from efficient_nerf_tpu_torch.ops.nerf_forward import nerf_forward_fused
    from efficient_nerf_tpu_torch.ops.sample_pdf import sample_pdf_det_fused
    from efficient_nerf_tpu_torch.render import render_image

    torch, nets = sm.torch, sm.teacher()
    cfg = teacher_config().eval_mode()
    c2ws = [np.asarray(p[:3, :4]) for p in sm.poses]
    render_image(*nets, FRAME_H, FRAME_W, T_FOCAL, c2ws[0], cfg)   # warm-up
    torch.cuda.synchronize()
    nerf_forward_fused.launches = 0
    sample_pdf_det_fused.launches = 0
    # as a user calls it: numpy poses, the default device (CUDA)
    frames = [render_image(*nets, FRAME_H, FRAME_W, T_FOCAL, c2w, cfg)
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
    _check_teacher_frames(frames, "teacher frame")
    acc = frames[0].acc
    acc_mean = acc.mean().item()
    acc_mid = ((acc > 0.01) & (acc < 0.99)).float().mean().item()
    print(f"teacher: frame 0 mean acc {acc_mean:.4f}, share of rays with acc in "
          f"(0.01, 0.99) {acc_mid:.4f}, rgb in [{frames[0].rgb.min().item():.4f}, "
          f"{frames[0].rgb.max().item():.4f}]", flush=True)
    if not 0.01 < acc_mid:
        fail("the teacher frame is degenerate: almost no ray is partly opaque")

    plain = _render_plain(sm, nets, c2ws[0], cfg)
    torch.cuda.synchronize()
    frame_share, err = _frame_diff(sm, "teacher: frame 0 against the same frame through the "
                                   "plain versions", frames[0], plain)
    for k, n in zip(("nerf_forward_fused", "sample_pdf_det_fused"), launches):
        sm.kernel(k, n, err, tol=FRAME_TOL["rgb"], share_beyond=frame_share)
    if frame_share > FRAME_SHARE:
        fail(f"teacher frame differs from the plain versions' frame in a share "
             f"{frame_share:.2e} of its rays")
    del plain
    sm.teacher_frame0 = frames[0]

    frame_ms = cuda_ms(torch, lambda: render_image(
        *nets, FRAME_H, FRAME_W, T_FOCAL, c2ws[1], cfg), 3, warmup=1)
    print(f"teacher: render_image {frame_ms:.3f} ms/frame ({n_rays / frame_ms * 1e3 / 1e6:.3f} "
          f"M rays/s) ({sm.gpu})", flush=True)
    sm.teacher_frame_ms = frame_ms


def phase_pseudo(sm: Smoke) -> None:
    import os

    import numpy as np

    from efficient_nerf_tpu_torch.core.poses import random_spherical_pose
    from efficient_nerf_tpu_torch.data import (SHARD_ROWS, StreamingPseudoGenerator,
                                               export_pseudo_shards,
                                               make_pseudo_frame_renderer)
    from efficient_nerf_tpu_torch.ops.nerf_forward import nerf_forward_fused
    from efficient_nerf_tpu_torch.ops.sample_pdf import sample_pdf_det_fused

    torch, nets = sm.torch, sm.teacher()
    cfg = teacher_config()
    gen = StreamingPseudoGenerator(
        *nets, cfg, FRAME_H, FRAME_W, T_FOCAL, batch_rays=4096,
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
        last = export_pseudo_shards(*nets, cfg, FRAME_H, FRAME_W, T_FOCAL, out,
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
    render = make_pseudo_frame_renderer(*nets, cfg, FRAME_H, FRAME_W, T_FOCAL)
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


def phase_teacher_int8(sm: Smoke) -> None:
    import dataclasses

    import numpy as np

    from efficient_nerf_tpu_torch.data import StreamingPseudoGenerator
    from efficient_nerf_tpu_torch.ops.nerf_forward import nerf_forward_fused
    from efficient_nerf_tpu_torch.ops.nerf_int8 import nerf_forward_int8
    from efficient_nerf_tpu_torch.ops.sample_pdf import sample_pdf_det_fused
    from efficient_nerf_tpu_torch.render import render_image

    torch, nets = sm.torch, sm.teacher()
    cfg8 = dataclasses.replace(teacher_config(), teacher_quant="int8")
    cfg = cfg8.eval_mode()
    c2ws = [np.asarray(p[:3, :4]) for p in sm.poses]
    chunks = -(-FRAME_H * FRAME_W // T_CHUNK)
    counters = (nerf_forward_int8, nerf_forward_fused, sample_pdf_det_fused)

    def counts():
        return tuple(f.launches for f in counters)

    def reset():
        for f in counters:
            f.launches = 0

    render_image(*nets, FRAME_H, FRAME_W, T_FOCAL, c2ws[0], cfg)   # warm-up
    torch.cuda.synchronize()
    reset()
    # as a user calls it: numpy poses, the default device (CUDA)
    frames = [render_image(*nets, FRAME_H, FRAME_W, T_FOCAL, c2w, cfg) for c2w in c2ws]
    torch.cuda.synchronize()
    launches = counts()
    print(f"teacher_int8: 3 frames of {FRAME_H}x{FRAME_W} with teacher_quant='int8' "
          f"({chunks} chunks each): nerf_forward_int8 launches {launches[0]}, "
          f"nerf_forward_fused {launches[1]}, sample_pdf_det_fused {launches[2]}", flush=True)
    if launches != (2 * chunks * 3, 0, chunks * 3):
        fail(f"expected 2 int8 field-eval, no bf16 field-eval and 1 sampler launch a "
             f"chunk, counted {launches} over 3 frames")
    _check_teacher_frames(frames, "int8 teacher frame")
    # the plain versions in the same chunks, so that each call calibrates on
    # the same points
    plain = _render_plain(sm, nets, c2ws[0], cfg, chunk=T_CHUNK)
    torch.cuda.synchronize()
    share, err = _frame_diff(sm, "teacher_int8: frame 0 against the same frame through the "
                             "plain versions", frames[0], plain)
    del plain
    sm.kernel("nerf_forward_int8", launches[0], err, tol=FRAME_TOL["rgb"], share_beyond=share)
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
        *nets, cfg8, FRAME_H, FRAME_W, T_FOCAL, batch_rays=4096,
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

    frame_ms = cuda_ms(torch, lambda: render_image(
        *nets, FRAME_H, FRAME_W, T_FOCAL, c2ws[1], cfg), 3, warmup=1)
    print(f"teacher_int8: render_image(teacher_quant='int8') {frame_ms:.3f} ms/frame "
          f"({FRAME_H * FRAME_W / frame_ms * 1e3 / 1e6:.3f} M rays/s) against the bf16 "
          f"frame's {sm.teacher_frame_ms:.3f} ({sm.gpu})", flush=True)


def phase_teacher_frame(sm: Smoke) -> None:
    import dataclasses

    import numpy as np

    from efficient_nerf_tpu_torch.ops.nerf_forward import nerf_forward_fused
    from efficient_nerf_tpu_torch.ops.nerf_frame import nerf_render_rays_fused
    from efficient_nerf_tpu_torch.ops.sample_pdf import sample_pdf_det_fused
    from efficient_nerf_tpu_torch.render import render_image

    torch, nets = sm.torch, sm.teacher()
    cfg = dataclasses.replace(teacher_config(), frame_fused=True).eval_mode()
    c2ws = [np.asarray(p[:3, :4]) for p in sm.poses]
    chunks = -(-FRAME_H * FRAME_W // T_CHUNK)
    counters = (nerf_render_rays_fused, nerf_forward_fused, sample_pdf_det_fused)
    render_image(*nets, FRAME_H, FRAME_W, T_FOCAL, c2ws[0], cfg)   # warm-up
    torch.cuda.synchronize()
    for f in counters:
        f.launches = 0
    # as a user calls it: numpy poses, the default device (CUDA)
    frames = [render_image(*nets, FRAME_H, FRAME_W, T_FOCAL, c2w, cfg) for c2w in c2ws]
    torch.cuda.synchronize()
    launches = tuple(f.launches for f in counters)
    print(f"teacher_frame: 3 frames of {FRAME_H}x{FRAME_W} with frame_fused ({chunks} chunks "
          f"each): nerf_render_rays_fused launches {launches[0]}, nerf_forward_fused "
          f"{launches[1]}, sample_pdf_det_fused {launches[2]}", flush=True)
    if launches != (chunks * 3, 0, 0):
        fail(f"expected one whole-ray launch a chunk and no other teacher kernel, counted "
             f"{launches} over 3 frames")
    _check_teacher_frames(frames, "whole-ray frame")
    plain = _render_plain(sm, nets, c2ws[0], cfg)
    torch.cuda.synchronize()
    share, err = _frame_diff(sm, "teacher_frame: frame 0 against the same frame through the "
                             "plain version", frames[0], plain)
    del plain
    sm.kernel("nerf_render_rays_fused", launches[0], err, tol=FRAME_TOL["rgb"],
              share_beyond=share)
    if share > FRAME_SHARE:
        fail(f"the whole-ray frame differs from the plain version's frame in a share "
             f"{share:.2e} of its rays")
    share, _ = _frame_diff(sm, "teacher_frame: frame 0 against the composed kernel path's "
                           "frame 0 (teacher phase)", frames[0], sm.teacher_frame0)
    if share > FRAME_SHARE:
        fail(f"the whole-ray frame differs from the composed path's in a share {share:.2e} "
             f"of its rays")
    del frames
    frame_ms = cuda_ms(torch, lambda: render_image(
        *nets, FRAME_H, FRAME_W, T_FOCAL, c2ws[1], cfg), 3, warmup=1)
    print(f"teacher_frame: render_image(frame_fused=True) {frame_ms:.3f} ms/frame "
          f"({FRAME_H * FRAME_W / frame_ms * 1e3 / 1e6:.3f} M rays/s) against the composed "
          f"kernel path's {sm.teacher_frame_ms:.3f} ms ({sm.gpu})", flush=True)


def _sphere_frames(sm: Smoke):
    """The training and held-out frames of the sphere scene in memory, as
    data.synthetic.make_synthetic_scene poses them: training poses at random
    theta in (-180, 180) and phi in (-75, -15), held-out ones evenly round
    at phi -30, radius 4; each frame composited on white. Returns [(pose
    [4, 4], rgb [H, W, 3] numpy)] for each."""
    import numpy as np

    from efficient_nerf_tpu_torch.core.poses import pose_spherical
    from efficient_nerf_tpu_torch.data import render_sphere_frame

    rng = np.random.default_rng(sm.seed)

    def frame(pose):
        img = render_sphere_frame(pose, FRAME_H, FRAME_W, T_FOCAL)
        return pose, img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])

    train = [frame(pose_spherical(rng.uniform(-180, 180), rng.uniform(-75, -15), 4.0))
             for _ in range(TT_TRAIN_FRAMES)]
    held = [frame(pose_spherical(-180 + 360 * i / TT_HELD_OUT, -30.0, 4.0))
            for i in range(TT_HELD_OUT)]
    return train, held


def _teacher_pair(torch, dev, dtype=None, like=None):
    """Coarse and fine lego-config NeRFMLPs on `dev`: fresh ones from torch's
    seeded default init, or copies of `like`'s weights with compute dtype
    `dtype`."""
    from efficient_nerf_tpu_torch.models import NeRFMLP

    pair = []
    for i in range(2):
        m = NeRFMLP(depth=T_DEPTH, width=T_WIDTH, dtype=dtype or torch.float32)
        if like is not None:
            m.load_state_dict(like[i].state_dict())
        pair.append(m.to(dev))
    return pair


def _step_check(sm: Smoke, models, cfg, schedule, frames) -> dict:
    """One teacher step on the card against the same step on the CPU, from
    copies of `models`, with the same t_rand/u draws: the loss's relative
    error; each network's gradients as max |card - cpu| / max |cpu| and in
    norm, with the worst tensor; the weights after Adam in units of lr where
    the gradients agree to a tenth, and the share of entries where they do
    not."""
    import numpy as np

    from efficient_nerf_tpu_torch.core.rays import get_rays_np
    from efficient_nerf_tpu_torch.core.sampling import sorted_uniform
    from efficient_nerf_tpu_torch.train import init_train_state, make_teacher_train_step

    torch = sm.torch
    rng = np.random.default_rng(sm.seed + 1)
    pose, rgb = frames[0]
    o, d = get_rays_np(FRAME_H, FRAME_W, T_FOCAL, pose[:3, :4])
    pick = rng.permutation(FRAME_H * FRAME_W)[:TT_CHECK_RAYS]
    batch = [torch.from_numpy(np.ascontiguousarray(x.reshape(-1, 3)[pick], np.float32))
             for x in (o, d, rgb)]
    g = torch.Generator().manual_seed(sm.seed)
    noise = {"t_rand": torch.rand(TT_CHECK_RAYS, T_SAMPLES, generator=g),
             "u": sorted_uniform((TT_CHECK_RAYS, T_IMPORTANCE), g)}
    out = []
    for dev in (sm.dev, torch.device("cpu")):
        pair = _teacher_pair(torch, dev, like=models)
        opt = torch.optim.Adam([p for m in pair for p in m.parameters()], lr=TT_LRATE,
                               betas=(0.9, 0.999), eps=1e-8)
        step = make_teacher_train_step(pair[0], pair[1], opt, cfg, schedule=schedule,
                                       device=dev)
        state = init_train_state(torch.nn.ModuleDict({"coarse": pair[0], "fine": pair[1]}),
                                 opt)
        _, met = step(state, None, *[x.to(dev) for x in batch],
                      noise={k: v.to(dev) for k, v in noise.items()})
        out.append({"loss": met["loss"].item(),
                    "params": [{k: (p.detach().cpu(), p.grad.cpu())
                                for k, p in m.named_parameters()} for m in pair]})
    card, cpu = out
    err = {"loss": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
           "loss_value": cpu["loss"]}
    for i, name in enumerate(("coarse", "fine")):
        err.update({f"{name}_{k}": v for k, v in _grad_agreement(
            card["params"][i], cpu["params"][i], TT_LRATE).items()})
    err["update_lr"] = max(err["coarse_update_lr"], err["fine_update_lr"])
    return err


def _grad_agreement(card: dict, cpu: dict, lr: float) -> dict:
    """One network's {name: (weight after Adam, gradient)} on the card
    against the CPU's: the worst tensor's max |card - cpu| / max |cpu| of
    the gradient ("grad") and its norm ratio ("grad_norm"), the weights'
    largest difference in units of lr where the gradients agree to a tenth
    ("update_lr"), each with the tensor's name (key + "_at"), and the share
    of entries where they do not ("undetermined")."""
    worst = {"grad": (0.0, ""), "grad_norm": (0.0, ""), "update_lr": (0.0, "")}
    undetermined = total = 0
    for k, (w_a, g_a) in card.items():
        w_b, g_b = cpu[k]
        dg = (g_a - g_b).abs()
        sure = dg <= g_b.abs() / 10
        undetermined += int((~sure).sum())
        total += g_b.numel()
        moved = ((w_a - w_b).abs()[sure].max().item() / lr) if sure.any() else 0.0
        for key, v in (("grad", (dg.max() / g_b.abs().max()).item()),
                       ("grad_norm", ((g_a - g_b).norm() / g_b.norm()).item()),
                       ("update_lr", moved)):
            worst[key] = max(worst[key], (v, k))
    err = {"undetermined": undetermined / total}
    for key, (v, k) in worst.items():
        err[key], err[f"{key}_at"] = v, k
    return err


def _frame_quality(sm: Smoke, res, gt) -> tuple:
    """(PSNR, SSIM) of a rendered frame against its ground truth."""
    from efficient_nerf_tpu_torch.metrics import psnr, ssim_image

    want = sm.torch.as_tensor(gt, dtype=sm.torch.float32, device=sm.dev)
    return psnr(res.rgb, want).item(), ssim_image(res.rgb, want).item()


def phase_teacher_train(sm: Smoke) -> None:
    import dataclasses

    import numpy as np

    from efficient_nerf_tpu_torch.core.rays import get_rays
    from efficient_nerf_tpu_torch.ops.nerf_forward import nerf_forward_fused
    from efficient_nerf_tpu_torch.ops.sample_pdf import sample_pdf_det_fused
    from efficient_nerf_tpu_torch.render import render_image
    from efficient_nerf_tpu_torch.train import (init_train_state, make_lr_schedule,
                                                make_teacher_train_step)

    torch, dev = sm.torch, sm.dev
    t0 = time.perf_counter()
    train, held = _sphere_frames(sm)
    data_s = time.perf_counter() - t0
    cfg = teacher_config()                    # perturbed, the unfused field eval
    eval_f32 = dataclasses.replace(cfg.eval_mode(), fused_teacher=False)
    schedule = make_lr_schedule(TT_LRATE, TT_LRATE_DECAY)
    torch.manual_seed(sm.seed)
    models = _teacher_pair(torch, dev)

    for label, c in (("exact embeds", dataclasses.replace(cfg, fast_embed=False)),
                     ("the training config", cfg)):
        ck = _step_check(sm, models, c, schedule, train)
        print(f"teacher_train: one step on the card against the CPU with {label}, f32 "
              f"without TF32, {TT_CHECK_RAYS} rays, the same weights and t_rand/u draws: loss "
              f"{ck['loss_value']:.6f}, relative error {ck['loss']:.3g}; "
              + "; ".join(
                  f"{n} gradients {ck[f'{n}_grad']:.3g} of their largest entry "
                  f"({ck[f'{n}_grad_at']}), {ck[f'{n}_grad_norm']:.3g} in norm "
                  f"({ck[f'{n}_grad_norm_at']}), weights after Adam {ck[f'{n}_update_lr']:.3g} "
                  f"lr ({ck[f'{n}_update_lr_at']}) where the gradients agree to a tenth, "
                  f"{ck[f'{n}_undetermined']:.2e} of the entries not"
                  for n in ("coarse", "fine"))
              + f" (tol {json.dumps(TT_CHECK_TOL)})", flush=True)
        for k, tol in TT_CHECK_TOL.items():
            if not ck[k] <= tol:
                fail(f"the teacher step on the card differs from the CPU's with {label}: "
                     f"{k} {ck[k]:.3g} (tol {tol})")

    def held_out(pair, c):
        return [render_image(pair[0], pair[1], FRAME_H, FRAME_W, T_FOCAL, pose[:3, :4], c)
                for pose, _ in held]

    before = [_frame_quality(sm, r, gt)
              for r, (_, gt) in zip(held_out(models, eval_f32), held)]

    # the frames on the card: rays and targets of every training frame
    rays = [get_rays(FRAME_H, FRAME_W, T_FOCAL, pose[:3, :4], device=dev) for pose, _ in train]
    all_o = torch.stack([o.reshape(-1, 3) for o, _ in rays])
    all_d = torch.stack([d.reshape(-1, 3) for _, d in rays])
    all_t = torch.stack([torch.as_tensor(rgb.reshape(-1, 3), dtype=torch.float32)
                         for _, rgb in train]).to(dev)
    dH, dW = int(FRAME_H // 2 * TT_PRECROP_FRAC), int(FRAME_W // 2 * TT_PRECROP_FRAC)
    crop = ((torch.arange(FRAME_H // 2 - dH, FRAME_H // 2 + dH, device=dev)[:, None] * FRAME_W
             + torch.arange(FRAME_W // 2 - dW, FRAME_W // 2 + dW, device=dev)).reshape(-1))

    opt = torch.optim.Adam([p for m in models for p in m.parameters()], lr=TT_LRATE,
                           betas=(0.9, 0.999), eps=1e-8)
    step = make_teacher_train_step(models[0], models[1], opt, cfg, schedule=schedule)
    state = init_train_state(torch.nn.ModuleDict({"coarse": models[0], "fine": models[1]}),
                             opt)
    gen = torch.Generator(device=dev).manual_seed(sm.seed)
    rng = np.random.default_rng(sm.seed)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    metrics = []
    t0 = time.perf_counter()
    for i in range(1, TT_STEPS + 1):
        if i == TT_WARMUP + 1:
            start.record()
        f = int(rng.integers(TT_TRAIN_FRAMES))
        # main.py's _select_coords: N_rand pixels without replacement, from
        # the central crop while i < precrop_iters
        pool = crop if i < TT_PRECROP_ITERS else None
        n_pool = FRAME_H * FRAME_W if pool is None else pool.numel()
        sel = torch.randperm(n_pool, generator=gen, device=dev)[:TT_N_RAND]
        if pool is not None:
            sel = pool[sel]
        state, met = step(state, gen, all_o[f, sel], all_d[f, sel], all_t[f, sel])
        metrics.append(met)
    end.record()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    step_ms = start.elapsed_time(end) / (TT_STEPS - TT_WARMUP)
    sm.teacher_step_ms = step_ms
    loss = np.array([m["loss"].item() for m in metrics])
    psnr_curve = np.array([m["psnr"].item() for m in metrics])
    print(f"teacher_train: {TT_STEPS} steps of {TT_N_RAND} rays ({T_SAMPLES} + "
          f"{T_IMPORTANCE} samples, f32, the unfused path under autograd) in {loop_s:.1f} s: "
          f"{step_ms:.3f} ms/step ({TT_N_RAND / step_ms * 1e3:.0f} rays/s) over the steps "
          f"after {TT_WARMUP}; loss and fine PSNR, the mean of each 50 steps: "
          + "; ".join(f"{k + 50}: {loss[k:k + 50].mean():.5f} {psnr_curve[k:k + 50].mean():.2f} dB"
                      for k in range(0, TT_STEPS, 50)), flush=True)
    if not np.isfinite(loss).all():
        fail("a teacher training loss is not finite")
    if not loss[-50:].mean() < loss[:50].mean():
        fail(f"the teacher's loss did not fall: {loss[:50].mean():.5f} over the first 50 "
             f"steps, {loss[-50:].mean():.5f} over the last 50")

    after = [_frame_quality(sm, r, gt) for r, (_, gt) in zip(held_out(models, eval_f32), held)]
    bf = _teacher_pair(torch, dev, torch.bfloat16, like=models)
    ecfg = cfg.eval_mode()
    chunks = -(-FRAME_H * FRAME_W // T_CHUNK)
    torch.cuda.synchronize()
    nerf_forward_fused.launches = 0
    sample_pdf_det_fused.launches = 0
    bf_frames = held_out(bf, ecfg)
    torch.cuda.synchronize()
    launches = (nerf_forward_fused.launches, sample_pdf_det_fused.launches)
    bf_q = [_frame_quality(sm, r, gt) for r, (_, gt) in zip(bf_frames, held)]
    gain = np.mean([a[0] for a in after]) - np.mean([b[0] for b in before])
    print(f"teacher_train: held-out PSNR / SSIM against the sphere frames: untrained f32 "
          + ", ".join(f"{p:.2f} dB / {q:.4f}" for p, q in before)
          + "; trained f32 (unfused) " + ", ".join(f"{p:.2f} dB / {q:.4f}" for p, q in after)
          + "; trained bf16 through the kernels " + ", ".join(f"{p:.2f} dB / {q:.4f}" for p, q in bf_q)
          + f"; gain {gain:.2f} dB (at least {TT_PSNR_GAIN:g}); the bf16 render launched "
          f"nerf_forward_fused {launches[0]} and sample_pdf_det_fused {launches[1]} times over "
          f"{len(held)} frames of {chunks} chunks; {TT_TRAIN_FRAMES + TT_HELD_OUT} frames "
          f"made in {data_s:.1f} s", flush=True)
    if launches != (2 * chunks * len(held), chunks * len(held)):
        fail(f"the trained teacher's bf16 render launched {launches}, expected 2 field-eval "
             f"and 1 sampler launch a chunk")
    if not gain >= TT_PSNR_GAIN:
        fail(f"the trained teacher's held-out PSNR rose by {gain:.2f} dB only")

    # the int8 frame of the trained teacher against its bf16 frame (reported,
    # not gated: the JAX package gates it at INT8_PSNR_MIN on its own trained
    # teacher, tests/test_quality_e2e.py:270)
    cfg8 = dataclasses.replace(cfg, teacher_quant="int8").eval_mode()
    q8 = held_out(bf, cfg8)[0]
    ref = bf_frames[0]
    n_rays = FRAME_H * FRAME_W
    flip = (((q8.acc0 - ref.acc0).abs() > 0.5) | ((q8.acc - ref.acc).abs() > 0.5)).reshape(n_rays)
    d2 = ((q8.rgb - ref.rgb) ** 2).reshape(n_rays, 3)
    psnr_all = -10.0 * math.log10(max(d2.mean().item(), 1e-30))
    psnr_kept = -10.0 * math.log10(max(d2[~flip].mean().item(), 1e-30))
    q8_gt = _frame_quality(sm, q8, held[0][1])
    print(f"teacher_train: the trained teacher's int8 frame against its bf16 frame "
          f"(held-out 0): rays whose coarse or fine acc moves by more than 0.5: share "
          f"{flip.float().mean().item():.2e}; PSNR {psnr_all:.2f} dB over the frame, "
          f"{psnr_kept:.2f} dB over the other rays (the JAX package's gate on its trained "
          f"teacher: {INT8_PSNR_MIN:g} dB over the frame; reported, not gated here); int8 "
          f"against the sphere frame {q8_gt[0]:.2f} dB / {q8_gt[1]:.4f}", flush=True)
    sm.trained = {"bf16": bf, "train": train, "held": held, "bf_frame0": bf_frames[0],
                  "cfg": cfg}


def phase_distill(sm: Smoke) -> None:
    import numpy as np

    from efficient_nerf_tpu_torch.data import (RayShardDataset, ShardLoader,
                                               export_pseudo_shards, native, rays_to_shards)
    from efficient_nerf_tpu_torch.data.convert import _pack_image_rays

    if not hasattr(sm, "trained"):
        fail("distill reads the teacher_train phase's teacher: run both")
    tr = sm.trained
    t0 = time.perf_counter()
    lib = native.build_library()
    print(f"distill: native shard reader {lib} ({time.perf_counter() - t0:.2f} s, from "
          f"{native.RUNTIME_SRC})", flush=True)
    if lib.parent != native.BUILD_DIR or lib.parent.parts[-2:] != ("build", "runtime") \
            or not lib.exists():
        fail(f"the native reader was not built into build/runtime/: {lib}")

    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        export_pseudo_shards(tr["bf16"][0], tr["bf16"][1], tr["cfg"], FRAME_H, FRAME_W,
                             T_FOCAL, out, DISTILL_POSES, seed=sm.seed)
        pseudo_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = np.concatenate([_pack_image_rays(FRAME_H, FRAME_W, T_FOCAL, pose[:3, :4], rgb)
                               for pose, rgb in tr["train"]])
        n_real = rays_to_shards(rows, out, rng=np.random.default_rng(sm.seed))
        real_s = time.perf_counter() - t0
        del rows
        ds = RayShardDataset(out, pseudo_ratio=-1, rng=np.random.default_rng(sm.seed))
        print(f"distill: {ds.n_pseudo} pseudo shards from {DISTILL_POSES} poses "
              f"({pseudo_s:.2f} s), {n_real} train_ shards of the {TT_TRAIN_FRAMES} frames "
              f"({real_s:.2f} s); {len(ds)} shards of [4096, 9]", flush=True)
        if ds.n_original != n_real or ds.n_pseudo != DISTILL_POSES * FRAME_H * FRAME_W // 4096:
            fail(f"the shard directory holds {ds.n_pseudo} pseudo and {ds.n_original} real "
                 f"shards")
        loader = ShardLoader(ds, DISTILL_SHARDS, rng=np.random.default_rng(sm.seed),
                             use_native=True)
        try:
            _distill_steps(sm, ds, loader)
        finally:
            loader.close()


def _distill_steps(sm: Smoke, ds, loader) -> None:
    """The loader's batch against the numpy path's and its times, then the
    student's steps on its batches."""
    import numpy as np

    from efficient_nerf_tpu_torch.data import infinite_indices
    from efficient_nerf_tpu_torch.device import to_device
    from efficient_nerf_tpu_torch.metrics import psnr
    from efficient_nerf_tpu_torch.ops import r2l_train as rt
    from efficient_nerf_tpu_torch.render import r2l_render_image
    from efficient_nerf_tpu_torch.train import (hard_pool_init, init_train_state,
                                                make_lr_schedule, make_r2l_train_step,
                                                parse_warmup)

    torch, dev, tr = sm.torch, sm.dev, sm.trained
    # a batch of the native reader against the numpy path's, same shards
    idxs = [i for i, _ in zip(infinite_indices(len(ds), np.random.default_rng(1)),
                              range(DISTILL_SHARDS))]
    native_batch = loader.load_batch(idxs)
    numpy_batch = ds.split_columns(np.concatenate([ds.load(i) for i in idxs]).astype(np.float32))
    same = all(np.array_equal(a, b) for a, b in zip(native_batch, numpy_batch))
    load_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        loader.load_batch(idxs)
        load_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(3):
        ds.split_columns(np.concatenate([ds.load(i) for i in idxs]).astype(np.float32))
    numpy_ms = (time.perf_counter() - t0) * 1e3 / 3
    n_bytes = sum(a.nbytes for a in native_batch)
    pinned = [torch.from_numpy(a).pin_memory() for a in native_batch]
    h2d_ms = cuda_ms(torch, lambda: [p.to(dev, non_blocking=True) for p in pinned], 10)
    print(f"distill: a batch of {DISTILL_SHARDS} shards ({n_bytes / 1e6:.2f} MB) from the "
          f"native reader equals the numpy path's bit for bit: {same}; the reader "
          f"{np.median(load_ms):.3f} ms a batch (median of 10; numpy path {numpy_ms:.3f} ms): "
          f"{n_bytes / np.median(load_ms) / 1e6:.2f} GB/s, against the host-to-card copy of "
          f"those bytes: {n_bytes / H100_HOST_BYTES * 1e3:.3f} ms at the link's "
          f"{H100_HOST_BYTES / 1e9:g} GB/s, {h2d_ms:.3f} ms measured (pinned)", flush=True)
    if not same:
        fail("the native reader's batch differs from the numpy path's")

    model = r2l_student(sm.student_params(2), dev)
    opt = torch.optim.Adam(model.parameters(), lr=5e-4, betas=(0.9, 0.999), eps=1e-8,
                           fused=True)
    step = make_r2l_train_step(
        model, opt, near=NEAR, far=FAR, n_sample=N_SAMPLE, L=L_FREQ, perturb=True,
        hard=TRAIN_HARD, schedule=make_lr_schedule(5e-4, 500, parse_warmup("0.0001,200")))
    state = init_train_state(model, opt)
    pool = hard_pool_init(TRAIN_POOL)
    gen = torch.Generator(device=dev).manual_seed(sm.seed)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(DISTILL_STEPS)]
    losses, waits, next_ms = [], 0, []
    torch.cuda.synchronize()
    rt.r2l_train_fwd.launches = 0
    rt.r2l_train_bwd_act.launches = 0
    rt.r2l_train_wgrad.launches = 0
    t_loop = time.perf_counter()
    for ev in events:
        waits += loader._q.empty()
        t0 = time.perf_counter()
        o, d, t = next(loader)
        next_ms.append((time.perf_counter() - t0) * 1e3)
        o, d, t = (to_device(x, dev) for x in (o, d, t))
        ev[0].record()
        state, pool, met = step(state, pool, gen, o, d, t)
        ev[1].record()
        losses.append(met["loss_rgb"])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t_loop
    launches = (rt.r2l_train_fwd.launches, rt.r2l_train_bwd_act.launches,
                rt.r2l_train_wgrad.launches)
    losses = [v.item() for v in losses]
    step_ms = [a.elapsed_time(b) for a, b in events]
    n_rays = TRAIN_BATCH + TRAIN_HARD[1]
    pose, _ = tr["held"][0]
    with torch.no_grad():
        student = r2l_render_image(model, pose[:3, :4], FRAME_H, FRAME_W, T_FOCAL,
                                        NEAR, FAR, N_SAMPLE, L_FREQ)
    s_psnr = psnr(student.float(), tr["bf_frame0"].rgb).item()
    print(f"distill: {DISTILL_STEPS} steps of {n_rays} rays ({TRAIN_BATCH} from the loader + "
          f"{TRAIN_HARD[1]} hard) in {loop_s:.2f} s: step {np.median(step_ms[2:]):.3f} ms "
          f"(median after 2; CUDA events around the step); next(loader) {np.median(next_ms):.3f} "
          f"ms median, {max(next_ms):.3f} max, the queue empty before {waits} of "
          f"{DISTILL_STEPS} steps; launches r2l_train_fwd {launches[0]}, r2l_train_bwd_act "
          f"{launches[1]}, r2l_train_wgrad {launches[2]}; loss_rgb "
          + " ".join(f"{v:.5f}" for v in losses)
          + f"; the student's held-out frame against the teacher's bf16 frame {s_psnr:.2f} dB",
          flush=True)
    if launches != (DISTILL_STEPS,) * 3:
        fail(f"expected one launch of each training kernel a step, counted {launches}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"the student's loss did not fall: {losses[0]:.5f} -> {losses[-1]:.5f}")


# The driver phase: the README pipeline through the port's own CLI
# (efficient_nerf_tpu_torch.main / create_data), in process. The scene is a
# 400x400 sphere scene written by data.synthetic.make_synthetic_scene (20
# training, 2 validation and 2 test frames; the card's machine has no cv2,
# so --half_res False at the half-res lego's own size). The teacher runs
# the lego config (lego.txt: viewdirs, which the teacher kernels need); the
# students the README's lego_noview.txt.
DRV_TEACHER_STEPS = 1000
DRV_POSES, DRV_INT8_POSES, DRV_PATCH_POSES = 8, 2, 2
DRV_STUDENT_STEPS, DRV_PATCH_STEPS = 30, 10
DRV_PSNR_GAIN = 3.0        # dB over the untrained teacher (PR 12's gate)
# the README student command (README.md:88-91) at the flagship's widths and
# distill_shards' batch
DRV_WIDTHS = ["--netdepth", str(R2L["depth"]), "--netwidth", str(R2L["width"]),
              "--n_sample_per_ray", str(R2L["n_sample"])]
DRV_STUDENT = ["--model_name", "R2L", "--data_mode", "rays", *DRV_WIDTHS, "--use_residual",
               "--N_rand", str(DISTILL["shards_per_batch"]),
               "--hard_ratio", str(DISTILL["hard_ratio"]),
               "--warmup_lr", ",".join(map(str, R2L["train"]["warmup_lr"]))]
DRV_FLAGSHIP = ["--trial.ON", "--trial.body_arch", "resmlp", "--compute_dtype", "bf16"]
# the conv student on 16x16 patches: the command's widths, 3x3 convs, 4
# shards (64 patches of 256 rays) a step
DRV_PATCHES = ["--model_name", "R2L", "--data_mode", "patches", *DRV_WIDTHS,
               "--body_arch", "resblock", "--use_bn", "--kernel_size", "3", "--N_rand", "4"]


def _drv_run(sm: Smoke, label: str, fn, argv, log: list):
    """fn(argv) in process with the kernels' launch counters set to 0 just
    before and read just after, its output captured; returns (result,
    {kernel: launches}, captured text). Prints the wall time and the
    launches."""
    import contextlib
    import io

    sm.torch.cuda.synchronize()
    for f in _kernel_fns():
        f.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn(argv)
        sm.torch.cuda.synchronize()
    except Exception as e:
        print(buf.getvalue()[-4000:], flush=True)
        fail(f"driver: {label} raised {type(e).__name__}: {e}")
    wall = time.perf_counter() - t0
    launches = _kernel_launches()
    text = buf.getvalue()
    keep = [ln for ln in text.splitlines()
            if re.search(r"\[(TRAIN|TEST|BENCH|TEST TEACHER)\]|Exported|Wrote|Appended", ln)]
    print(f"driver: {label}: {wall:.1f} s; launches "
          + (", ".join(f"{k} {v}" for k, v in launches.items() if v) or "none")
          + "".join(f"\n  {ln}" for ln in keep[-8:]), flush=True)
    log.append({"command": label, "seconds": round(wall, 1),
                "launches": {k: v for k, v in launches.items() if v}})
    return out, launches, text


def _drv_step_ms(text: str):
    """The driver's ms a step from its [TRAIN] lines: (steps, ms) of each
    interval between two metric reads."""
    rows, last = [], 1        # the clock's first mark is step 1's read
    for m in re.finditer(r"\[TRAIN\] Iter (\d+) .*ms/step (\S+)", text):
        i = int(m.group(1))
        if m.group(2) != "None":
            rows.append((f"{last + 1}-{i}", float(m.group(2))))
        last = i
    return rows


def _drv_test(text: str):
    m = re.findall(r"\[TEST\] Iter \d+ TestPSNR (\S+) .*TestSSIM (\S+)", text)
    return (float(m[-1][0]), float(m[-1][1])) if m else None


def _reference_tar(torch, src: str, dst: str, module: str) -> None:
    """Re-save the resmlp student of the port checkpoint `src` in the
    reference's R2L layout (main.py:1516-1542): global_step, the state_dict
    and the optimizer's beside the whole module pickled under network_fn.
    Its classes belong to `module`, which is in sys.modules only while
    saving, as the reference's own classes are to a reader of its files."""
    import sys
    import types

    from efficient_nerf_tpu_torch.train import load_checkpoint

    nn = torch.nn

    class ResBlock(nn.Module):
        def __init__(self, w):
            super().__init__()
            self.body = nn.Sequential(nn.Linear(w, w), nn.ReLU(), nn.Linear(w, w))

    class NeRF_v3_2(nn.Module):
        def __init__(self, in_dim, w, n_block):
            super().__init__()
            self.head = nn.Sequential(nn.Linear(in_dim, w), nn.ReLU())
            self.body = nn.Sequential(*[ResBlock(w) for _ in range(n_block)])
            self.tail = nn.Sequential(nn.Linear(w, 3), nn.Sigmoid())

    fake = types.ModuleType(module)
    for cls in (ResBlock, NeRF_v3_2):
        cls.__module__, cls.__qualname__ = module, cls.__name__
        setattr(fake, cls.__name__, cls)
    ckpt = load_checkpoint(src)
    sd = ckpt["network_fn_state_dict"]
    n_block = sum(1 for k in sd if k.endswith(".body.0.weight"))
    net = NeRF_v3_2(sd["head.0.weight"].shape[1], sd["head.0.weight"].shape[0], n_block)
    net.load_state_dict(sd)
    sys.modules[module] = fake
    try:
        torch.save({"global_step": ckpt["global_step"], "network_fn_state_dict": net.state_dict(),
                    "network_fn": net, "optimizer_state_dict": ckpt["optimizer_state_dict"]},
                   dst)
    finally:
        del sys.modules[module]


def phase_driver(sm: Smoke) -> None:
    import glob
    import os
    import sys

    from efficient_nerf_tpu_torch import create_data, main
    from efficient_nerf_tpu_torch.config.options import SCENES_DIR
    from efficient_nerf_tpu_torch.data.synthetic import make_synthetic_scene

    torch = sm.torch
    torch.cuda.empty_cache()
    log = []
    lego = ["--config", os.path.join(SCENES_DIR, "lego.txt")]
    noview = ["--config", os.path.join(SCENES_DIR, "lego_noview.txt")]
    with tempfile.TemporaryDirectory() as tmp:
        scene = os.path.join(tmp, "scene")
        t0 = time.perf_counter()
        make_synthetic_scene(scene, n_train=20, n_val=2, n_test=2, H=FRAME_H, W=FRAME_W,
                             seed=sm.seed)
        print(f"driver: 400x400 sphere scene (20 train, 2 val, 2 test PNGs) written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

        def flags(name, *extra):
            return ["--datadir", scene, "--half_res", "False", "--testskip", "1",
                    "--basedir", os.path.join(tmp, "logs"), "--expname", name,
                    "--i_video", "1000000", *extra]

        def weights(name, file="ckpt.tar"):
            found = glob.glob(os.path.join(tmp, "logs", "Experiments", f"{name}_*",
                                           "weights", file))
            if len(found) != 1:
                fail(f"driver: {name} wrote no {file}: {found}")
            return found[0]

        # ---- 1. the teacher: untrained test frames, then 1000 steps
        untrained, _, _ = _drv_run(sm, "teacher --render_only --render_test (untrained)",
                                   main.main, lego + flags("teacher0", "--model_name", "nerf",
                                                           "--render_only", "--render_test"),
                                   log)
        _, tl, text = _drv_run(
            sm, f"teacher: main --config lego.txt --model_name nerf ({DRV_TEACHER_STEPS} steps)",
            main.main, lego + flags("teacher", "--model_name", "nerf",
                                    "--N_iters", str(DRV_TEACHER_STEPS), "--i_print", "100",
                                    "--i_testset", str(DRV_TEACHER_STEPS),
                                    "--i_weights", str(DRV_TEACHER_STEPS)), log)
        teacher = weights("teacher")
        trained = _drv_test(text)
        t_steps = _drv_step_ms(text)
        gain = trained[0] - untrained["test_psnr"]
        print(f"driver: the teacher's test frames: untrained PSNR {untrained['test_psnr']:.2f} "
              f"dB / SSIM {untrained['test_ssim']:.4f}, after {DRV_TEACHER_STEPS} steps "
              f"{trained[0]:.2f} dB / {trained[1]:.4f}; gain {gain:.2f} dB (at least "
              f"{DRV_PSNR_GAIN:g}); ms/step " + ", ".join(f"{k} {v:.3f}" for k, v in t_steps)
              + "; the teacher_train phase's step: "
              + (f"{sm.teacher_step_ms:.3f} ms" if hasattr(sm, "teacher_step_ms") else "not run"),
              flush=True)
        if not gain >= DRV_PSNR_GAIN:
            fail(f"driver: the teacher's test PSNR rose by {gain:.2f} dB only")
        if not (tl["nerf_forward_fused"] and tl["sample_pdf_det_fused"]):
            fail(f"driver: the teacher's test renders launched no field-eval or sampler "
                 f"kernel: {tl}")

        # ---- 2. the shards: bf16 (and --test_teacher), then int8
        kd, kd8, kdp = (os.path.join(tmp, d) for d in ("kd", "kd8", "kdp"))
        n, _, _ = _drv_run(sm, f"create_data rand --n_pose_kd {DRV_POSES} --test_teacher",
                           create_data.main,
                           lego + flags("cd", "--model_name", "nerf", "--teacher_ckpt", teacher,
                                        "--create_data", "rand", "--datadir_kd",
                                        f"blender:{kd}", "--n_pose_kd", str(DRV_POSES),
                                        "--test_teacher"), log)
        n8, l8, _ = _drv_run(sm, f"create_data rand --n_pose_kd {DRV_INT8_POSES} "
                             "--teacher_quant int8", create_data.main,
                             lego + flags("cd8", "--model_name", "nerf", "--teacher_ckpt",
                                          teacher, "--create_data", "rand", "--datadir_kd",
                                          f"blender:{kd8}", "--n_pose_kd", str(DRV_INT8_POSES),
                                          "--teacher_quant", "int8"), log)
        if n != DRV_POSES * FRAME_H * FRAME_W // 4096 or n8 < 1:
            fail(f"driver: create_data wrote {n} and {n8} shards")
        if not l8["nerf_forward_int8"]:
            fail(f"driver: --teacher_quant int8 launched nerf_forward_int8 no time: {l8}")

        # ---- 3. the README student command (mlp body, f32)
        every = ["--N_iters", str(DRV_STUDENT_STEPS), "--i_print", "10",
                 "--i_testset", str(DRV_STUDENT_STEPS), "--i_weights", str(DRV_STUDENT_STEPS)]
        _, _, text = _drv_run(sm, f"README student command (mlp, f32, {DRV_STUDENT_STEPS} steps)",
                              main.main, noview + flags("mlp", *DRV_STUDENT, "--datadir_kd",
                                                        f"blender:{kd}", *every), log)
        mlp_ms, mlp_test = _drv_step_ms(text), _drv_test(text)
        direct = getattr(sm, "mlp_steps_ms", {}).get("float32")
        print(f"driver: the README command's ms/step " + ", ".join(
            f"{k} {v:.3f}" for k, v in mlp_ms) + "; the train_mlp phase's f32 step: "
            + (f"{direct:.3f} ms" if direct else "not run") + f"; test PSNR / SSIM "
            f"{mlp_test[0]:.2f} dB / {mlp_test[1]:.4f}", flush=True)

        # ---- 4. the flagship: resmlp, bf16, through kernels 3a and 3b
        _, fl, text = _drv_run(sm, f"flagship student (resmlp, bf16, {DRV_STUDENT_STEPS} steps)",
                               main.main, noview + flags("flag", *DRV_STUDENT, *DRV_FLAGSHIP,
                                                         "--datadir_kd", f"blender:{kd}",
                                                         *every), log)
        flag_ms, flag_test = _drv_step_ms(text), _drv_test(text)
        print(f"driver: the flagship's ms/step " + ", ".join(
            f"{k} {v:.3f}" for k, v in flag_ms)
            + f"; test PSNR / SSIM {flag_test[0]:.2f} dB / {flag_test[1]:.4f}", flush=True)
        per_step = (fl["r2l_train_fwd"], fl["r2l_train_bwd_act"], fl["r2l_train_wgrad"])
        if per_step != (DRV_STUDENT_STEPS,) * 3:
            fail(f"driver: the flagship launched r2l_train_fwd / bwd_act / wgrad {per_step} "
                 f"times in {DRV_STUDENT_STEPS} steps, expected once a step each")
        ckpt = ["--pretrained_ckpt", weights("flag")]
        flag_args = noview + DRV_STUDENT + DRV_FLAGSHIP + ckpt
        rt, rl, _ = _drv_run(sm, "flagship --render_only --render_test", main.main,
                             flags("flag_rt", *flag_args, "--render_only", "--render_test"), log)
        bench = {}
        for label, extra in (("bf16", []), ("int8", ["--inference_quant", "int8"]),
                             ("no_pallas", ["--no_pallas"])):
            dt, bl, _ = _drv_run(sm, f"flagship --benchmark {' '.join(extra)}".strip(),
                                 main.main, flags(f"bench_{label}", *flag_args, "--benchmark",
                                                  *extra), log)
            bench[label] = (dt * 1e3, bl)
        path, _, _ = _drv_run(sm, "flagship --convert_to_onnx", main.main,
                              flags("export", *flag_args, "--convert_to_onnx"), log)
        if not rl["r2l_forward_fused"] or not bench["bf16"][1]["r2l_forward_fused"]:
            fail(f"driver: --render_only / --benchmark launched r2l_forward_fused no time: "
                 f"{rl}, {bench['bf16'][1]}")
        if not bench["int8"][1]["r2l_forward_int8"]:
            fail(f"driver: --inference_quant int8 launched r2l_forward_int8 no time: "
                 f"{bench['int8'][1]}")
        if any(bench["no_pallas"][1].values()):
            fail(f"driver: --no_pallas launched a kernel: {bench['no_pallas'][1]}")
        int8_ms = getattr(sm, "int8_frame_ms", None)
        print(f"driver: --benchmark frame {bench['bf16'][0]:.3f} ms, int8 "
              f"{bench['int8'][0]:.3f} ms (main_int8's "
              + (f"{int8_ms:.3f}" if int8_ms else "not run") + f"), --no_pallas "
              f"{bench['no_pallas'][0]:.3f} ms; --render_only --render_test PSNR / SSIM "
              f"{rt['test_psnr']:.2f} dB / {rt['test_ssim']:.4f}; export verified at {path}",
              flush=True)

        # ---- 4b. the flagship from a reference-layout .tar (pickled module)
        from efficient_nerf_tpu_torch.train import load_checkpoint

        ref_tar, stub_module = os.path.join(tmp, "reference.tar"), "reference_r2l_models"
        _reference_tar(torch, weights("flag"), ref_tar, stub_module)
        read_ms = {}
        for label, file in (("ckpt.tar", weights("flag")), ("reference .tar", ref_tar)):
            t0 = time.perf_counter()
            load_checkpoint(file)
            read_ms[label] = (time.perf_counter() - t0) * 1e3
        ref_args = noview + DRV_STUDENT + DRV_FLAGSHIP + ["--pretrained_ckpt", ref_tar]
        rrt, rrl, _ = _drv_run(sm, "flagship --render_only --render_test (reference .tar)",
                               main.main, flags("ref_rt", *ref_args, "--render_only",
                                                "--render_test"), log)
        rdt, rbl, _ = _drv_run(sm, "flagship --benchmark --inference_quant int8 (reference .tar)",
                               main.main, flags("ref_bench", *ref_args, "--benchmark",
                                                "--inference_quant", "int8"), log)
        if not rrl["r2l_forward_fused"]:
            fail(f"driver: the reference .tar's render launched r2l_forward_fused no time: {rrl}")
        if not rbl["r2l_forward_int8"]:
            fail(f"driver: the reference .tar's int8 benchmark launched r2l_forward_int8 no "
                 f"time: {rbl}")
        if (rrt["test_psnr"], rrt["test_ssim"]) != (rt["test_psnr"], rt["test_ssim"]):
            fail(f"driver: the reference .tar renders PSNR / SSIM {rrt['test_psnr']!r} / "
                 f"{rrt['test_ssim']!r}, the plain checkpoint {rt['test_psnr']!r} / "
                 f"{rt['test_ssim']!r}")
        if stub_module in sys.modules:
            fail(f"driver: reading the reference .tar imported {stub_module}")
        print(f"driver: reference .tar ({os.path.getsize(ref_tar) / 2**20:.1f} MiB, module "
              f"pickled under network_fn) read in {read_ms['reference .tar']:.1f} ms (ckpt.tar "
              f"{read_ms['ckpt.tar']:.1f} ms); --render_only --render_test PSNR / SSIM "
              f"{rrt['test_psnr']:.4f} dB / {rrt['test_ssim']:.4f}, equal to ckpt.tar's; "
              f"--benchmark --inference_quant int8 {rdt * 1e3:.3f} ms a frame (from ckpt.tar "
              f"{bench['int8'][0]:.3f}); {stub_module} not imported; {sm.gpu}", flush=True)

        # ---- 5. the patch modes and the conv student
        n16, _, _ = _drv_run(sm, f"create_data 16x16patches --n_pose_kd {DRV_PATCH_POSES}",
                             create_data.main,
                             lego + flags("cdp", "--model_name", "nerf", "--teacher_ckpt",
                                          teacher, "--create_data", "16x16patches",
                                          "--datadir_kd", f"blender:{kdp}", "--n_pose_kd",
                                          str(DRV_PATCH_POSES)), log)
        _, _, text = _drv_run(sm, f"conv student (resblock, BN, {DRV_PATCH_STEPS} steps)",
                              main.main, noview + flags("conv", *DRV_PATCHES, "--datadir_kd",
                                                        f"blender:{kdp}", "--N_iters",
                                                        str(DRV_PATCH_STEPS), "--i_print", "5",
                                                        "--i_testset", "1000000",
                                                        "--i_weights", str(DRV_PATCH_STEPS)),
                              log)
        conv_ms = _drv_step_ms(text)
        crt, cl, _ = _drv_run(sm, "conv student --render_only --render_test", main.main,
                              flags("conv_rt", *noview, *DRV_PATCHES, "--pretrained_ckpt",
                                    weights("conv"), "--render_only", "--render_test"), log)
        if any(cl.values()):
            fail(f"driver: the conv student's render launched a kernel: {cl}")
        print(f"driver: {n16} patch shards; the conv student's ms/step "
              + ", ".join(f"{k} {v:.3f}" for k, v in conv_ms)
              + f"; its test PSNR / SSIM {crt['test_psnr']:.2f} dB / {crt['test_ssim']:.4f}",
              flush=True)
    print("driver: commands " + json.dumps(log), flush=True)


# ---- the parallel phase: parallel/ over torch.distributed on the one card.
# (a) a one-rank NCCL group runs the flagship's sharded step at the README
# command's sizes against the direct step; (b) two gloo ranks, both on
# cuda:0 (NCCL refuses two ranks on one card), run dryrun_multichip's four
# stages (__graft_entry__.py:49-170) against their single-process
# counterparts. Gloo stages CUDA tensors through the host, so (b) checks
# agreement and reports its wall time only.
PAR_TP_ROWS = 4096                   # model x 2: the unfused f32 flagship
PAR_TEACHER_HWF = (16, 16, 20.0)     # dryrun stage 4: NDC, view dirs, a 16x16 frame
PAR_RANK_TIMEOUT = 420               # seconds for the gloo group's four stages
# Sharded against single steps. The loss and the pool: each row's loss is
# that row's arithmetic, the same on both sides, and only the sum over rows
# changes its order (f32 over 98,304 rows: ~1e-7). The fused step's
# gradients: pass 2 sums each rank's 49,152 rows in f32 and the all_reduce
# adds the two sums; the bf16 operands are the same, so they differ by the
# f32 summation order, expected ~1e-6 of a tensor's norm; 1e-3 is what a
# reordering of bf16 tile sums would reach. The tensor-parallel f32 step
# splits each block's second product and the teacher's step sums two
# halves: f32 orders, 1e-4 of a tensor's norm.
PAR_LOSS_RTOL = 1e-5
PAR_GRAD_TOL = {"fused": 1e-3, "f32": 1e-4}
PAR_TEACHER_CFG = dict(n_samples=8, n_importance=4, perturb=True, use_viewdirs=True,
                       ndc=True, near=0.0, far=1.0)
PAR_KERNELS = ("r2l_forward_fused", "r2l_forward_int8", "r2l_train_fwd", "r2l_train_bwd",
               "r2l_train_wgrad")


def _par_step(model, dev, mesh=None, **kw):
    """The flagship's step (fused Adam, the README's warmup schedule),
    sharded over `mesh` or direct; returns (state, step)."""
    import torch

    from efficient_nerf_tpu_torch.parallel import make_sharded_r2l_train_step
    from efficient_nerf_tpu_torch.train import (init_train_state, make_lr_schedule,
                                                make_r2l_train_step, parse_warmup)

    opt = torch.optim.Adam(model.parameters(), lr=5e-4, betas=(0.9, 0.999), eps=1e-8,
                           fused=True)
    kw = dict(near=NEAR, far=FAR, n_sample=N_SAMPLE, L=L_FREQ, perturb=True,
              schedule=make_lr_schedule(5e-4, 500, parse_warmup("0.0001,200")), **kw)
    step = (make_r2l_train_step(model, opt, device=dev, **kw)
            if mesh is None else make_sharded_r2l_train_step(model, opt, mesh, **kw))
    return init_train_state(model, opt), step


def _par_teacher(spec, dev, mesh=None):
    """Dryrun stage 4's teacher pair (f32) and its step; returns (models,
    state, step)."""
    import torch

    from efficient_nerf_tpu_torch.models import NeRFMLP
    from efficient_nerf_tpu_torch.parallel import make_sharded_teacher_train_step
    from efficient_nerf_tpu_torch.render import RenderConfig
    from efficient_nerf_tpu_torch.train import init_train_state, make_teacher_train_step

    models = {}
    for k, sd in spec["teacher"].items():
        models[k] = NeRFMLP(depth=2, width=32)
        models[k].load_state_dict(sd)
        models[k].to(dev)
    opt = torch.optim.Adam([p for m in models.values() for p in m.parameters()],
                           lr=5e-4, betas=(0.9, 0.999), eps=1e-8)
    cfg = RenderConfig(**PAR_TEACHER_CFG)
    step = (make_teacher_train_step(models["coarse"], models["fine"], opt, cfg,
                                    hwf=PAR_TEACHER_HWF, device=dev) if mesh is None
            else make_sharded_teacher_train_step(models["coarse"], models["fine"], opt,
                                                 mesh, cfg, hwf=PAR_TEACHER_HWF))
    return models, init_train_state(torch.nn.ModuleDict(models), opt), step


def _named_grads(named):
    return {k: p.grad.detach().float().clone() for k, p in named}


def _grad_gap(got, want):
    """max over tensors of ||got - want|| / ||want||, and where."""
    gaps = {k: ((got[k].float() - w).norm() / w.norm().clamp_min(1e-30)).item()
            for k, w in want.items()}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def _par_launches():
    """The launch counters of the kernels on the parallel path."""
    from efficient_nerf_tpu_torch.ops import r2l_forward, r2l_int8, r2l_train

    return dict(zip(PAR_KERNELS, (
        r2l_forward.r2l_forward_fused.launches, r2l_int8.r2l_forward_int8.launches,
        r2l_train.r2l_train_fwd.launches, r2l_train.r2l_train_bwd_act.launches,
        r2l_train.r2l_train_wgrad.launches)))


def _par_run(torch, fn):
    """fn() with every launch counter set to 0 just before and read just
    after; returns (result, wall seconds, launches)."""
    torch.cuda.synchronize()
    for f in _kernel_fns():
        f.launches = 0
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, _par_launches()


def _par_rank(rank: int, world: int, tmp: str) -> None:
    """One gloo rank on the spec's device (cuda:0), in a process of its own:
    the four stages on this rank's rows; what they return goes to
    out_<rank>.pt in tmp."""
    import os

    import torch

    from efficient_nerf_tpu_torch import parallel as par
    from efficient_nerf_tpu_torch.parallel.mesh import gather_tp
    from efficient_nerf_tpu_torch.train import hard_pool_init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = torch.load(os.path.join(tmp, "spec.pt"), weights_only=False)
    dev = torch.device(spec["device"])
    par.initialize_distributed(init_method="file://" + os.path.join(tmp, "store"),
                               world_size=world, rank=rank, backend="gloo", device=dev)
    out = {}
    dp = par.make_mesh(n_data=world, device=dev)

    # 1. data x 2: the flagship's fused step, TRAIN_BATCH / 2 rows a rank
    model = r2l_student(spec["sd"], dev)
    state, step = _par_step(model, dev, dp, hard=TRAIN_HARD)
    state, pool = par.replicate_state(dp, state, hard_pool_init(TRAIN_POOL, device=dev))
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    batch = par.shard_batch(dp, *spec["batch"])
    (state, pool, m), wall, launches = _par_run(torch, lambda: step(state, pool, gen, *batch))
    out["dp"] = {"loss": m["loss_rgb"].item(), "grads": _named_grads(model.named_parameters()),
                 "pool": pool.rays.cpu(), "count": pool.count, "rows": batch[0].shape[0],
                 "seconds": wall, "launches": launches}
    del model, state, step, pool

    # 2. model x 2: the f32 flagship's tensor-parallel step, unfused
    tp = par.make_mesh(n_data=1, n_model=world, device=dev)
    model = par.shard_params_tp(tp, r2l_student(spec["sd"], dev, dtype="float32"))
    state, step = _par_step(model, dev, tp)
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    rows = par.shard_batch(tp, *(a[:PAR_TP_ROWS] for a in spec["batch"]))
    (state, _, m), wall, launches = _par_run(torch, lambda: step(state, None, gen, *rows))
    out["tp"] = {"loss": m["loss_rgb"].item(), "seconds": wall, "launches": launches,
                 "grads": gather_tp(tp, {k: p.grad for k, p in model.named_parameters()}),
                 "width": model.head[0].weight.shape[0]}
    del model, state, step

    # 3. sharded serving of a 400x400 frame, bf16 (kernel 1) and int8 (kernel 4)
    model = r2l_student(spec["sd"], dev).eval()  # as the main phase serves
    fo, fd = par.shard_batch(dp, *spec["frame"])
    for quant in ("", "int8"):
        fn = par.make_sharded_r2l_forward(model, dp, near=NEAR, far=FAR, n_sample=N_SAMPLE,
                                          L=L_FREQ, quant=quant,
                                          act_scales=spec["scales"].to(dev) if quant else None)
        fn(fo, fd)                                                  # warm-up
        local, wall, launches = _par_run(torch, lambda: fn(fo, fd))
        out[f"serve{quant}"] = {"rgb": par.gather_batch(dp, local).cpu(), "seconds": wall,
                                "launches": launches, "rows": local.shape[0]}

    # 4. dryrun stage 4: the NDC teacher's step sharded over 'data'
    models, state, step = _par_teacher(spec, dev, dp)
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    tb = par.shard_batch(dp, *spec["teacher_batch"])
    (state, m), wall, launches = _par_run(torch, lambda: step(state, gen, *tb))
    out["teacher"] = {"loss": m["loss"].item(), "seconds": wall, "launches": launches,
                      "grads": _named_grads((f"{k}.{n}", p) for k, mm in models.items()
                                            for n, p in mm.named_parameters())}
    torch.distributed.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))


def _par_spawn(torch, tmp: str, world: int = 2):
    """Runs _par_rank in `world` spawned processes; a rank that raises or a
    group that outlasts PAR_RANK_TIMEOUT fails the run. Returns each rank's
    results and the wall seconds."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.start_processes(_par_rank, args=(world, tmp), nprocs=world, join=False,
                             start_method="spawn")
    try:
        while not ctx.join(timeout=max(1.0, PAR_RANK_TIMEOUT - (time.perf_counter() - t0))):
            if time.perf_counter() - t0 > PAR_RANK_TIMEOUT:
                fail(f"parallel: the gloo ranks ran past {PAR_RANK_TIMEOUT} s")
    except mp.ProcessRaisedException as e:
        fail(f"parallel: a gloo rank raised:\n{e}")
    except mp.ProcessExitedException as e:
        fail(f"parallel: a gloo rank died: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(30)
    wall = time.perf_counter() - t0
    return [torch.load(f"{tmp}/out_{r}.pt", weights_only=False) for r in range(world)], wall


def phase_parallel(sm: Smoke) -> None:
    import os

    import torch.distributed as dist

    from efficient_nerf_tpu_torch import parallel as par
    from efficient_nerf_tpu_torch.core.rays import get_rays
    from efficient_nerf_tpu_torch.models import NeRFMLP
    from efficient_nerf_tpu_torch.ops import _build
    from efficient_nerf_tpu_torch.parallel.mesh import all_reduce_bucket
    from efficient_nerf_tpu_torch.render import calibrate_serving_scales, r2l_forward_rays
    from efficient_nerf_tpu_torch.train import hard_pool_init

    torch, dev = sm.torch, sm.dev
    _build.build_all()                # the ranks load what is built, never build
    torch.cuda.empty_cache()
    # the README command's batch: random rays of 4 frames, targets from a
    # second R2L of another seed through the served path
    rays = [get_rays(FRAME_H, FRAME_W, FOCAL, orbit(t)[:3, :4], device=dev)
            for t in (-180.0, -90.0, 0.0, 90.0)]
    all_o = torch.cat([o.reshape(-1, 3) for o, _ in rays])
    all_d = torch.cat([d.reshape(-1, 3) for _, d in rays])
    # the phase's own generator, so that its figures repeat whichever
    # phases ran before it
    pgen = torch.Generator(device=dev).manual_seed(sm.seed)
    pick = torch.randint(0, all_o.shape[0], (TRAIN_BATCH,), generator=pgen, device=dev)
    target = r2l_forward_rays(r2l_student(sm.student_params(1), dev, dtype="float32",
                                          use_residual=False).eval(),
                              all_o[pick], all_d[pick], NEAR, FAR, N_SAMPLE, L_FREQ, device=dev)
    batch = (all_o[pick].contiguous(), all_d[pick].contiguous(), target.contiguous())
    fo, fd = _frame_rays(sm, 0)
    serve = r2l_student(sm.params, dev).eval()
    scales = calibrate_serving_scales(serve, fo[:INT8_CAL], fd[:INT8_CAL], NEAR, FAR,
                                      N_SAMPLE, L_FREQ, device=dev)
    torch.manual_seed(sm.seed)
    teacher = {k: NeRFMLP(depth=2, width=32).state_dict() for k in ("coarse", "fine")}
    to, td = get_rays(*PAR_TEACHER_HWF, torch.cat([torch.eye(3), torch.tensor(
        [[0.1], [0.2], [0.3]])], 1), device=dev)
    to, td = to.reshape(-1, 3), td.reshape(-1, 3)
    tt = torch.rand(to.shape, generator=pgen, device=dev)
    spec = {"device": str(dev), "seed": sm.seed + 7, "scales": scales.cpu(), "teacher": teacher,
            "sd": {k: v.cpu() for k, v in sm.params.items()},
            "batch": tuple(a.cpu() for a in batch), "frame": (fo.cpu(), fd.cpu()),
            "teacher_batch": (to.cpu(), td.cpu(), tt.cpu())}

    # ---- (a) one NCCL rank: the sharded flagship step against the direct
    # step, the same weights, batch and generator seed
    with tempfile.TemporaryDirectory() as tmp:
        par.initialize_distributed(init_method="file://" + os.path.join(tmp, "store"),
                                   world_size=1, rank=0, device=dev)
        try:
            mesh = par.make_mesh(n_data=1, device=dev)
            runs = {}
            for label, m in (("direct", None), ("sharded", mesh)):
                model = r2l_student(sm.params, dev)
                state, step = _par_step(model, dev, m, hard=TRAIN_HARD)
                pool = hard_pool_init(TRAIN_POOL, device=dev)
                gen = torch.Generator(device=dev).manual_seed(spec["seed"])
                (state, pool, met), wall, launches = _par_run(
                    torch, lambda: step(state, pool, gen, *batch))
                runs[label] = {"loss": met["loss_rgb"].item(), "pool": pool.rays.clone(),
                               "grads": _named_grads(model.named_parameters()),
                               "weights": {k: v.clone() for k, v in model.state_dict().items()},
                               "launches": launches, "step": (state, pool, gen, step)}
            d_run, s_run = runs["direct"], runs["sharded"]
            gap, gap_at = _grad_gap(s_run["grads"], d_run["grads"])
            same = (d_run["loss"] == s_run["loss"] and torch.equal(d_run["pool"], s_run["pool"])
                    and all(torch.equal(v, s_run["weights"][k])
                            for k, v in d_run["weights"].items()))
            # times in turns: direct, sharded, sharded, direct
            ms = {"direct": [], "sharded": []}
            for label in ("direct", "sharded", "sharded", "direct"):
                st, pl, gn, fn = runs[label]["step"]
                ms[label].append(cuda_ms(torch, lambda: fn(st, pl, gn, *batch), 5, warmup=1))
            rows = torch.cat(batch, -1)
            grads = list(d_run["grads"].values())
            mse = torch.rand(TRAIN_BATCH + TRAIN_HARD[1], device=dev)
            coll = {"gather the batch": cuda_ms(torch, lambda: par.gather_batch(mesh, rows), 20),
                    "all_reduce the bucket": cuda_ms(
                        torch, lambda: all_reduce_bucket(mesh, grads), 20),
                    "gather per_ray_mse": cuda_ms(torch, lambda: par.gather_batch(mesh, mse), 20)}
            flat = torch.cat([g.reshape(-1) for g in grads])
            cat_ms = cuda_ms(torch, lambda: torch.cat([g.reshape(-1) for g in grads]), 20)
            nccl_ms = cuda_ms(torch, lambda: dist.all_reduce(flat, group=mesh.group("data")), 20)
        finally:
            dist.destroy_process_group()
    step_ms = {k: sum(v) / len(v) for k, v in ms.items()}
    n_bucket = sum(g.numel() for g in grads) + 2
    print(f"parallel (a): one NCCL rank, make_mesh(n_data=1), the flagship's sharded step "
          f"at {TRAIN_BATCH} + {TRAIN_HARD[1]} rows, pool {TRAIN_POOL}, against the direct "
          f"step from the same weights, batch and seed: loss {s_run['loss']:.7f} vs "
          f"{d_run['loss']:.7f}, gradients {gap:.3g} in norm ({gap_at}), pool rows equal "
          f"{torch.equal(d_run['pool'], s_run['pool'])}, bit for bit {same}; launches "
          f"sharded {s_run['launches']}, direct {d_run['launches']}", flush=True)
    print(f"parallel (a): ms a step (CUDA events, 5 steps, in turns direct, sharded, "
          f"sharded, direct): direct {ms['direct']}, sharded {ms['sharded']}; means "
          f"{step_ms['direct']:.3f} and {step_ms['sharded']:.3f} ms; the collectives alone: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in coll.items())
          + f" (bucket {n_bucket} floats, {4 * n_bucket / 1e6:.1f} MB: its torch.cat "
          f"{cat_ms:.3f} ms, the NCCL all_reduce alone {nccl_ms:.3f} ms): "
          f"{100 * sum(coll.values()) / step_ms['sharded']:.2f}% of the sharded step "
          f"({sm.gpu})", flush=True)
    if not abs(s_run["loss"] - d_run["loss"]) <= PAR_LOSS_RTOL * abs(d_run["loss"]):
        fail(f"parallel (a): the sharded loss {s_run['loss']} differs from the direct "
             f"{d_run['loss']}")
    if not gap <= PAR_GRAD_TOL["fused"] or not torch.equal(d_run["pool"], s_run["pool"]):
        fail(f"parallel (a): the sharded step's gradients differ by {gap:.3g} ({gap_at}) "
             f"or its pool differs from the direct step's")
    for k in ("r2l_train_fwd", "r2l_train_bwd", "r2l_train_wgrad"):
        if s_run["launches"][k] != 1:
            fail(f"parallel (a): the sharded step launched {k} {s_run['launches'][k]} times")
    nccl_launches = s_run["launches"]
    del runs, d_run, s_run, grads, flat
    torch.cuda.empty_cache()

    # ---- (b) two gloo ranks on cuda:0: the four dryrun stages
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(spec, os.path.join(tmp, "spec.pt"))
        ranks, group_s = _par_spawn(torch, tmp)

    # their single-process counterparts, here on the same inputs
    def single(model, **kw):
        state, step = _par_step(model, dev, **kw)
        gen = torch.Generator(device=dev).manual_seed(spec["seed"])
        return step, state, gen

    model = r2l_student(sm.params, dev)
    step, state, gen = single(model, hard=TRAIN_HARD)
    pool = hard_pool_init(TRAIN_POOL, device=dev)
    _, pool, met = step(state, pool, gen, *batch)
    ref_dp = {"loss": met["loss_rgb"].item(), "pool": pool.rays.cpu(), "count": pool.count,
              "grads": _named_grads(model.named_parameters())}
    model = r2l_student(sm.params, dev, dtype="float32")
    step, state, gen = single(model, fused=False)
    _, _, met = step(state, None, gen, *(a[:PAR_TP_ROWS] for a in batch))
    ref_tp = {"loss": met["loss_rgb"].item(), "grads": _named_grads(model.named_parameters())}
    ref_serve = {q: r2l_forward_rays(serve, fo, fd, NEAR, FAR, N_SAMPLE, L_FREQ, quant=q,
                                     act_scales=scales if q else None, device=dev).cpu()
                 for q in ("", "int8")}
    models, state, step = _par_teacher(spec, dev)
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    _, met = step(state, gen, to, td, tt)
    ref_t = {"loss": met["loss"].item(),
             "grads": _named_grads((f"{k}.{n}", p) for k, mm in models.items()
                                   for n, p in mm.named_parameters())}
    del model, step, state

    problems, stages = [], {}
    for r, res in enumerate(ranks):
        dpr, tpr, tr = res["dp"], res["tp"], res["teacher"]
        gaps = {"dp": _grad_gap(dpr["grads"], ref_dp["grads"]),
                "tp": _grad_gap(tpr["grads"], ref_tp["grads"]),
                "teacher": _grad_gap(tr["grads"], ref_t["grads"])}
        serve_err = {q or "bf16": (res[f"serve{q}"]["rgb"] - ref_serve[q]).abs().max().item()
                     for q in ("", "int8")}
        stages[r] = (gaps, serve_err)
        print(f"parallel (b) rank {r}: 1. data x 2 fused flagship step, {dpr['rows']} batch "
              f"rows a rank, {(TRAIN_BATCH + TRAIN_HARD[1]) // 2} augmented rows through the "
              f"kernels: loss {dpr['loss']:.7f} vs single {ref_dp['loss']:.7f}, all-reduced "
              f"gradients {gaps['dp'][0]:.3g} in norm ({gaps['dp'][1]}), pool rows equal "
              f"{torch.equal(dpr['pool'], ref_dp['pool'])} (count {dpr['count']}), "
              f"{dpr['seconds']:.2f} s, launches {dpr['launches']}; 2. model x 2 f32 "
              f"unfused at {PAR_TP_ROWS} rows (width {tpr['width']} a rank): loss "
              f"{tpr['loss']:.7f} vs {ref_tp['loss']:.7f}, gradients {gaps['tp'][0]:.3g} "
              f"({gaps['tp'][1]}), {tpr['seconds']:.2f} s, launches {tpr['launches']}; "
              f"3. serving {res['serve']['rows']} of {fo.shape[0]} rays, gathered frame vs "
              f"r2l_forward_rays on the whole frame: bf16 max |diff| {serve_err['bf16']:.3g} "
              f"({res['serve']['seconds'] * 1e3:.1f} ms, launches {res['serve']['launches']}), "
              f"int8 {serve_err['int8']:.3g} ({res['serveint8']['seconds'] * 1e3:.1f} ms, "
              f"launches {res['serveint8']['launches']}); 4. NDC teacher step: loss "
              f"{tr['loss']:.7f} vs {ref_t['loss']:.7f}, gradients {gaps['teacher'][0]:.3g} "
              f"({gaps['teacher'][1]}), {tr['seconds']:.2f} s", flush=True)
        for label, got, want in (("dp", dpr, ref_dp), ("tp", tpr, ref_tp),
                                 ("teacher", tr, ref_t)):
            if not abs(got["loss"] - want["loss"]) <= PAR_LOSS_RTOL * abs(want["loss"]):
                problems.append(f"rank {r} {label} loss {got['loss']} vs {want['loss']}")
            tol = PAR_GRAD_TOL["fused" if label == "dp" else "f32"]
            if not gaps[label][0] <= tol:
                problems.append(f"rank {r} {label} gradients {gaps[label]} (tol {tol})")
        if not (torch.equal(dpr["pool"], ref_dp["pool"]) and dpr["count"] == ref_dp["count"]):
            problems.append(f"rank {r}: the pool differs from the single step's")
        if any(v != 0.0 for v in serve_err.values()):
            problems.append(f"rank {r}: the sharded frame differs from the whole frame's "
                            f"{serve_err}")
        need = {"dp": ("r2l_train_fwd", "r2l_train_bwd", "r2l_train_wgrad"),
                "serve": ("r2l_forward_fused",), "serveint8": ("r2l_forward_int8",)}
        for stage, names in need.items():
            for k in names:
                if res[stage]["launches"][k] < 1:
                    problems.append(f"rank {r}: {stage} launched {k} no time")
    if any(not torch.equal(ranks[0]["dp"]["grads"][k], ranks[1]["dp"]["grads"][k])
           for k in ref_dp["grads"]):
        problems.append("the two ranks' all-reduced gradients differ")
    print(f"parallel (b): two gloo ranks on cuda:0, wall {group_s:.1f} s with the spawn "
          f"({sm.gpu})", flush=True)
    if problems:
        fail("parallel (b): " + "; ".join(problems))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args()
    phases = (phase_build, phase_main, phase_main_int8, phase_train, phase_train_mlp,
              phase_teacher, phase_pseudo, phase_teacher_int8, phase_teacher_frame,
              phase_teacher_train, phase_distill, phase_driver, phase_parallel)
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
    # each kernel's launches on its phase's path and its error there against
    # its plain version
    print(json.dumps({"kernels": list(sm.entries.values())}))
    if chosen:
        print(sm.gpu)
        print(f"chip_smoke: partial run of {','.join(chosen)}: no result line")
        return
    print(sm.gpu)  # the card, as nvidia-smi names it and its power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": sm.torch.cuda.get_device_name(0),
        "count": sm.torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
