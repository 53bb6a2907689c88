#!/usr/bin/env python3
"""Where a fused R2L kernel's time goes, on one CUDA card.

    python3 chip_breakdown.py [--seed N] [--kernel serve|train_bwd]

Builds the kernel as shipped and variants of it made by replacing one
statement each, all with nvcc in parallel into build/kernels/breakdown/,
and times each with CUDA events at the main path's shape (W256 D88).

serve: csrc/r2l_forward.cu on the rays of one 400x400 frame, its variants
edited in the weight stream it includes (csrc/r2l_mma.cuh):
  shipped      the kernel as the port runs it
  no_loads     no weight copies: the products and barriers alone
  no_products  no mma.sync or ldmatrix: the weight stream and barriers alone

train_bwd: the training backward of csrc/r2l_train.cu at 98,304 rays (the
training step's), need_dx off:
  shipped          the kernel as the port runs it
  float4_atomics   lanes pair up for one float4 atomic per four columns,
                   instead of one float2 per column pair
  no_atomics       the weight-gradient products without their atomics (a
                   store that never fires keeps them alive)
  no_weight_grads  neither the weight-gradient products nor their atomics

Prints one line per variant and, last, a JSON object with the times, the
bound and the card's name and power limit. A diagnostic: the variants'
outputs are wrong by design, and nothing of the port uses this script.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import chip_smoke as cs

_LOAD = "cp_async16(dst + r * LDS + piece * 8, src + (size_t)r * K + piece * 8);"
_PRODUCTS = "    if (owns) {\n      const __nv_bfloat16* X = (l & 1) ? X1 : X0;"
_ATOMIC = ("            atomicAdd(reinterpret_cast<float2*>(gW + (size_t)row * ldg + col),\n"
           "                      make_float2(acc[i][j][2 * hf], acc[i][j][2 * hf + 1]));")
# lanes t and t ^ 1 trade a column pair, so that each adds four neighbouring
# columns of one row with one float4 atomic (half the atomic instructions)
_FLOAT4 = """            if (hf == 1) continue;
            const bool odd = t & 1;
            const float r0 = __shfl_xor_sync(0xffffffffu, odd ? acc[i][j][0] : acc[i][j][2], 1);
            const float r1 = __shfl_xor_sync(0xffffffffu, odd ? acc[i][j][1] : acc[i][j][3], 1);
            const float4 v = odd ? make_float4(r0, r1, acc[i][j][2], acc[i][j][3])
                                 : make_float4(acc[i][j][0], acc[i][j][1], r0, r1);
            atomicAdd(reinterpret_cast<float4*>(gW + (size_t)(row + (odd ? 8 : 0)) * ldg +
                                                n0 + 8 * j + 4 * (t / 2)), v);"""
_DW = "  const int g = lane / 4, t = lane % 4, mi = lane / 8;\n  for (int m0"
# kernel: (file edited, file built, {variant: (old, new) or None})
KERNELS = {
    "serve": ("r2l_mma.cuh", "r2l_forward.cu", {
        "shipped": None,
        "no_loads": (_LOAD, ""),
        "no_products": (_PRODUCTS, _PRODUCTS.replace("(owns)", "(false)")),
    }),
    "train_bwd": ("r2l_train.cu", "r2l_train.cu", {
        "shipped": None,
        "float4_atomics": (_ATOMIC, _FLOAT4),
        "no_atomics": (_ATOMIC, "            if (acc[i][j][2 * hf] == 1.2345e-38f) "
                                "gW[(size_t)row * ldg + col] = acc[i][j][2 * hf + 1];"),
        "no_weight_grads": (_DW, _DW.replace("  for (int m0", "  if (M > 0) return;\n"
                                                           "  for (int m0")),
    }),
}


def _build(name, edited_name, edited, source, out_dir, nvcc, flags, csrc):
    """The kernel with the edited file beside it (a quoted include finds the
    including file's directory first; the other headers come from csrc)."""
    out_dir = out_dir / name
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / edited_name).write_text(edited)
    cu = out_dir / source
    if source != edited_name:
        cu.write_text((csrc / source).read_text())
    so = out_dir / f"lib{name}.so"
    r = subprocess.run([nvcc, *flags, "-I", str(csrc), "-o", str(so), str(cu)],
                       capture_output=True, text=True, timeout=600)
    if r.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    regs = [ln.split(":", 1)[-1].strip() for ln in r.stdout.splitlines() + r.stderr.splitlines()
            if "registers" in ln or "spill" in ln]
    return so, regs


def _serve_runner(torch, dev, seed):
    from efficient_nerf_tpu_torch.core.poses import pose_spherical
    from efficient_nerf_tpu_torch.core.rays import get_rays
    from efficient_nerf_tpu_torch.ops import r2l_forward as fwd

    sd = {k: v.to(dev) for k, v in cs.random_state_dict(seed, torch).items()}
    packed = fwd.pack_r2l_weights(sd, cs.N_SAMPLE, cs.L_FREQ)
    ro, rd = get_rays(cs.FRAME_H, cs.FRAME_W, cs.FOCAL,
                      pose_spherical(-30.0, -30.0, 4.0)[:3, :4], device=dev)
    ro, rd = ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
    n_rays = ro.shape[0]
    z = fwd._zvals(cs.NEAR, cs.FAR, cs.N_SAMPLE, dev)
    want = fwd.r2l_forward_fused_ref(packed, ro, rd, cs.NEAR, cs.FAR,
                                     cs.N_SAMPLE, cs.L_FREQ)
    width, in_pad = packed["head_w"].shape
    n_block = packed["body_w"].shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((n_rays, 3), device=dev)

    def make_run(lib):
        fn = lib.r2l_forward_launch
        restype, argtypes = fwd._SIGNATURES["r2l_forward_launch"]
        fn.restype, fn.argtypes = restype, list(argtypes)
        return lambda: fn(ro.data_ptr(), rd.data_ptr(), z.data_ptr(),
                          *(packed[k].data_ptr() for k in (
                              "head_w", "head_b", "body_w", "body_b", "tail_w",
                              "tail_b")),
                          out.data_ptr(), n_rays, cs.N_SAMPLE, cs.L_FREQ, in_pad,
                          width, n_block, 3, 1.0, 0, stream)

    def error():
        return (out - want).abs().max().item()

    return n_rays, fwd.r2l_forward_flops(packed, n_rays), make_run, error


def _train_bwd_runner(torch, dev, seed):
    from efficient_nerf_tpu_torch.core.poses import pose_spherical
    from efficient_nerf_tpu_torch.core.ray_sampler import sample_ray_points
    from efficient_nerf_tpu_torch.core.rays import get_rays
    from efficient_nerf_tpu_torch.models import R2LNet
    from efficient_nerf_tpu_torch.ops import r2l_train as rt

    model = R2LNet(cs.IN_DIM, cs.DEPTH, cs.WIDTH, use_residual=True,
                   dtype=torch.bfloat16)
    model.load_state_dict(cs.random_state_dict(seed, torch))
    model = model.to(dev)
    packed = rt.pack_r2l_train_weights(rt._model_params(model), cs.L_FREQ)
    n_rays = cs.TRAIN_BATCH + cs.TRAIN_HARD[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    ro, rd = get_rays(cs.FRAME_H, cs.FRAME_W, cs.FOCAL,
                      pose_spherical(-30.0, -30.0, 4.0)[:3, :4], device=dev)
    pick = torch.randint(0, cs.FRAME_H * cs.FRAME_W, (n_rays,), generator=gen,
                         device=dev)
    x = sample_ray_points(ro.reshape(-1, 3)[pick], rd.reshape(-1, 3)[pick],
                          cs.NEAR, cs.FAR, cs.N_SAMPLE, perturb=True,
                          generator=gen).contiguous()
    _, hs = rt.r2l_train_fwd(packed, x, use_global_residual=True)
    dout = torch.randn((n_rays, 3), generator=gen, device=dev)
    # the port's own launch of the shipped kernel: the variants' reference
    want = rt.r2l_train_bwd(packed, x, hs, dout, use_global_residual=True,
                            need_dx=False)
    grads = {k: torch.zeros_like(want[k]) for k in rt._OPERANDS}

    def make_run(lib):
        fn = lib.r2l_train_bwd_launch
        restype, argtypes = rt._SIGNATURES["r2l_train_bwd_launch"]
        fn.restype, fn.argtypes = restype, list(argtypes)

        def run():
            for g in grads.values():
                g.zero_()
            return fn(x.data_ptr(), hs.data_ptr(), dout.data_ptr(),
                      *(packed[k].data_ptr() for k in rt._OPERANDS),
                      *(grads[k].data_ptr() for k in rt._OPERANDS), None,
                      *rt._shape_args(packed, x, 1.0, True))
        return run

    def error():
        return max(cs.rel_err(grads[k], want[k]) for k in rt._OPERANDS)

    return n_rays, rt.r2l_train_flops(packed, n_rays)[1], make_run, error


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="serve")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false; this script needs a card")
    from efficient_nerf_tpu_torch.ops import _build as build

    edited_name, source, variants = KERNELS[args.kernel]
    shipped = (build.CSRC / edited_name).read_text()
    sources = {}
    for name, edit in variants.items():
        if edit is not None and edit[0] not in shipped:
            cs.fail(f"variant {name}: its statement is not in the source")
        sources[name] = shipped if edit is None else shipped.replace(*edit)
    out_dir = build.BUILD_DIR / "breakdown" / args.kernel
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(sources)) as ex:
        futs = {n: ex.submit(_build, n, edited_name, s, source, out_dir,
                             build._nvcc(), build.NVCC_FLAGS, build.CSRC)
                for n, s in sources.items()}
        built = {n: f.result() for n, f in futs.items()}

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    runner = _serve_runner if args.kernel == "serve" else _train_bwd_runner
    n_rays, flops, make_run, error = runner(torch, dev, args.seed)
    bound_ms = flops / cs.H100_BF16_FLOPS * 1e3

    result = {"kernel": args.kernel, "rays": n_rays, "bound_ms": bound_ms,
              "variants": {}}
    for name, (so, regs) in built.items():
        launch = make_run(ctypes.CDLL(str(so)))

        def run():
            err = launch()
            if err:
                cs.fail(f"variant {name}: launch failed, CUDA error {err}")

        ms = cs.cuda_ms(torch, run, 5)
        run()
        torch.cuda.synchronize()
        err = error()
        print(f"{name:16s} {ms:8.3f} ms  error vs the port's kernel or plain "
              f"version {err:.3g}  {regs}", flush=True)
        result["variants"][name] = {"ms": ms, "err": err}
    tol = cs.KERNEL_TOL if args.kernel == "serve" else cs.TRAIN_TOL["grad"]
    if not result["variants"]["shipped"]["err"] <= tol:
        cs.fail("the shipped kernel disagrees with its reference")
    result["card"] = cs.gpu_line()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
