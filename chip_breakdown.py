#!/usr/bin/env python3
"""Where the fused R2L kernel's time goes, on one CUDA card.

    python3 chip_breakdown.py [--seed N]

Builds csrc/r2l_forward.cu as shipped and two variants of it made by
replacing one statement each, all with nvcc in parallel into
build/kernels/breakdown/, and times each on the rays of one 400x400 frame at
W256 D88 (the main path's shape) with CUDA events:

  shipped     the kernel as the port runs it
  no_loads    no weight copies: the products and barriers alone
              (wrong numbers, computed on whatever the buffers hold)
  no_products no mma.sync or ldmatrix: the weight stream and barriers alone

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
VARIANTS = {
    "shipped": None,
    "no_loads": (_LOAD, ""),
    "no_products": (_PRODUCTS, _PRODUCTS.replace("(owns)", "(false)")),
}


def _build(name, src, out_dir, nvcc, flags, csrc):
    cu = out_dir / f"{name}.cu"
    so = out_dir / f"lib{name}.so"
    cu.write_text(src)
    r = subprocess.run([nvcc, *flags, "-I", str(csrc), "-o", str(so), str(cu)],
                       capture_output=True, text=True, timeout=600)
    if r.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    regs = [ln.split(":", 1)[-1].strip() for ln in r.stdout.splitlines() + r.stderr.splitlines()
            if "registers" in ln]
    return so, regs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false; this script needs a card")
    from efficient_nerf_tpu_torch.core.poses import pose_spherical
    from efficient_nerf_tpu_torch.core.rays import get_rays
    from efficient_nerf_tpu_torch.ops import _build as build
    from efficient_nerf_tpu_torch.ops import r2l_forward as fwd

    shipped = (build.CSRC / "r2l_forward.cu").read_text()
    sources = {}
    for name, edit in VARIANTS.items():
        if edit is not None and edit[0] not in shipped:
            cs.fail(f"variant {name}: its statement is not in the source")
        sources[name] = shipped if edit is None else shipped.replace(*edit)
    out_dir = build.BUILD_DIR / "breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(sources)) as ex:
        futs = {n: ex.submit(_build, n, s, out_dir, build._nvcc(),
                             build.NVCC_FLAGS, build.CSRC)
                for n, s in sources.items()}
        built = {n: f.result() for n, f in futs.items()}

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = {k: v.to(dev) for k, v in cs.random_state_dict(args.seed, torch).items()}
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
    flops = fwd.r2l_forward_flops(packed, n_rays)
    bound_ms = flops / cs.H100_BF16_FLOPS * 1e3

    result = {"rays": n_rays, "bound_ms": bound_ms, "variants": {}}
    for name, (so, regs) in built.items():
        fn = ctypes.CDLL(str(so)).r2l_forward_launch
        restype, argtypes = fwd._SIGNATURES["r2l_forward_launch"]
        fn.restype, fn.argtypes = restype, list(argtypes)
        out = torch.empty((n_rays, 3), device=dev)

        def run():
            err = fn(ro.data_ptr(), rd.data_ptr(), z.data_ptr(),
                     *(packed[k].data_ptr() for k in (
                         "head_w", "head_b", "body_w", "body_b", "tail_w",
                         "tail_b")),
                     out.data_ptr(), n_rays, cs.N_SAMPLE, cs.L_FREQ, in_pad,
                     width, n_block, 3, 1.0, 0, stream)
            if err:
                cs.fail(f"variant {name}: launch failed, CUDA error {err}")

        ms = cs.cuda_ms(torch, run, 10)
        err = (out - want).abs().max().item()
        print(f"{name:12s} {ms:8.3f} ms  max |out - plain| {err:.3g}  {regs}",
              flush=True)
        result["variants"][name] = {"ms": ms, "max_abs_err": err}
    if not result["variants"]["shipped"]["max_abs_err"] <= cs.KERNEL_TOL:
        cs.fail("the shipped kernel disagrees with its plain version")
    result["card"] = cs.gpu_line()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
