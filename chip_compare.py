#!/usr/bin/env python3
"""Times kernel 6 (the sampler, csrc/sample_pdf.cu) and pass 1 of the
training backward (r2l_train_bwd_kernel, csrc/r2l_train.cu) as built from
several checkouts of the repository, in one process on one card, in turns,
so that a kernel and its parent are compared on the same card in one call.

    python3 chip_compare.py --tree new=. --tree parent=path/to/parent [--rounds 2]

Each tree's two sources are built with the port's nvcc flags into
build/compare/<label>/ (as chip_breakdown.py builds a variant: the tree's
headers beside the source) and called through their C entry points on the same
inputs, made by this checkout's package at the main path's shapes:
  sampler  a 32,768-ray chunk of the lego config's fine pass (C 63 coarse
           bin edges, 62 weights, 128 levels), sorted random edges in
           [2, 6] and uniform weights; its output against the plain
           version, bit for bit;
  pass 1   98,304 rays (the training step's) at W256 D88, the global
           residual on, need_dx off; each tree's scratch turned into the
           weight gradients by this checkout's pass 2 and held against the
           first tree's (max |a - b| / max |b|, within chip_smoke.py's
           TRAIN_TOL["grad"]).
A tree whose pass 1 takes no transposed body (body_wt) is called with the
older signature. The rounds run the trees in order, then in reverse order
(A B, B A, ...). Prints a line a measurement, the card's name and power
limit, and a JSON object last. Nothing of the port uses this script.
"""
from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import chip_breakdown as cb
import chip_smoke as cs


def _tree_libs(label: str, root: Path, out_dir: Path, build):
    csrc = root / "efficient_nerf_tpu_torch" / "csrc"
    libs = {}
    for source in ("sample_pdf.cu", "r2l_train.cu"):
        so, _ = cb._build(f"{label}-{source[:-3]}", {}, source, out_dir, build._nvcc(),
                          build.NVCC_FLAGS, csrc)
        libs[source] = ctypes.CDLL(str(so))
        print(f"{label}: built {source} from {csrc}", flush=True)
    new_bwd = "const void* body_wt" in (csrc / "r2l_train.cu").read_text()
    return libs, new_bwd


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="label=path of a checkout (at least one)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false; this script needs a card")
    from efficient_nerf_tpu_torch.models import R2LNet
    from efficient_nerf_tpu_torch.ops import _build as build
    from efficient_nerf_tpu_torch.ops import r2l_train as rt
    from efficient_nerf_tpu_torch.ops.sample_pdf import _levels, sample_pdf_det_fused_ref

    trees = [t.split("=", 1) for t in args.tree]
    out_dir = build.BUILD_DIR / "compare"
    libs = {label: _tree_libs(label, Path(path).resolve(), out_dir, build)
            for label, path in trees}

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    stream = torch.cuda.current_stream(dev).cuda_stream
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    # ---- the sampler's inputs
    n_rays, C, n = cs.T_CHUNK, cs.T_SAMPLES - 1, cs.T_IMPORTANCE
    bins = torch.sort(torch.rand((n_rays, C), generator=gen, device=dev) * 4 + 2, -1
                      ).values.contiguous()
    w = torch.rand((n_rays, C - 1), generator=gen, device=dev)
    u = _levels(n, dev)
    want_z = sample_pdf_det_fused_ref(bins, w, n)
    z = torch.empty_like(want_z)

    # ---- pass 1's inputs
    model = R2LNet(cs.IN_DIM, cs.DEPTH, cs.WIDTH, use_residual=True, dtype=torch.bfloat16)
    model.load_state_dict(cs.random_state_dict(args.seed, torch))
    packed = rt.pack_r2l_train_weights(rt._model_params(model.to(dev)), cs.L_FREQ)
    B = cs.TRAIN_BATCH + cs.TRAIN_HARD[1]
    x = (torch.randn((B, 3 * cs.N_SAMPLE), generator=gen, device=dev) * 2).contiguous()
    dout = torch.randn((B, 3), generator=gen, device=dev) * 1e-5
    _, hs = rt.r2l_train_fwd(packed, x, use_global_residual=True)
    act = rt.r2l_train_bwd_act(packed, x, hs, dout, use_global_residual=True, need_dx=False)
    keys = ("dg2", "dg1", "g1", "dpre", "emb", "part")
    nb, width, in_pad = packed["body_w"].shape[0], cs.WIDTH, packed["head_w"].shape[1]

    runs = {}
    for label, (lib_set, new_bwd) in libs.items():
        lp = lib_set["sample_pdf.cu"]
        lp.sample_pdf_det_launch.restype = I
        lp.sample_pdf_det_launch.argtypes = [P, P, P, P, L, I, I, P]

        def sampler(lp=lp):
            err = lp.sample_pdf_det_launch(bins.data_ptr(), w.data_ptr(), u.data_ptr(),
                                           z.data_ptr(), n_rays, C, n, stream)
            if err:
                cs.fail(f"sampler launch failed: CUDA error {err}")

        lt = lib_set["r2l_train.cu"]
        fn = lt.r2l_train_bwd_launch
        fn.restype = I
        fn.argtypes = [P] * (17 if new_bwd else 16) + [I] * 8 + [ctypes.c_float, I, P]
        extra = (packed["body_wt"].data_ptr(),) if new_bwd else ()

        def pass1(fn=fn, extra=extra):
            err = fn(x.data_ptr(), hs.data_ptr(), dout.data_ptr(),
                     *(packed[k].data_ptr() for k in rt._OPERANDS), *extra,
                     *(act[k].data_ptr() for k in keys), None, B, B, x.shape[1],
                     cs.L_FREQ, in_pad, width, nb, 3, 1.0, 1, stream)
            if err:
                cs.fail(f"pass 1 launch failed: CUDA error {err}")

        runs[label] = (sampler, pass1)

    # each tree's outputs: the sampler bit for bit, pass 1 through pass 2
    agree, ref_grads = {}, None
    for label, (sampler, pass1) in runs.items():
        z.zero_()
        sampler()
        pass1()
        torch.cuda.synchronize()
        g = rt.r2l_train_wgrad(act, hs)
        torch.cuda.synchronize()
        if ref_grads is None:
            ref_grads = {k: v.clone() for k, v in g.items()}
        agree[label] = {"sampler_values_differing": int((z != want_z).sum().item()),
                        "pass1_grad_vs_first": max(cs.rel_err(g[k], ref_grads[k])
                                                   for k in rt._OPERANDS)}
        print(f"{label}: sampler values differing from the plain version "
              f"{agree[label]['sampler_values_differing']}; pass 1's gradients against "
              f"{trees[0][0]}'s {agree[label]['pass1_grad_vs_first']:.3g}", flush=True)
        if agree[label]["sampler_values_differing"] or \
                not agree[label]["pass1_grad_vs_first"] <= cs.TRAIN_TOL["grad"]:
            cs.fail(f"{label}'s kernels disagree")
        del g

    times = {label: {"sampler_ms": [], "pass1_ms": []} for label in runs}
    order = list(runs)
    for r in range(args.rounds):
        for label in (order if r % 2 == 0 else order[::-1]):
            sampler, pass1 = runs[label]
            t = times[label]
            t["sampler_ms"].append(cs.cuda_ms(torch, sampler, 20))
            t["pass1_ms"].append(cs.cuda_ms(torch, pass1, 5))
            print(f"round {r} {label}: sampler {t['sampler_ms'][-1]:.4f} ms; pass 1 "
                  f"{t['pass1_ms'][-1]:.3f} ms", flush=True)
    card = cs.gpu_line()
    print(card, flush=True)
    print(json.dumps({"card": card, "agree": agree, "times": times}))


if __name__ == "__main__":
    main()
