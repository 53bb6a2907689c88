#!/usr/bin/env python3
"""Times kernels as built from several checkouts of the repository, in one
process on one card, in turns, so that a kernel and its parent are compared
on the same card in one call: kernel 6 (the sampler, csrc/sample_pdf.cu) and
pass 1 of the training backward (r2l_train_bwd_kernel, csrc/r2l_train.cu), or
with --kernels forward kernels 1 and 3a (r2l_forward_kernel,
csrc/r2l_forward.cu, and r2l_train_fwd_kernel, csrc/r2l_train.cu).

    python3 chip_compare.py --tree new=. --tree parent=path/to/parent [--rounds 2]
        [--kernels pass1|forward]

Each tree's two sources are built with the port's nvcc flags into
build/compare/<label>/ (as chip_breakdown.py builds a variant: the tree's
headers beside the source) and called through their C entry points on the same
inputs, made by this checkout's package at the main path's shapes:
  sampler  a 32,768-ray chunk of the lego config's fine pass (C 63 coarse
           bin edges, 62 weights, 128 levels), sorted random edges in
           [2, 6] and uniform weights; its output against the plain
           version, bit for bit;
  pass 1   the training step's 98,304 rays (distill_shards' batch) of the
           flagship with the r2l cells' weights (perfbench/reference), the
           global residual on, need_dx off; each tree's scratch turned into
           the weight gradients by this checkout's pass 2 and held against
           the first tree's (max |a - b| / max |b|, within chip_smoke.py's
           GRAD_TOL).
forward: kernel 1 on the rays of one 400x400 frame (160,000) and kernel 3a
on the training step's 98,304 rays of sample points (chip_breakdown.py's
serve and train_fwd inputs); each tree's outputs (rgb, and 3a's hs) against
the first tree's, bit for bit: the count of values that differ.
Every tree is called through this checkout's C signatures. The rounds run
the trees in order, then in reverse order (A B, B A, ...). Prints a line a
measurement, the card's name and power limit, and a JSON object last.
Nothing of the port uses this script.
"""
from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import chip_breakdown as cb
import chip_smoke as cs


def _tree_libs(label: str, root: Path, out_dir: Path, build, sources):
    csrc = root / "efficient_nerf_tpu_torch" / "csrc"
    libs = {}
    for source in sources:
        so, _ = cb._build(f"{label}-{source[:-3]}", {}, source, out_dir, build._nvcc(),
                          build.NVCC_FLAGS, csrc)
        libs[source] = ctypes.CDLL(str(so))
        print(f"{label}: built {source} from {csrc}", flush=True)
    return libs


def _bind(lib, name: str, signatures):
    fn = getattr(lib, name)
    fn.restype, argtypes = signatures[name]
    fn.argtypes = list(argtypes)
    return fn


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="label=path of a checkout (at least one)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", choices=("pass1", "forward"), default="pass1")
    args = ap.parse_args()
    if args.kernels == "forward":
        return compare_forward(args)

    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false; this script needs a card")
    from efficient_nerf_tpu_torch.ops import _build as build
    from efficient_nerf_tpu_torch.ops import r2l_train as rt
    from efficient_nerf_tpu_torch.ops import sample_pdf as sp

    trees = [t.split("=", 1) for t in args.tree]
    out_dir = build.BUILD_DIR / "compare"
    libs = {label: _tree_libs(label, Path(path).resolve(), out_dir, build,
                              ("sample_pdf.cu", "r2l_train.cu"))
            for label, path in trees}

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    stream = torch.cuda.current_stream(dev).cuda_stream

    # ---- the sampler's inputs
    n_rays, C, n = cs.T_CHUNK, cs.T_SAMPLES - 1, cs.T_IMPORTANCE
    bins = torch.sort(torch.rand((n_rays, C), generator=gen, device=dev) * 4 + 2, -1
                      ).values.contiguous()
    w = torch.rand((n_rays, C - 1), generator=gen, device=dev)
    u = sp._levels(n, dev)
    want_z = sp.sample_pdf_det_fused_ref(bins, w, n)
    z = torch.empty_like(want_z)

    # ---- pass 1's inputs
    model = cs.r2l_student(cb._student_params(dev, args.seed), dev)
    packed = rt.pack_r2l_train_weights(rt._model_params(model), cs.L_FREQ)
    B = cs.TRAIN_BATCH + cs.TRAIN_HARD[1]
    x = (torch.randn((B, 3 * cs.N_SAMPLE), generator=gen, device=dev) * 2).contiguous()
    dout = torch.randn((B, 3), generator=gen, device=dev) * 1e-5
    _, hs = rt.r2l_train_fwd(packed, x, use_global_residual=True)
    act = rt.r2l_train_bwd_act(packed, x, hs, dout, use_global_residual=True, need_dx=False)
    keys = ("dg2", "dg1", "g1", "dpre", "emb", "part")
    nb, width, in_pad = packed["body_w"].shape[0], *packed["head_w"].shape

    runs = {}
    for label, lib_set in libs.items():
        launch_pdf = _bind(lib_set["sample_pdf.cu"], "sample_pdf_det_launch", sp._SIGNATURES)
        launch_bwd = _bind(lib_set["r2l_train.cu"], "r2l_train_bwd_launch", rt._SIGNATURES)

        def sampler(fn=launch_pdf):
            err = fn(bins.data_ptr(), w.data_ptr(), u.data_ptr(), z.data_ptr(), n_rays, C, n,
                     stream)
            if err:
                cs.fail(f"sampler launch failed: CUDA error {err}")

        def pass1(fn=launch_bwd):
            err = fn(x.data_ptr(), hs.data_ptr(), dout.data_ptr(),
                     *(packed[k].data_ptr() for k in rt._OPERANDS),
                     packed["body_wt"].data_ptr(), *(act[k].data_ptr() for k in keys), None,
                     B, B, x.shape[1], cs.L_FREQ, in_pad, width, nb, 3, 1.0, 1, stream)
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
                not agree[label]["pass1_grad_vs_first"] <= cs.GRAD_TOL:
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


def compare_forward(args) -> None:
    """Kernels 1 and 3a of each tree: bits against the first tree's, then
    their times in turns."""
    import torch

    from efficient_nerf_tpu_torch.ops import _build as build

    trees = [t.split("=", 1) for t in args.tree]
    out_dir = build.BUILD_DIR / "compare"
    libs = {label: _tree_libs(label, Path(path).resolve(), out_dir, build,
                              ("r2l_forward.cu", "r2l_train.cu"))
            for label, path in trees}
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    # the inputs of chip_breakdown.py's serve and train_fwd runners
    serve_runner = cb._serve_runner(torch, dev, args.seed)
    train_runner = cb._train_fwd_runner(torch, dev, args.seed)
    runs = {label: (serve_runner[3](lib_set["r2l_forward.cu"]),
                    train_runner[3](lib_set["r2l_train.cu"]))
            for label, lib_set in libs.items()}
    outputs = (serve_runner[5], train_runner[5])

    agree, first = {}, None
    for label, pair in runs.items():
        got = []
        for run, out in zip(pair, outputs):
            for t in out():
                t.zero_()
            if run():
                cs.fail(f"{label}: launch failed")
            torch.cuda.synchronize()
            got.append([t.clone() for t in out()])
        if first is None:
            first = got
        agree[label] = {name: int(sum((a != b).sum().item() for a, b in zip(g, f)))
                        for name, g, f in zip(("serve", "train_fwd"), got, first)}
        print(f"{label}: values differing from {trees[0][0]}'s: {agree[label]}", flush=True)
        del got

    times = {label: {"serve_ms": [], "train_fwd_ms": []} for label in runs}
    order = list(runs)
    for r in range(args.rounds):
        for label in (order if r % 2 == 0 else order[::-1]):
            serve, train = runs[label]
            t = times[label]
            t["serve_ms"].append(cs.cuda_ms(torch, serve, 10))
            t["train_fwd_ms"].append(cs.cuda_ms(torch, train, 10))
            print(f"round {r} {label}: kernel 1 {t['serve_ms'][-1]:.4f} ms; kernel 3a "
                  f"{t['train_fwd_ms'][-1]:.4f} ms", flush=True)
    card = cs.gpu_line()
    print(card, flush=True)
    print(json.dumps({"card": card, "agree": agree, "times": times}))


if __name__ == "__main__":
    main()
