#!/usr/bin/env python3
"""Where a fused kernel's time goes, on one CUDA card.

    python3 chip_breakdown.py [--seed N]
        [--kernel serve|serve_int8|train_bwd|teacher|teacher_int8]

Builds the kernel as shipped and variants of it made by replacing a few
statements each, all with nvcc in parallel into build/kernels/breakdown/,
and times each with CUDA events at the main path's shape (W256 D88).

serve: csrc/r2l_forward.cu on the rays of one 400x400 frame, its variants
edited in the weight stream it includes (csrc/r2l_mma.cuh):
  shipped      the kernel as the port runs it
  no_loads     no weight copies: the products and barriers alone
  no_products  no mma.sync or ldmatrix: the weight stream and barriers alone

serve_int8: csrc/r2l_int8.cu with static activation scales (from
calibrate_r2l_int8 on the frame's first 1024 rays) on the rays of one
400x400 frame, its variants edited in its own int8 weight stream:
  shipped      the kernel as the port runs it
  no_loads     no int8 weight copies: the products, epilogues and barriers
  no_products  no int8 mma.sync or ldmatrix: the weight stream, epilogues and
               barriers
  no_epilogues the static epilogues skipped (no dequantize, requantize or
               residual): the weight stream, products and barriers
  first_conversions  the kernel's first conversions, (float) of the int32
               sums and rintf, clip and a truncating cast for the levels:
               quarter-rate conversions, the same results
  ring_64x4    64-byte weight chunks in 4 stages instead of 128 in 2: a
               deeper ring, a barrier per chunk

train_bwd: the training backward of csrc/r2l_train.cu at 98,304 rays (the
training step's), need_dx off:
  shipped          the kernel as the port runs it
  float4_atomics   lanes pair up for one float4 atomic per four columns,
                   instead of one float2 per column pair
  no_atomics       the weight-gradient products without their atomics (a
                   store that never fires keeps them alive)
  no_weight_grads  neither the weight-gradient products nor their atomics

teacher: the teacher's field eval of csrc/nerf_forward.cu (W256 D8, L 10/4)
on a fine-pass chunk, 32,768 rays of one 400x400 frame at 192 sorted depths,
its variants edited in the tile code it includes (csrc/nerf_field.cuh):
  shipped      the kernel as the port runs it
  no_loads     no weight copies: the products, epilogues and barriers alone
  no_products  no mma.sync or ldmatrix: the weight stream, embed, epilogues
               and barriers
  no_trig      the embed without fast_sin (y + phase passes through)
  no_views     no view branch: neither the per-ray direction products nor
               the view layer's product and epilogue (rgb is left unset)

teacher_int8: the int8 field eval of csrc/nerf_int8.cu on the same fine
chunk, static scales from calibrate_nerf_int8 on its first 1024 points:
  shipped      the kernel as the port runs it
  no_loads     no int8 weight copies (the bf16 ones stay): the products,
               epilogues and barriers
  no_products  no int8 mma.sync or ldmatrix (the bf16 products stay)
  no_epilogues no int8 epilogues (dequantize, bias, relu, requantize, the
               alpha and feature heads' epilogues); the view layer's stays

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
_LOAD8 = "cp_async16(dst + r * LDS8 + piece * 16, src + (size_t)r * W + piece * 16);"
_PRODUCTS8 = "    if (owns) {\n      const int8_t* X = (l & 1) ? X1 : X0;"
_EPI_EVEN = "      } else if (owns) {\n        // t = acc * (dqs0 * inv1)"
_EPI_ODD = "    if (owns) {\n      float sg[RT][2];"
_EPI_QH = "    if (b + 1 < n_block) quantize_h(b + 1, owns);"
_CVT_SUM = "  return __fsub_rn(__int_as_float(v + 0x4B400000), 12582912.0f);"
_CVT_LEVELS = """  unsigned r;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;\\n"
      : "=r"(r)
      : "r"(__float2int_rn(fmaxf(y, -127.0f))), "r"(__float2int_rn(fmaxf(x, -127.0f))),
        "r"(0));
  *reinterpret_cast<unsigned short*>(p) = (unsigned short)r;"""
_FIRST_LEVELS = """  const int a = (int)fminf(fmaxf(rintf(x), -127.0f), 127.0f);
  const int b = (int)fminf(fmaxf(rintf(y), -127.0f), 127.0f);
  *reinterpret_cast<unsigned short*>(p) = (unsigned short)((a & 0xff) | ((b & 0xff) << 8));"""
_T_LOAD = "cp_async16(dst + r * LDS_B + piece * 16, src + (size_t)r * sg.ldw + piece * 16);"
_T_PRODUCTS = "    if (n0 < sg.n) {\n      const unsigned char* st = t.ring"
_T_TRIG = "v = fast_sin(__fadd_rn(y, phase), 7);"
_T_VIEWS_SEG = "  seg(views_h_w, 2 * W, W / 2, 1, depth + 1);\n"
_T_VIEWS_RAYS = "for (int idx = threadIdx.x; idx < nr * f.half; idx += NTHREADS) {"
_T8_PRODUCTS = "for (int kk = 0; kk < CHUNK_B; kk += 32) {"
_T8_EPI = "    const int L = sg.layer;\n    if (L == 0) {"
_FIELD = "nerf_field.cuh"
# kernel: (file built, {variant: [(file edited, old, new), ...]}); the
# shipped variant has no edits
KERNELS = {
    "serve": ("r2l_forward.cu", {
        "shipped": [],
        "no_loads": [("r2l_mma.cuh", _LOAD, "")],
        "no_products": [("r2l_mma.cuh", _PRODUCTS, _PRODUCTS.replace("(owns)", "(false)"))],
    }),
    "serve_int8": ("r2l_int8.cu", {
        "shipped": [],
        "no_loads": [("r2l_int8.cu", _LOAD8, "")],
        "no_products": [("r2l_int8.cu", _PRODUCTS8, _PRODUCTS8.replace("(owns)", "(false)"))],
        "no_epilogues": [("r2l_int8.cu", _EPI_EVEN, _EPI_EVEN.replace("(owns)", "(false)")),
                         ("r2l_int8.cu", _EPI_ODD, _EPI_ODD.replace("(owns)", "(false)")),
                         ("r2l_int8.cu", _EPI_QH, "")],
        "first_conversions": [("int8_epilogue.cuh", _CVT_SUM, "  return (float)v;"),
                              ("int8_epilogue.cuh", _CVT_LEVELS, _FIRST_LEVELS)],
        "ring_64x4": [("r2l_int8.cu", "constexpr int KC8 = 128; ", "constexpr int KC8 = 64;  "),
                      ("r2l_int8.cu", "constexpr int S8 = 2;", "constexpr int S8 = 4;")],
    }),
    "train_bwd": ("r2l_train.cu", {
        "shipped": [],
        "float4_atomics": [("r2l_train.cu", _ATOMIC, _FLOAT4)],
        "no_atomics": [("r2l_train.cu", _ATOMIC,
                        "            if (acc[i][j][2 * hf] == 1.2345e-38f) "
                        "gW[(size_t)row * ldg + col] = acc[i][j][2 * hf + 1];")],
        "no_weight_grads": [("r2l_train.cu", _DW, _DW.replace(
            "  for (int m0", "  if (M > 0) return;\n  for (int m0"))],
    }),
    "teacher": ("nerf_forward.cu", {
        "shipped": [],
        "no_loads": [(_FIELD, _T_LOAD, "")],
        "no_products": [(_FIELD, _T_PRODUCTS, _T_PRODUCTS.replace("(n0 < sg.n)", "(false)"))],
        "no_trig": [(_FIELD, _T_TRIG, "v = __fadd_rn(y, phase);")],
        "no_views": [(_FIELD, _T_VIEWS_SEG, ""),
                     (_FIELD, _T_VIEWS_RAYS, _T_VIEWS_RAYS.replace("nr * f.half", "0"))],
    }),
    "teacher_int8": ("nerf_int8.cu", {
        "shipped": [],
        "no_loads": [(_FIELD, _T_LOAD, "if (!sg.s8) " + _T_LOAD)],
        "no_products": [(_FIELD, _T8_PRODUCTS, _T8_PRODUCTS.replace("kk < CHUNK_B", "kk < 0"))],
        "no_epilogues": [("nerf_int8.cu", _T8_EPI,
                          _T8_EPI.replace("    if (L == 0) {", "    if (L <= D) return;\n"
                                                              "    if (L == 0) {"))],
    }),
}


def _build(name, edited, source, out_dir, nvcc, flags, csrc):
    """The kernel built from a copy of csrc's headers and the source side by
    side, the edited files among them: a quoted include finds the including
    file's directory first, so every header, also one included by another
    header, resolves to the variant's copy."""
    out_dir = out_dir / name
    out_dir.mkdir(parents=True, exist_ok=True)
    for src in [*csrc.glob("*.cuh"), csrc / source]:
        (out_dir / src.name).write_text(src.read_text())
    for fname, text in edited.items():
        (out_dir / fname).write_text(text)
    so = out_dir / f"lib{name}.so"
    r = subprocess.run([nvcc, *flags, "-o", str(so), str(out_dir / source)],
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

    bound_ms = fwd.r2l_forward_flops(packed, n_rays) / cs.H100_BF16_FLOPS * 1e3
    return n_rays, bound_ms, cs.KERNEL_TOL, make_run, error


def _serve_int8_runner(torch, dev, seed):
    from efficient_nerf_tpu_torch.core.poses import pose_spherical
    from efficient_nerf_tpu_torch.core.rays import get_rays
    from efficient_nerf_tpu_torch.ops import r2l_int8 as i8
    from efficient_nerf_tpu_torch.ops.r2l_forward import _zvals

    sd = {k: v.to(dev) for k, v in cs.random_state_dict(seed, torch).items()}
    packed = i8.pack_r2l_weights_int8(sd, cs.N_SAMPLE, cs.L_FREQ)
    ro, rd = get_rays(cs.FRAME_H, cs.FRAME_W, cs.FOCAL,
                      pose_spherical(-30.0, -30.0, 4.0)[:3, :4], device=dev)
    ro, rd = ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
    n_rays = ro.shape[0]
    act = i8.calibrate_r2l_int8(sd, ro[:cs.INT8_CAL], rd[:cs.INT8_CAL], cs.NEAR,
                                cs.FAR, cs.N_SAMPLE, cs.L_FREQ)
    z = _zvals(cs.NEAR, cs.FAR, cs.N_SAMPLE, dev)
    want = i8.r2l_forward_int8_ref(packed, ro, rd, cs.NEAR, cs.FAR, cs.N_SAMPLE,
                                   cs.L_FREQ, act_scales=act)
    width, in_pad = packed["head_w"].shape
    n_block = packed["body_qw"].shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((n_rays, 3), device=dev)

    def make_run(lib):
        fn = lib.r2l_int8_launch
        restype, argtypes = i8._SIGNATURES["r2l_int8_launch"]
        fn.restype, fn.argtypes = restype, list(argtypes)
        ptr = {k: packed[k].data_ptr() for k in i8._OPERANDS}
        return lambda: fn(ro.data_ptr(), rd.data_ptr(), z.data_ptr(), ptr["head_w"],
                          ptr["head_b"], ptr["body_qw"], ptr["body_sw"], ptr["body_b"],
                          act.data_ptr(), ptr["tail_w"], ptr["tail_b"], out.data_ptr(),
                          n_rays, cs.N_SAMPLE, cs.L_FREQ, in_pad, width, n_block, 3,
                          1.0, 0, stream)

    def error():
        return (out - want).abs().max().item()

    ops8, ops16 = i8.r2l_int8_ops(packed, n_rays)
    bound_ms = cs.bound(ops16, 0, int8_ops=ops8)[0]
    return n_rays, bound_ms, cs.INT8_TOL["static"], make_run, error


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

    bound_ms = rt.r2l_train_flops(packed, n_rays)[1] / cs.H100_BF16_FLOPS * 1e3
    return n_rays, bound_ms, cs.TRAIN_TOL["grad"], make_run, error


def _teacher_runner(torch, dev, seed):
    from efficient_nerf_tpu_torch.core.poses import pose_spherical
    from efficient_nerf_tpu_torch.core.rays import get_rays
    from efficient_nerf_tpu_torch.ops import nerf_forward as nf

    model = cs.teacher_model(seed, torch, dev)
    packed = nf.pack_nerf_weights(model.state_dict(), dtype=torch.bfloat16)
    n, S = cs.T_CHUNK, cs.T_SAMPLES + cs.T_IMPORTANCE
    ro, rd = get_rays(cs.FRAME_H, cs.FRAME_W, cs.T_FOCAL,
                      pose_spherical(-30.0, -30.0, 4.0)[:3, :4], device=dev)
    ro, rd = ro.reshape(-1, 3)[:n], rd.reshape(-1, 3)[:n]
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.sort(cs.NEAR + (cs.FAR - cs.NEAR) * torch.rand(
        (n, S), generator=gen, device=dev), dim=-1).values
    pts = (ro[:, None] + rd[:, None] * z[..., None]).contiguous()
    vd = (rd / rd.norm(dim=-1, keepdim=True)).contiguous()
    dirs = nf.embed_dirs(vd, cs.T_LV)
    want = nf.nerf_forward_fused_ref(packed, pts, vd, cs.T_L, cs.T_LV)
    out = torch.empty_like(want)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def make_run(lib):
        fn = lib.nerf_forward_launch
        restype, argtypes = nf._SIGNATURES["nerf_forward_launch"]
        fn.restype, fn.argtypes = restype, list(argtypes)
        return lambda: fn(pts.data_ptr(), 3, 1, dirs.data_ptr(),
                          *(packed[k].data_ptr() for k in nf._OPERANDS),
                          packed["out_b"].data_ptr(), out.data_ptr(), 4, 1, n * S, S,
                          packed["in_ch"], packed["in_pad"], packed["in_ch_views"],
                          packed["width"], packed["depth"], packed["skip"], stream)

    def error():
        return cs.rel_err(out, want)

    bound_ms = nf.nerf_forward_flops(packed, n * S, n) / cs.H100_BF16_FLOPS * 1e3
    return n * S, bound_ms, cs.TEACHER_TOL, make_run, error


def _teacher_int8_runner(torch, dev, seed):
    from efficient_nerf_tpu_torch.core.poses import pose_spherical
    from efficient_nerf_tpu_torch.core.rays import get_rays
    from efficient_nerf_tpu_torch.ops import nerf_forward as nf
    from efficient_nerf_tpu_torch.ops import nerf_int8 as ni

    model = cs.teacher_model(seed, torch, dev)
    sd = model.state_dict()
    packed = ni.pack_nerf_weights_int8(sd, skip=4)
    n, S = cs.T_CHUNK, cs.T_SAMPLES + cs.T_IMPORTANCE
    ro, rd = get_rays(cs.FRAME_H, cs.FRAME_W, cs.T_FOCAL,
                      pose_spherical(-30.0, -30.0, 4.0)[:3, :4], device=dev)
    ro, rd = ro.reshape(-1, 3)[:n], rd.reshape(-1, 3)[:n]
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.sort(cs.NEAR + (cs.FAR - cs.NEAR) * torch.rand(
        (n, S), generator=gen, device=dev), dim=-1).values
    pts = (ro[:, None] + rd[:, None] * z[..., None]).contiguous()
    vd = (rd / rd.norm(dim=-1, keepdim=True)).contiguous()
    act = ni.calibrate_nerf_int8(nf.pack_nerf_weights(sd, 4, torch.float32),
                                 pts.reshape(-1, 3)[:1024], cs.T_L)
    k = ni._fold(packed, act)
    dirs = nf.embed_dirs(vd, cs.T_LV)
    want = ni.nerf_forward_int8_ref(packed, pts, vd, cs.T_L, cs.T_LV, act_scales=act)
    out = torch.empty_like(want)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def make_run(lib):
        fn = lib.nerf_int8_launch
        restype, argtypes = ni._SIGNATURES["nerf_int8_launch"]
        fn.restype, fn.argtypes = restype, list(argtypes)
        ptrs = [packed["pts0_w"], packed["pts0_b"], packed["body_qw"], k["body_dqs"],
                k["body_b"], k["skip_x_w"], packed["feat_qw"], k["feat_dqs"],
                packed["feat_b_f32"], k["invs"]] + [packed[x] for x in (
                    "views_h_w", "views_d_w", "views_b", "rgb_w", "alpha_w", "out_b")]
        return lambda: fn(pts.data_ptr(), 3, 1, dirs.data_ptr(), *(t.data_ptr() for t in ptrs),
                          out.data_ptr(), 4, 1, n * S, S, packed["in_ch"], packed["in_pad"],
                          packed["in_ch_views"], packed["width"], packed["depth"],
                          packed["skip"], stream)

    def error():
        return cs.rel_err(out, want)

    ops8, ops16 = ni.nerf_int8_ops(packed, n * S, n)
    bound_ms = cs.bound(ops16, 0, int8_ops=ops8)[0]
    return n * S, bound_ms, cs.INT8_TEACHER_TOL, make_run, error


RUNNERS = {"serve": _serve_runner, "serve_int8": _serve_int8_runner,
           "train_bwd": _train_bwd_runner, "teacher": _teacher_runner,
           "teacher_int8": _teacher_int8_runner}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="serve")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false; this script needs a card")
    from efficient_nerf_tpu_torch.ops import _build as build

    source, variants = KERNELS[args.kernel]
    sources = {}
    for name, edits in variants.items():
        texts = {}
        for fname, old, new in edits:
            text = texts.get(fname) or (build.CSRC / fname).read_text()
            if text.count(old) != 1:
                cs.fail(f"variant {name}: its statement is not once in {fname}")
            texts[fname] = text.replace(old, new)
        sources[name] = texts
    out_dir = build.BUILD_DIR / "breakdown" / args.kernel
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(sources)) as ex:
        futs = {n: ex.submit(_build, n, texts, source, out_dir, build._nvcc(),
                             build.NVCC_FLAGS, build.CSRC)
                for n, texts in sources.items()}
        built = {n: f.result() for n, f in futs.items()}

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    n_rays, bound_ms, tol, make_run, error = RUNNERS[args.kernel](torch, dev, args.seed)

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
    if not result["variants"]["shipped"]["err"] <= tol:
        cs.fail("the shipped kernel disagrees with its reference")
    result["card"] = cs.gpu_line()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
