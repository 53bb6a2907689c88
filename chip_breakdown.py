#!/usr/bin/env python3
"""Where a fused kernel's time goes, on one CUDA card.

    python3 chip_breakdown.py [--seed N]
        [--kernel serve|train_fwd|serve_int8|train_bwd|teacher|teacher_int8|frame|sampler]

Builds the kernel as shipped and variants of it made by replacing a few
statements each, all with nvcc in parallel into build/kernels/breakdown/,
and times each with CUDA events on the benchmark's workload: the weights
that perfbench/reference makes for r2l_w256d88 and nerf_lego, rays of one
frame of serve_orbit's camera (lego's, for the teacher), the training
step's 98,304 rays of distill_shards' batch. The shipped variant is the
port's per-kernel timer; the bound beside it is the least time of the
kernel's work at the card's peaks: the whole model's work and the bf16,
f32 and HBM peaks from perfbench/yardstick.py, each backward pass's own
work from ops/r2l_train.py, the int8 products at the int8 peak.

serve: csrc/r2l_forward.cu on the rays of one 400x400 frame, its variants
edited in the wgmma tile it includes (csrc/r2l_wgmma.cuh; at W256 the body
on per-panel barriers):
  shipped      the kernel as the port runs it
  release_early  each stage freed as soon as its own products are read
               (instead of after the next chunk's products are issued)
  two_boxes    each weight chunk loaded as two TMA boxes of Wp / 2 rows
               instead of one of Wp rows
  loader_nowait  thread 0 loads every chunk after the first S: a chunk once
               its stage is free, found by a test that does not wait, and
               deferred otherwise, up to the wait for that chunk's own copy
  loader_waits thread 0 loads every chunk after the first S, waiting for
               its stage to be free (the design before the last releasing
               warp loaded): warp 0 stalls on the slowest warp of the other
               warpgroup at every chunk
  no_loads     no TMA weight copies (each stage completes on the loading
               thread's arrival alone): the products, epilogues and layer
               synchronisation
  no_products  no wgmma: the weight stream, epilogues and layer
               synchronisation
  no_epilogue_math  the body's sums stored as they are: no bias (nor its
               loads), relu or residual
  no_epilogue_stores  the body's epilogue math without its stores of a and a2
               (kept by a test that never holds)
  no_layer_barrier  no wait between a layer's epilogue and the next layer's
               products (neither the panel barriers nor a block barrier):
               timing only, the products read stale panels
  no_fence     the body's epilogues without the proxy fence before each
               panel's signal (the products may read stale panels)
  layer_barrier  the body on one block barrier a layer, as at widths whose
               warpgroups do not own whole panels, instead of per-panel
               barriers
  no_bias_loads  the body's biases not loaded (two constants in their
               place): the cost of their reads
  bias_late    each layer's biases loaded as the layer starts, under its
               products, instead of a layer ahead

train_fwd: csrc/r2l_train.cu's forward (the same tile, storing hs) at the
training step's 98,304 rays, the global residual on, variants as serve's,
and
  no_hs_stores no TMA stores of hs: the forward alone

serve_int8: csrc/r2l_int8.cu with static activation scales (from
calibrate_r2l_int8 on the frame's first 1024 rays) on the rays of one
400x400 frame, its variants edited in the int8 body of the wgmma tile
(csrc/r2l_wgmma.cuh) and in csrc/int8_epilogue.cuh:
  shipped      the kernel as the port runs it
  no_loads     no TMA copies of the body's int8 chunks (each stage completes
               on the loading thread's arrival alone; the head's stay): the
               products, epilogues and layer barriers
  no_products  no s8 wgmma: the weight stream, epilogues and layer barriers
  no_epilogues the body's epilogues skipped (no dequantize, requantize or
               residual): the weight stream, products and layer barriers
  first_conversions  I2F of the int32 sums and F2I for the levels (one
               quarter-rate conversion each) in place of the full-rate add
               tricks of int8_epilogue.cuh, the same results
  ring_2       a 2-stage weight ring instead of 3

train_bwd: the training backward's two passes at 98,304 rays (the training
step's), need_dx off, the global residual on. Pass 1, csrc/r2l_train.cu
(its wgmma tile):
  shipped          the kernel as the port runs it
  no_stores        no TMA stores of dg2, dg1 and dpre and no copy-out of
                   the embed (g1's stores from the registers stay)
  no_products      no wgmma: the weight stream, the h loads, the epilogues,
                   stores and block barriers
  no_loads         no TMA weight copies (each stage completes on the loading
                   thread's arrival alone): the products on stale stages
  ring_2           a 2-stage weight ring instead of as many as fit (3 at W256)
  loader_waits     thread 0 loads every chunk after the first ST, waiting for
                   its stage to be free (the design before the last releasing
                   warp loaded): warp 0 stalls on the slowest warp of the
                   other warpgroup at every chunk
and pass 2, csrc/r2l_wgrad.cu, on the shipped pass 1's scratch:
  wgrad_shipped    the kernel as the port runs it (TMA boxes, mbarriers)
  wgrad_loads_only no products: the TMA copies and the barriers alone
  wgrad_products_only  no copies (each stage's barrier completes on the
                   producer's arrival alone): the products on stale tiles

teacher: the teacher's field eval of csrc/nerf_forward.cu (W256 D8, L 10/4)
on a fine-pass chunk, 32,768 rays of one 400x400 frame at 192 sorted depths,
its variants edited in the wgmma field tile it includes (csrc/nerf_wgmma.cuh):
  shipped      the kernel as the port runs it
  no_loads     no TMA weight copies (each stage completes on the loading
               thread's arrival alone): the products, embed and epilogues
  no_products  no wgmma: the weight stream, embed and epilogues
  no_trig      the embed without fast_sin (y + phase passes through)
  no_views     no view-layer products and no per-ray direction rows (the
               rgb head's epilogue stays, on zero sums)
  no_epilogues no epilogue arithmetic or stores (relu, feature, view and
               rgb head); the warpgroup barriers stay
  block_barrier  every warpgroup barrier a block barrier, as the mma.sync
               tile had: the two warpgroups meet at every layer, so one's
               epilogue no longer runs under the other's products
  ring_2       a 2-stage weight ring instead of as many as fit (4 at W256)
  one_tile_a_block  one block per 128-point tile instead of persistent
               blocks (the ring starts empty at every tile)
  no_trap      no trap on a lost copy (the ring's waits still time out)
  no_fence     the body and feature epilogues without their proxy fence
               (the next products may read stale activations)
  no_stores    the body and feature epilogues without their stores of the
               activations (computed, kept by a test that never holds)
  no_cvt       the epilogues' bf16 conversions replaced by an integer xor of
               the two f32 words (the same data flow, no conversion)

sampler: the inverse-CDF kernel of csrc/sample_pdf.cu on a 32,768-ray chunk of
the lego config's fine pass (C 63, n 128; sorted random edges, uniform
weights), its variants edited in the warp routine (csrc/sample_pdf.cuh):
  shipped      the kernel as the port runs it
  no_cdf       no sequential CDF sum by lane 0 (the levels search the pdfs)
  no_sums      neither the total nor the CDF summed in order (the levels
               search the floored weights)
  no_levels    no levels: the loads, the sums, the divisions and the stores

frame: the whole-ray kernel of csrc/nerf_frame.cu (the same tile) on 32,768
rays of the same frame at 64 + 128 samples, white background:
  shipped      the kernel as the port runs it
  no_glue      no composite, inverse CDF, merge or output (the fine pass
               runs on depths left in shared memory)
  no_products  no wgmma: the weight stream, embed, epilogues and glue

teacher_int8: the int8 field eval of csrc/nerf_int8.cu (the same field
tile, s8 wgmma for the body and the feature head) on the same fine chunk,
static scales from calibrate_nerf_int8 on its first 1024 points:
  shipped      the kernel as the port runs it
  no_loads     no TMA copies of the int8 chunks (the bf16 ones stay): the
               products, embed and epilogues
  no_products  no s8 wgmma (the bf16 products stay)
  no_epilogues no int8 epilogues (dequantize, bias, relu, requantize, the
               alpha head, the feature head's); the skip layer's
               dequantization and the view layer's epilogue stay
  one_part     each layer in one part of all 256 columns (128 sums a thread
               live through its epilogue) instead of two parts of 128
  first_conversions  as serve_int8's
  ring_2       a 2-stage weight ring instead of as many as fit (4 at W256)
  block_barrier  every warpgroup barrier a block barrier
  one_tile_a_block  one block per 128-point tile instead of persistent
               blocks

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
from perfbench import inputs
from perfbench import yardstick as Y

_WG = "r2l_wgmma.cuh"
_WG_ISSUE = """    mbar_arrive_expect_tx(&full[s], WP * 128);
    tma_box(ring + (size_t)s * WP * KC, map, k * (head ? KC : KB), 0, layer, &full[s]);
"""
_WG_PRODUCTS = "        Wgmma<NT>::run(acc, da + 2 * k, db + 2 * k, carry || kc + k > 0);\n"
_WG_HS = "tma_store_box(&maps.hs, a + q * PANEL, 64 * q, (int)ray0, blk);"
_WG_HS_PANEL = "tma_store_box(&maps.hs, X + kc * PANEL, KC * kc, (int)ray0, hs_blk);"
_WG_RELEASE = """    if (lane == 0 && atom_add_acq_rel(&freed[read % S], 1u) % (NTHREADS / 32) ==
                         NTHREADS / 32 - 1)
      issue(read + S);
"""
_WG_FULL_WAIT = "      mbar_wait(&full[s], (c / S) & 1);\n"
_WG_CONSUMED = "  int c = 0;  // chunks consumed\n"
# thread 0's next chunk to load, and whether every warp has released the
# chunk S before n from its stage (an acquire read of the stage's count)
_WG_LOADER = _WG_CONSUMED + """  int next = S;
  auto stage_free = [&](int n) {
    unsigned v;
    asm volatile("ld.acquire.cta.shared::cta.u32 %0, [%1];\\n"
                 : "=r"(v) : "r"(tma_smem_addr(&freed[n % S])) : "memory");
    return (int)v >= (NTHREADS / 32) * (n / S);
  };
"""
_WG_PAIRS = """      auto even_pair = [&](int i) {
        const float2 b = bias[i / 4];
        return bf16x2<true>(acc[i] + b.x, acc[i + 1] + b.y);
      };
      // rounded as the plain version rounds it (no FMA)
      auto odd_pair = [&](int i) {
        const float2 b = bias[i / 4];
        h[i] = __fadd_rn(__fmul_rn(acc[i] + b.x, rs), h[i]);
        h[i + 1] = __fadd_rn(__fmul_rn(acc[i + 1] + b.y, rs), h[i + 1]);
        return bf16x2<false>(h[i], h[i + 1]);
      };
"""
_WG_STSM = '  asm volatile("stmatrix.sync'
_WG_PANEL_WAIT = "        mbar_wait(&rdy[kc], par);\n"
_WG_BAR = "    if (HS && tid == 0) bulk_wait_read();\n    __syncthreads();\n"
_WG_NEXT_B = "      const float* next_b = body_bias(l + 1);\n"
_WG_VARIANTS = {
    "two_boxes": [(_WG, _WG_ISSUE, """    mbar_arrive_expect_tx(&full[s], WP * 128);
    for (int r = 0; r < 2; ++r)
      tma_box(ring + (size_t)s * WP * KC + r * NT * KC, map, k * KC, r * NT, layer, &full[s]);
"""), (_WG, "  const unsigned rows = (unsigned)round_up64(W);",
                "  const unsigned rows = (unsigned)(round_up64(W) / 2);")],
    "loader_nowait": [
        (_WG, _WG_RELEASE, """    if (lane == 0) atom_add_acq_rel(&freed[read % S], 1u);
    if (tid == 0)
      while (next <= read + S && next < total && stage_free(next)) issue(next++);
"""),
        (_WG, _WG_CONSUMED, _WG_LOADER),
        (_WG, _WG_FULL_WAIT, """      if (tid == 0)
        for (; next <= c; ++next) {
          while (!stage_free(next)) {
          }
          issue(next);
        }
""" + _WG_FULL_WAIT)],
    "loader_waits": [
        (_WG, _WG_RELEASE, """    if (lane == 0) atom_add_acq_rel(&freed[read % S], 1u);
    if (tid == 0 && read + S < total) {
      while (!stage_free(read + S)) {
      }
      issue(read + S);
    }
"""),
        (_WG, _WG_CONSUMED, _WG_LOADER)],
    "release_early": [(_WG, """      wgmma_commit();
      if (kc > 0) {
        wgmma_wait<1>();  // the chunk before this one has been read
        release(c - 1);
      }
    }
    wgmma_wait<0>();
    release(c - 1);
""", """      wgmma_commit();
      wgmma_wait<0>();
      release(c);
    }
""")],
    "no_loads": [(_WG, _WG_ISSUE, "    mbar_arrive(&full[s]);\n")],
    "no_products": [(_WG, _WG_PRODUCTS, "")],
    "no_epilogue_math": [(_WG, _WG_PAIRS, """      auto even_pair = [&](int i) { return bf16x2<false>(acc[i], acc[i + 1]); };
      auto odd_pair = even_pair;
""")],
    "no_epilogue_stores": [(_WG, _WG_STSM, '  if (r0 == 0x7fc17fc1u && r1 == r2)\n    asm volatile("stmatrix.sync')],
    "no_layer_barrier": [(_WG, _WG_PANEL_WAIT, ""),
                         (_WG, _WG_BAR, "    if (HS && tid == 0) bulk_wait_read();\n")],
    "no_fence": [(_WG, "      fence_proxy_async();\n      if (HS && q == 0", "      if (HS && q == 0")],
    "layer_barrier": [(_WG, "  constexpr bool PP = !S8 && per_panel(NT);", "  constexpr bool PP = false;")],
    "no_bias_loads": [(_WG, "      auto next = [&](int j) { load_bias_j(next_b, j); };",
                       "      auto next = [&](int j) { bias[j] = make_float2(rs, -rs); };")],
    "bias_late": [(_WG, _WG_NEXT_B, _WG_NEXT_B + "#pragma unroll\n"
                   "      for (int j = 0; j < NT / 8; ++j) load_bias_j(body_bias(l), j);\n"),
                  (_WG, "      auto next = [&](int j) { load_bias_j(next_b, j); };",
                   "      auto next = [&](int) {};")],
}
_STORE = "  const int c8 = ncols / 8;\n"
_TB_STORE = "      tma_store_box(map, src + q * wg::PANEL, 64 * q, (int)ray0, layer);\n"
_TB_PRODUCTS = "        wg::Wgmma<NT>::run(acc, da + 2 * k, db + 2 * k, kc + k > 0);\n"
_TB_ISSUE = "    mbar_arrive_expect_tx(&full[st], WP * 128);\n"
_TB_STAGES = "constexpr int BWD_MAX_STAGES = 6;"
_TB_RELEASE = """    if (lane == 0 && wg::atom_add_acq_rel(&freed[read % ST], 1u) % (NTHREADS / 32) ==
                         NTHREADS / 32 - 1)
      issue(read + ST);
"""
# whether every warp has released the chunk ST before n from its stage (an
# acquire read of the stage's count)
_TB_LOADER = _WG_CONSUMED + """  auto stage_free = [&](int n) {
    unsigned v;
    asm volatile("ld.acquire.cta.shared::cta.u32 %0, [%1];\\n"
                 : "=r"(v) : "r"(tma_smem_addr(&freed[n % ST])) : "memory");
    return (int)v >= (NTHREADS / 32) * (n / ST);
  };
"""
_W_PRODUCTS = "      if (active) stage_product(As, As + A_TILE, acc, ms, ns, lane);\n"
_W_EXPECT = "        mbar_arrive_expect_tx(&full[s], bytes);"
_W_BOXES_A = "        for (int b = 0; b < na; ++b)"
_W_BOXES_B = "        for (int b = 0; b < nbx; ++b)"
_WG8_PRODUCTS = "          WgmmaS8<NT>::run(acc8, da + 2 * k, db + 2 * k, kc + k > 0);\n"
_WG8_EPI_EVEN = ("          for (int j = 0; j < NT / 8; ++j) {\n            const int col = col0 + 8 * j;\n"
                 "            const float2 sw = *reinterpret_cast<const float2*>(csw + col);\n"
                 "            const float2 bb = *reinterpret_cast<const float2*>(cb + col);\n"
                 "            const float c0x")
_WG8_EPI_ODD = "        products8(qg);\n#pragma unroll\n        for (int j = 0; j < NT / 8; ++j) {"
_WG8_QH = "        if (b + 1 < nb) quantize_h(b + 1);"
_E8 = "int8_epilogue.cuh"
_CVT_SUM = "  return __fsub_rn(__int_as_float(v + 0x4B400000), 12582912.0f);"
_CVT_LEVEL = "  return __float_as_uint(__fadd_rn(fminf(fmaxf(x, -127.0f), 127.0f), 12582912.0f));"
_CVT_LEVEL_POS = "  return __float_as_uint(__fadd_rn(fminf(x, 127.0f), 12582912.0f));"
_FIRST_CONVERSIONS = [
    (_E8, _CVT_SUM, "  return __int2float_rn(v);"),
    (_E8, _CVT_LEVEL, "  return (unsigned)__float2int_rn(fminf(fmaxf(x, -127.0f), 127.0f));"),
    (_E8, _CVT_LEVEL_POS, "  return (unsigned)__float2int_rn(fminf(x, 127.0f));")]
_I8 = "nerf_int8.cu"
_T8_EPI = "  for (int m = 0; m < 8; ++m) {\n    const nw::Slot<W> a(c0, t, m), b(c1, t, m);"
_T8_FEAT = ("  for (int m = 0; m < 8; ++m) {\n    const nw::Slot<W> a(dqs, t, m), b(bias, t, m);\n"
            "    unsigned* at")
_NW = "nerf_wgmma.cuh"
_NW_ISSUE = """  mbar_arrive_expect_tx(bar, rows * 128);
  tma_box(dst, map, col, 0, layer, bar);
"""
_NW8_PRODUCTS = """    if (first)
      wg::WgmmaS8<N>::first(acc, da, db);
    else
      wg::WgmmaS8<N>::run(acc, da, db, 1);
#pragma unroll
    for (int j = 1; j < KC8 / 32; ++j) wg::WgmmaS8<N>::run(acc, da + 2 * j, db + 2 * j, 1);
"""
_NW_PRODUCTS = "      wg::Wgmma<N>::run(acc, da + 2 * j, db + 2 * j, carry || kc + j > 0);\n"
_NW_TRIG = "v = grp == 0 ? xv : fast_sin(__fadd_rn(__fmul_rn(xv, freq), phase), 7);"
_NW_CHUNKS = "  return 2 * (s.in_pad / KC) + s.depth * (s.W >> body_lkc(s)) + s.W / KC;"
_NW_VIEWS = "  products<HALF>(accv, act, W / KC, false, st, sm, k, lost);\n"
_NW_EPI = "  for (int m = 0; m < 8; ++m) {\n    const Slot<W> b(bias, t, m);"
_NW_BAR = '  asm volatile("bar.sync %0, 128;\\n" ::"r"(1 + wgi) : "memory");'
_NW_STORE = "        at[pn * PANEL / 2 + hf * 8 * KC / 2] = h;\n"
_NW_FENCE = "  fence_proxy_async();  // the writes reach the next products' reads\n"
_NW_EPI_VIEW = "  for (int mc = 0; mc < (HALF < KC ? HALF / 8 : 8); ++mc) {"
_NW_TRAP = "  if (lost) __trap();  // a lost copy fails the launch instead of hanging the card\n"
_NW_CVT = """  unsigned r;
  if (RELU)"""
_NW_VIEW_ROWS = "      view_rows(hvd, nr, half, p.s.ev, p.m.views_d_w, tw, 128,"
_NW_GRID = "  const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);"
_FR_GLUE_C = ("      for (int r = warp; r < R; r += nw::NTHREADS / 32) {\n        float res[6];\n"
              "        float* w =")
_SP = "sample_pdf.cuh"
_SP_CDF = """  if (lane == 0) {
    float cdf_lo = 0.0f;
#pragma unroll 8
    for (int i = 0; i < C - 1; ++i) cdf[i] = cdf_lo = __fadd_rn(cdf_lo, cdf[i]);
  }
"""
_SP_TOTAL = "  for (int i = 0; i < C - 1; ++i) total = __fadd_rn(total, __fadd_rn(w[i], 1e-5f));\n"
_SP_LEVELS = "  for (int j = lane; j < n; j += 32) o[j] = pdf_level(b, cdf, C, su[j]);\n"
_FR_GLUE_F = ("    for (int r = warp; r < R; r += nw::NTHREADS / 32) {\n      float res[6];\n"
              "      composite_warp(")
# kernel: (file built, {variant: [(file edited, old, new), ...]}); the
# shipped variant has no edits
KERNELS = {
    "serve": ("r2l_forward.cu", {
        "shipped": [],
        **_WG_VARIANTS,
    }),
    "train_fwd": ("r2l_train.cu", {
        "shipped": [],
        **_WG_VARIANTS,
        "no_hs_stores": [(_WG, _WG_HS, ""), (_WG, _WG_HS_PANEL, "")],
    }),
    "serve_int8": ("r2l_int8.cu", {
        "shipped": [],
        "no_loads": [(_WG, _WG_ISSUE, "    if (!head) {\n      mbar_arrive(&full[s]);\n"
                                      "      return;\n    }\n" + _WG_ISSUE)],
        "no_products": [(_WG, _WG8_PRODUCTS, "")],
        "no_epilogues": [(_WG, _WG8_EPI_EVEN, _WG8_EPI_EVEN.replace("j < NT / 8", "j < 0 * NT")),
                         (_WG, _WG8_EPI_ODD, _WG8_EPI_ODD.replace("j < NT / 8", "j < 0 * NT")),
                         (_WG, _WG8_QH, "")],
        "first_conversions": _FIRST_CONVERSIONS,
        "ring_2": [(_WG, "constexpr int S = 3;", "constexpr int S = 2;")],
    }),
    "train_bwd": ("r2l_train.cu", {
        "shipped": [],
        "no_stores": [("r2l_train.cu", _TB_STORE, "      continue;\n"),
                      ("r2l_train.cu", _STORE, _STORE + "  if (c8 > 0) return;\n")],
        "no_products": [("r2l_train.cu", _TB_PRODUCTS, "")],
        "no_loads": [("r2l_train.cu", _TB_ISSUE, "    mbar_arrive(&full[st]);\n    return;\n")],
        "ring_2": [("r2l_train.cu", _TB_STAGES, "constexpr int BWD_MAX_STAGES = 2;")],
        "loader_waits": [
            ("r2l_train.cu", _TB_RELEASE, """    if (lane == 0) wg::atom_add_acq_rel(&freed[read % ST], 1u);
    if (tid == 0 && read + ST < total) {
      while (!stage_free(read + ST)) {
      }
      issue(read + ST);
    }
"""),
            ("r2l_train.cu", _WG_CONSUMED, _TB_LOADER)],
        "wgrad_shipped": ("r2l_wgrad.cu", []),
        "wgrad_loads_only": ("r2l_wgrad.cu", [("r2l_wgrad.cu", _W_PRODUCTS, "")]),
        "wgrad_products_only": ("r2l_wgrad.cu", [
            ("r2l_wgrad.cu", _W_EXPECT, "        mbar_arrive(&full[s]);"),
            ("r2l_wgrad.cu", _W_BOXES_A, _W_BOXES_A.replace("b < na", "b < 0")),
            ("r2l_wgrad.cu", _W_BOXES_B, _W_BOXES_B.replace("b < nbx", "b < 0"))]),
    }),
    "teacher": ("nerf_forward.cu", {
        "shipped": [],
        "no_loads": [(_NW, _NW_ISSUE, "  mbar_arrive(bar);\n")],
        "no_products": [(_NW, _NW_PRODUCTS, "")],
        "no_trig": [(_NW, _NW_TRIG, "v = grp == 0 ? xv : __fadd_rn(__fmul_rn(xv, freq), phase);")],
        "no_views": [(_NW, _NW_CHUNKS, _NW_CHUNKS.replace(" + s.W / KC;", ";")),
                     (_NW, _NW_VIEWS, "  for (int i = 0; i < HALF / 2; ++i) accv[i] = 0.0f;\n"),
                     (_NW, _NW_VIEW_ROWS, _NW_VIEW_ROWS.replace("nr,", "0,"))],
        "no_epilogues": [(_NW, _NW_EPI, _NW_EPI.replace("m < 8", "m < 0")),
                         (_NW, _NW_EPI_VIEW, _NW_EPI_VIEW.replace("mc < (HALF", "mc < 0 * (HALF"))],
        "block_barrier": [(_NW, _NW_BAR, "  __syncthreads();")],
        "ring_2": [(_NW, "constexpr int MAX_STAGES = 8;", "constexpr int MAX_STAGES = 2;")],
        "one_tile_a_block": [(_NW, _NW_GRID, "  const unsigned grid = (unsigned)tiles;")],
        "no_trap": [(_NW, _NW_TRAP, "")],
        "no_fence": [(_NW, _NW_FENCE, "")],
        "no_stores": [(_NW, _NW_STORE, "        if (h == 0x7fc17fc1u) " + _NW_STORE.lstrip())],
        "no_cvt": [(_WG, _NW_CVT, "  unsigned r = __float_as_uint(lo) ^ __float_as_uint(hi);\n  if (false)")],
    }),
    "teacher_int8": ("nerf_int8.cu", {
        "shipped": [],
        "no_loads": [(_NW, _NW_ISSUE, "  if (s.s8 && (map == &m.body || map == &m.feat)) {\n"
                                      "    mbar_arrive(bar);\n    return;\n  }\n" + _NW_ISSUE)],
        "no_products": [(_NW, _NW8_PRODUCTS, "")],
        "no_epilogues": [(_I8, _T8_EPI, _T8_EPI.replace("m < 8", "m < 0")),
                         (_I8, _T8_FEAT, _T8_FEAT.replace("m < 8", "m < 0"))],
        "one_part": [(_I8, "constexpr int SPLIT = W == 256 ? 2 : 1,", "constexpr int SPLIT = 1,")],
        "first_conversions": _FIRST_CONVERSIONS,
        "ring_2": [(_NW, "constexpr int MAX_STAGES = 8;", "constexpr int MAX_STAGES = 2;")],
        "block_barrier": [(_NW, _NW_BAR, "  __syncthreads();")],
        "one_tile_a_block": [(_NW, _NW_GRID, "  const unsigned grid = (unsigned)tiles;")],
    }),
    "sampler": ("sample_pdf.cu", {
        "shipped": [],
        "no_cdf": [(_SP, _SP_CDF, "")],
        "no_sums": [(_SP, _SP_CDF, ""), (_SP, _SP_TOTAL, "  total = 1.0f;\n")],
        "no_levels": [(_SP, _SP_LEVELS, _SP_LEVELS.replace("j < n;", "j < 0;"))],
    }),
    "frame": ("nerf_frame.cu", {
        "shipped": [],
        "no_glue": [("nerf_frame.cu", _FR_GLUE_C, _FR_GLUE_C.replace("r < R", "r < 0")),
                    ("nerf_frame.cu", _FR_GLUE_F, _FR_GLUE_F.replace("r < R", "r < 0"))],
        "no_products": [(_NW, _NW_PRODUCTS, "")],
    }),
}


def variant_sources(edits, csrc):
    """{file: edited text} of a variant's edits, each applied to the text the
    edits before it left; raises unless each edit's old text occurs exactly
    once there (a variant whose text no longer matches its source)."""
    texts = {}
    for fname, old, new in edits:
        text = texts.get(fname) or (csrc / fname).read_text()
        if text.count(old) != 1:
            raise ValueError(f"its statement is {text.count(old)} times in {fname}, not once")
        texts[fname] = text.replace(old, new)
    return texts


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


# The card's int8 tensor-core peak (H100 SXM data sheet, dense); the
# yardstick holds the bf16, f32 and HBM peaks and no int8 one
PEAK_INT8_OPS = 1979e12


def bound(flops: float = 0.0, nbytes: float = 0.0, int8_ops: float = 0.0) -> float:
    """The least ms the card could take: flops at the bf16 peak and int8_ops
    at the int8 peak, or nbytes at the HBM rate, whichever is longer."""
    return max(flops / Y.PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS,
               nbytes / Y.PEAK_HBM_BYTES) * 1e3


def _student_params(dev, seed):
    """The r2l cells' weights of the flagship."""
    from perfbench.reference import r2l_w256d88

    return r2l_w256d88.init_params(cs.R2L, inputs.torch_generator(seed, dev, 0))


def _teacher_params(dev, seed):
    """The teacher_train cell's coarse network's weights."""
    from perfbench.reference import nerf_lego

    return nerf_lego.init_params(cs.TEACHER, inputs.torch_generator(seed, dev, 0))["coarse"]


def _frame_rays(dev, focal):
    """The rays of one 400x400 frame of the served orbit."""
    from efficient_nerf_tpu_torch.core.rays import get_rays

    ro, rd = get_rays(cs.FRAME_H, cs.FRAME_W, focal, cs.orbit(-30.0)[:3, :4], device=dev)
    return ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()


def _train_points(torch, dev, seed, n_rays):
    """Perturbed sample points of n_rays random rays of the frame."""
    from efficient_nerf_tpu_torch.core.ray_sampler import sample_ray_points

    ro, rd = _frame_rays(dev, cs.FOCAL)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pick = torch.randint(0, ro.shape[0], (n_rays,), generator=gen, device=dev)
    x = sample_ray_points(ro[pick], rd[pick], cs.NEAR, cs.FAR, cs.N_SAMPLE, perturb=True,
                          generator=gen).contiguous()
    return x, gen


def _serve_runner(torch, dev, seed):
    from efficient_nerf_tpu_torch.ops import r2l_forward as fwd

    packed = fwd.pack_r2l_weights(_student_params(dev, seed), cs.N_SAMPLE, cs.L_FREQ)
    grs = cs.R2L["use_residual"]
    ro, rd = _frame_rays(dev, cs.FOCAL)
    n_rays = ro.shape[0]
    z = fwd._zvals(cs.NEAR, cs.FAR, cs.N_SAMPLE, dev)
    want = fwd.r2l_forward_fused_ref(packed, ro, rd, cs.NEAR, cs.FAR, cs.N_SAMPLE, cs.L_FREQ,
                                     use_global_residual=grs)
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
                          width, n_block, 3, 1.0, int(grs), stream)

    def error():
        return (out - want).abs().max().item()

    bound_ms = bound(2.0 * n_rays * Y.r2l_forward_macs(cs.R2L))
    return n_rays, bound_ms, cs.KERNEL_TOL, make_run, error, lambda: (out,)


def _serve_int8_runner(torch, dev, seed):
    from efficient_nerf_tpu_torch.ops import r2l_int8 as i8
    from efficient_nerf_tpu_torch.ops.r2l_forward import _zvals

    sd = _student_params(dev, seed)
    packed = i8.pack_r2l_weights_int8(sd, cs.N_SAMPLE, cs.L_FREQ)
    grs = cs.R2L["use_residual"]
    ro, rd = _frame_rays(dev, cs.FOCAL)
    n_rays = ro.shape[0]
    act = i8.calibrate_r2l_int8(sd, ro[:cs.INT8_CAL], rd[:cs.INT8_CAL], cs.NEAR,
                                cs.FAR, cs.N_SAMPLE, cs.L_FREQ)
    z = _zvals(cs.NEAR, cs.FAR, cs.N_SAMPLE, dev)
    want = i8.r2l_forward_int8_ref(packed, ro, rd, cs.NEAR, cs.FAR, cs.N_SAMPLE,
                                   cs.L_FREQ, use_global_residual=grs, act_scales=act)
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
                          1.0, int(grs), stream)

    def error():
        return (out - want).abs().max().item()

    # the int8 body at the int8 peak, the bf16 head and tail at the bf16 one
    ops8, ops16 = i8.r2l_int8_ops(packed, n_rays)
    return n_rays, bound(ops16, int8_ops=ops8), cs.INT8_TOL, make_run, error


def _train_fwd_runner(torch, dev, seed):
    from efficient_nerf_tpu_torch.ops import r2l_train as rt

    model = cs.r2l_student(_student_params(dev, seed), dev)
    packed = rt.pack_r2l_train_weights(rt._model_params(model), cs.L_FREQ)
    n_rays = cs.TRAIN_BATCH + cs.TRAIN_HARD[1]
    x, _ = _train_points(torch, dev, seed, n_rays)
    want, _ = rt.r2l_train_fwd_ref(packed, x, use_global_residual=True)
    width, in_pad = packed["head_w"].shape
    nb = packed["body_w"].shape[0]
    out = torch.empty((n_rays, 3), device=dev)
    hs = torch.empty((nb + 1, n_rays, width), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def make_run(lib):
        fn = lib.r2l_train_fwd_launch
        restype, argtypes = rt._SIGNATURES["r2l_train_fwd_launch"]
        fn.restype, fn.argtypes = restype, list(argtypes)
        return lambda: fn(x.data_ptr(), *(packed[k].data_ptr() for k in rt._OPERANDS),
                          out.data_ptr(), hs.data_ptr(), n_rays, x.shape[1], cs.L_FREQ,
                          in_pad, width, nb, 3, 1.0, 1, stream)

    def error():
        return (out - want).abs().max().item()

    bound_ms = bound(2.0 * n_rays * Y.r2l_forward_macs(cs.R2L))
    return n_rays, bound_ms, cs.KERNEL_TOL, make_run, error, lambda: (out, hs)


def _train_bwd_runner(torch, dev, seed):
    from efficient_nerf_tpu_torch.ops import r2l_train as rt

    model = cs.r2l_student(_student_params(dev, seed), dev)
    packed = rt.pack_r2l_train_weights(rt._model_params(model), cs.L_FREQ)
    n_rays = cs.TRAIN_BATCH + cs.TRAIN_HARD[1]
    x, gen = _train_points(torch, dev, seed, n_rays)
    _, hs = rt.r2l_train_fwd(packed, x, use_global_residual=True)
    dout = torch.randn((n_rays, 3), generator=gen, device=dev)
    # the port's own launches of the shipped passes: the variants' references
    want_act = rt.r2l_train_bwd_act(packed, x, hs, dout, use_global_residual=True,
                                    need_dx=False)
    want_g = rt.r2l_train_wgrad(want_act, hs)
    keys = ("dg2", "dg1", "g1", "dpre", "emb", "part")
    act = {k: torch.empty_like(want_act[k]) for k in keys}
    grads = {k: torch.empty_like(want_g[k]) for k in rt._OPERANDS}
    nb, Bp, width, in_pad, out_dim = rt._act_dims(want_act)
    stream = torch.cuda.current_stream(dev).cuda_stream
    last = {}

    def make_run(lib):
        if hasattr(lib, "r2l_wgrad_launch"):       # pass 2 on pass 1's scratch
            sig = {**rt._WGRAD_SIGNATURES}
            for name, (restype, argtypes) in sig.items():
                getattr(lib, name).restype = restype
                getattr(lib, name).argtypes = list(argtypes)
            work = torch.empty(lib.r2l_wgrad_work_floats(Bp // 64, width, in_pad, nb),
                               dtype=torch.float32, device=dev)

            def run():
                last["pass"] = 2
                return lib.r2l_wgrad_launch(
                    *(want_act[k].data_ptr() for k in ("dg2", "dg1", "g1")), hs.data_ptr(),
                    want_act["dpre"].data_ptr(), want_act["emb"].data_ptr(),
                    want_act["part"].data_ptr(), work.data_ptr(),
                    *(grads[k].data_ptr() for k in rt._OPERANDS), Bp // 64, n_rays, n_rays,
                    width, in_pad, nb, out_dim, 0, stream)
            return run
        fn = lib.r2l_train_bwd_launch
        restype, argtypes = rt._SIGNATURES["r2l_train_bwd_launch"]
        fn.restype, fn.argtypes = restype, list(argtypes)

        def run():
            last["pass"] = 1
            return fn(x.data_ptr(), hs.data_ptr(), dout.data_ptr(),
                      *(packed[k].data_ptr() for k in rt._OPERANDS),
                      packed["body_wt"].data_ptr(),
                      *(act[k].data_ptr() for k in keys), None, n_rays, n_rays,
                      x.shape[1], cs.L_FREQ, in_pad, width, nb, out_dim, 1.0, 1, stream)
        return run

    def error():
        if last["pass"] == 2:
            return max(cs.rel_err(grads[k], want_g[k]) for k in rt._OPERANDS)
        return max(cs.rel_err(act[k], want_act[k]) for k in keys)

    # the whole backward's least work (the yardstick's), and each pass's own
    # (pass 1 recomputes each block's first product)
    pass1, pass2 = rt.r2l_train_pass_flops(packed, n_rays)
    bound_ms = {"backward": bound(2.0 * n_rays * Y.r2l_backward_macs(cs.R2L)),
                "pass 1": bound(pass1), "pass 2": bound(pass2)}
    return n_rays, bound_ms, cs.GRAD_TOL, make_run, error


def _sampler_runner(torch, dev, seed):
    from efficient_nerf_tpu_torch.ops import sample_pdf as sp

    n_rays, C, n = cs.T_CHUNK, cs.T_SAMPLES - 1, cs.T_IMPORTANCE
    gen = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.sort(torch.rand((n_rays, C), generator=gen, device=dev) * 4 + 2, -1
                      ).values.contiguous()
    w = torch.rand((n_rays, C - 1), generator=gen, device=dev)
    u = sp._levels(n, dev)
    want = sp.sample_pdf_det_fused_ref(bins, w, n)
    out = torch.empty_like(want)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def make_run(lib):
        fn = lib.sample_pdf_det_launch
        restype, argtypes = sp._SIGNATURES["sample_pdf_det_launch"]
        fn.restype, fn.argtypes = restype, list(argtypes)
        return lambda: fn(bins.data_ptr(), w.data_ptr(), u.data_ptr(), out.data_ptr(),
                          n_rays, C, n, stream)

    def error():
        return (out - want).abs().max().item()

    return n_rays, bound(nbytes=n_rays * (2 * C - 1 + n) * 4), 0.0, make_run, error


def _teacher_chunk(torch, dev, seed):
    """The teacher_train cell's coarse network packed in bf16, and a fine
    chunk of 32,768 rays of one lego frame at 192 sorted random depths: the
    points, the rays' directions and the points' count a ray."""
    from efficient_nerf_tpu_torch.ops import nerf_forward as nf

    packed = nf.pack_nerf_weights(_teacher_params(dev, seed), dtype=torch.bfloat16)
    t = cs.TEACHER
    n, S = t["chunk"], t["n_samples"] + t["n_importance"]
    ro, rd = (r[:n] for r in _frame_rays(dev, cs.T_FOCAL))
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.sort(t["near"] + (t["far"] - t["near"]) * torch.rand(
        (n, S), generator=gen, device=dev), dim=-1).values
    pts = (ro[:, None] + rd[:, None] * z[..., None]).contiguous()
    return packed, pts, (rd / rd.norm(dim=-1, keepdim=True)).contiguous(), S


def _teacher_runner(torch, dev, seed):
    from efficient_nerf_tpu_torch.ops import nerf_forward as nf

    packed, pts, vd, S = _teacher_chunk(torch, dev, seed)
    n, L, LV = pts.shape[0], cs.TEACHER["multires"], cs.TEACHER["multires_views"]
    dirs = nf.embed_dirs(vd, LV)
    want = nf.nerf_forward_fused_ref(packed, pts, vd, L, LV)
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

    bound_ms = bound(2.0 * n * (S * Y.nerf_point_macs(cs.TEACHER) + Y.nerf_ray_macs(cs.TEACHER)))
    return n * S, bound_ms, cs.TEACHER_TOL, make_run, error


def _teacher_int8_runner(torch, dev, seed):
    from efficient_nerf_tpu_torch.ops import nerf_forward as nf
    from efficient_nerf_tpu_torch.ops import nerf_int8 as ni

    sd = _teacher_params(dev, seed)
    skip = cs.TEACHER["skips"][0]
    packed = ni.pack_nerf_weights_int8(sd, skip=skip)
    _, pts, vd, S = _teacher_chunk(torch, dev, seed)
    n, L, LV = pts.shape[0], cs.TEACHER["multires"], cs.TEACHER["multires_views"]
    act = ni.calibrate_nerf_int8(nf.pack_nerf_weights(sd, skip, torch.float32),
                                 pts.reshape(-1, 3)[:1024], L)
    k = ni._fold(packed, act)
    dirs = nf.embed_dirs(vd, LV)
    want = ni.nerf_forward_int8_ref(packed, pts, vd, L, LV, act_scales=act)
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

    # the int8 products at the int8 peak, the bf16 ones at the bf16 one
    ops8, ops16 = ni.nerf_int8_ops(packed, n * S, n)
    return n * S, bound(ops16, int8_ops=ops8), cs.INT8_TEACHER_TOL, make_run, error


def _frame_runner(torch, dev, seed):
    import ctypes as ct

    from efficient_nerf_tpu_torch.ops import nerf_forward as nf
    from efficient_nerf_tpu_torch.ops import nerf_frame as fr

    t = cs.TEACHER
    packed = nf.pack_nerf_weights(_teacher_params(dev, seed), dtype=torch.bfloat16)
    n, S_c, S_f = t["chunk"], t["n_samples"], t["n_importance"]
    near, far, L, LV = t["near"], t["far"], t["multires"], t["multires_views"]
    ro, rd = (r[:n].contiguous() for r in _frame_rays(dev, cs.T_FOCAL))
    vd = (rd / rd.norm(dim=-1, keepdim=True)).contiguous()
    args = (packed, None, ro, rd, vd, near, far, S_c, S_f, L, LV)
    want = [x.reshape(n, -1) for x in fr.nerf_render_rays_fused_ref(*args, white_bkgd=True)[:4]]
    z, bins, u = fr._consts(near, far, S_c, S_f, False, dev)
    dirs = nf.embed_dirs(vd, LV)
    out = torch.empty((n, fr.OUT_CH), device=dev)
    weights = (ct.c_void_p * 13)(*[packed[k].data_ptr() for k in nf._OPERANDS + ("out_b",)])
    stream = torch.cuda.current_stream(dev).cuda_stream

    def make_run(lib):
        fn = lib.nerf_frame_launch
        restype, argtypes = fr._SIGNATURES["nerf_frame_launch"]
        fn.restype, fn.argtypes = restype, list(argtypes)
        w = ct.cast(weights, ct.c_void_p)
        return lambda: fn(ro.data_ptr(), rd.data_ptr(), dirs.data_ptr(), z.data_ptr(),
                          bins.data_ptr(), u.data_ptr(), out.data_ptr(), None, None, n,
                          fr._rays_per_block(S_c), S_c, S_f, 1, w, w, packed["in_ch"],
                          packed["in_pad"], packed["in_ch_views"], packed["width"],
                          packed["depth"], packed["skip"], packed["skip"], stream)

    def error():
        # rgb, acc and depth against FRAME_TOL, at the share of rays that
        # may exceed it: 1 at the tolerance
        got = {"rgb": out[:, 0:3], "acc": out[:, 4:5], "depth": out[:, 5:6]}
        ref = {"rgb": want[0], "acc": want[2][:, :1], "depth": want[3][:, :1]}
        return max((got[k] - ref[k]).abs().nan_to_num(0.0).amax(-1)
                   .quantile(1 - cs.FRAME_SHARE).item() / cs.FRAME_TOL[k] for k in got)

    # the coarse and the fine pass's field evals
    bound_ms = bound(2.0 * n * (Y.nerf_samples_per_ray(t) * Y.nerf_point_macs(t)
                                + Y.passes(t) * Y.nerf_ray_macs(t)))
    return n, bound_ms, 1.0, make_run, error


RUNNERS = {"serve": _serve_runner, "train_fwd": _train_fwd_runner,
           "serve_int8": _serve_int8_runner,
           "train_bwd": _train_bwd_runner, "teacher": _teacher_runner,
           "sampler": _sampler_runner,
           "teacher_int8": _teacher_int8_runner, "frame": _frame_runner}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="serve")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false; this script needs a card")
    from efficient_nerf_tpu_torch.ops import _build as build

    default_source, variants = KERNELS[args.kernel]
    sources, built_from = {}, {}
    for name, edits in variants.items():
        # a variant is its edits, or (the file it builds, its edits)
        source, edits = edits if isinstance(edits, tuple) else (default_source, edits)
        built_from[name] = source
        try:
            sources[name] = variant_sources(edits, build.CSRC)
        except ValueError as e:
            cs.fail(f"variant {name}: {e}")
    out_dir = build.BUILD_DIR / "breakdown" / args.kernel
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(sources)) as ex:
        futs = {n: ex.submit(_build, n, texts, built_from[n], out_dir, build._nvcc(),
                             build.NVCC_FLAGS, build.CSRC)
                for n, texts in sources.items()}
        built = {n: f.result() for n, f in futs.items()}

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    n_rays, bound_ms, tol, make_run, error = RUNNERS[args.kernel](torch, dev, args.seed)[:5]

    print(f"bound (ms at the card's peaks, H100 SXM data sheet): {json.dumps(bound_ms)}",
          flush=True)
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
    for name, v in result["variants"].items():
        if name.endswith("shipped") and not v["err"] <= tol:
            cs.fail(f"the shipped kernel ({name}) disagrees with its reference")
    result["card"] = cs.gpu_line()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
