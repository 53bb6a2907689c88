"""The whole-ray teacher render: rays [N, 3] -> the eight RenderResult fields
of the deterministic coarse + fine eval pass, in one kernel launch.

Port of `efficient_nerf_tpu/ops/pallas/nerf_frame.py::nerf_render_rays_fused`
(:394): coarse field eval -> composite -> inverse CDF -> merge -> fine field
eval -> composite, with nothing between reaching device memory. The kernel is
csrc/nerf_frame.cu; this module holds

  * `nerf_render_rays_fused`: the wrapper. A CUDA tensor launches the kernel
    or raises; a CPU tensor runs the plain version.
    `nerf_render_rays_fused.launches` counts kernel launches;
  * `nerf_render_rays_fused_ref`: the plain version, composed of
    `nerf_forward_fused_ref`, `sample_pdf_det_fused_ref`, the composite of
    `core.volume` and `merge_sorted`;
  * `_np_consts`: the constants of the Pallas wrapper (:379-391). The coarse
    depths, their midpoints (the bins) and the levels are made in numpy f64
    and cast to f32, so they can differ by an ulp from
    `core.sampling.linear_zvals` (XLA's linspace): both versions here use
    these, as the Pallas kernel does.

Divergences from the Pallas kernel, each below its tolerance of 2e-5 at the
JAX package's own test shapes (tests/test_torch_nerf_frame.py):
  * the points are made as o + z d and then embedded, as the composed path
    makes them; the Pallas kernel distributes the embed over the sum (o F +
    z d F), which rounds differently by an ulp of the angle;
  * the transmittance is an exclusive product taken in order within each
    lane's run of samples and by a shuffle scan across the 32 lanes of the
    ray's warp; the Pallas kernel's is another parallel scan
    (`_exclusive_cumprod_lanes`, :101-115), about 1e-6 away;
  * the kernel merges the sorted coarse and fine depths by rank (each
    depth's place is its index plus the count of the other list's depths
    before it, coarse first on a tie) where the Pallas kernel runs a bitonic
    network: the same sorted list.
The Pallas kernel's `diag` switches and its output channels 12-15 are taps
for debugging the TPU kernel's stages and are left out; `taps=True` instead
returns the coarse weights and the fine depths, so that a test can hold the
kernel's inverse CDF against the sampler kernel's. `RenderConfig`'s
`frame_tile_r` and `frame_eval_chunks` tune the Pallas kernel's tiling: the
CUDA kernel chooses its own rays a block, and nothing reads those fields.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ..core.sampling import merge_sorted
from ..core.volume import _composite
from ..device import to_device
from ._build import load_kernels
from .nerf_forward import (_OPERANDS as FIELD_OPERANDS, MAX_SMEM, _check_embed,
                           _check_kernel_operands, embed_dirs, nerf_forward_fused_ref)
from .sample_pdf import sample_pdf_det_fused_ref

__all__ = ["nerf_render_rays_fused", "nerf_render_rays_fused_ref"]

TM = 128          # points a tile of the kernel's field eval
OUT_CH = 12       # rgb(3) disp acc depth rgb0(3) disp0 acc0 z_std

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "nerf_frame_smem_bytes": (_L, (_I,) * 6),
    # (rays_o, rays_d, dirs, zc, bins, u, out, taps_w, taps_z, N, R, S_c,
    #  S_f, white_bkgd, wc, wf, in_ch, in_pad, ev, W, depth, skip_c, skip_f,
    #  stream) -> cudaError_t
    "nerf_frame_launch": (_I, (_P,) * 9 + (_L,) + (_I,) * 4 + (_P, _P) + (_I,) * 7 + (_P,)),
}
_ARCH = ("depth", "width", "half", "in_ch", "in_ch_views")


def _np_consts(near: float, far: float, s_c: int, s_f: int, lindisp: bool):
    """(coarse depths [s_c], bins [s_c - 1], levels [s_f]) in f32, made as the
    Pallas wrapper's `_np_consts` makes them (numpy f64, then f32)."""
    t = np.linspace(0.0, 1.0, s_c)
    if lindisp:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        z = near * (1.0 - t) + far * t
    z = z.astype(np.float32)
    zmid = (0.5 * (z[1:] + z[:-1])).astype(np.float32)
    u = np.linspace(0.0, 1.0, s_f, dtype=np.float32)
    return z, zmid, u


@functools.lru_cache(maxsize=32)
def _consts(near: float, far: float, s_c: int, s_f: int, lindisp: bool,
            device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`_np_consts` on `device`, copied once per (bounds, counts, device)."""
    return tuple(to_device(a, device) for a in _np_consts(near, far, s_c, s_f, lindisp))


def _check(packed_c, packed_f, rays_o, rays_d, viewdirs, n_samples, n_importance, L,
           L_views) -> None:
    for k in _ARCH:
        if packed_f[k] != packed_c[k]:
            raise ValueError(
                f"nerf_render_rays_fused requires matching coarse/fine architectures; "
                f"{k}: coarse={packed_c[k]} fine={packed_f[k]} (the kernel shares one "
                f"field eval body)")
    _check_embed(packed_c, L, L_views)
    N = rays_o.shape[0]
    for name, t in (("rays_o", rays_o), ("rays_d", rays_d), ("viewdirs", viewdirs)):
        if t.dim() != 2 or t.shape != (N, 3):
            raise ValueError(f"nerf_render_rays_fused: {name} must be [N, 3] = [{N}, 3], "
                             f"got {tuple(t.shape)}")
    if n_samples < 3 or n_importance < 1:
        raise ValueError(f"nerf_render_rays_fused: needs at least 3 coarse samples and one "
                         f"fine sample, got {n_samples} and {n_importance}")


def nerf_render_rays_fused_ref(packed_c, packed_f, rays_o: torch.Tensor, rays_d: torch.Tensor,
                               viewdirs: torch.Tensor, near: float, far: float, n_samples: int,
                               n_importance: int, L: int = 10, L_views: int = 4, *,
                               white_bkgd: bool = False, lindisp: bool = False,
                               taps: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain torch version of the kernel, on the rays' device; the same
    arguments and results as `nerf_render_rays_fused`."""
    packed_f = packed_c if packed_f is None else packed_f
    _check(packed_c, packed_f, rays_o, rays_d, viewdirs, n_samples, n_importance, L, L_views)
    z, bins, u = _consts(float(near), float(far), n_samples, n_importance, bool(lindisp),
                         rays_o.device)
    N = rays_o.shape[0]
    o, d = rays_o.float(), rays_d.float()
    normd = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])[:, None]

    def field(packed, zs):
        pts = o[:, None] + d[:, None] * zs[..., None]
        raw = nerf_forward_fused_ref(packed, pts, viewdirs, L, L_views)
        return _composite(torch.sigmoid(raw[..., :3]), raw[..., 3], zs, normd, 0.0,
                          white_bkgd, None, None, rgb_dim=-2)

    z_c = z.expand(N, n_samples)
    coarse = field(packed_c, z_c)
    z_f = sample_pdf_det_fused_ref(bins.expand(N, n_samples - 1), coarse.weights[:, 1:-1],
                                   n_importance, u)
    z_mean = z_f.sum(-1, keepdim=True) / n_importance
    z_std = torch.sqrt(((z_f - z_mean) ** 2).sum(-1) / n_importance)
    fine = field(packed_f, merge_sorted(z_c, z_f))
    out = (fine.rgb, fine.disp, fine.acc, fine.depth, coarse.rgb, coarse.disp, coarse.acc,
           z_std)
    return out + (coarse.weights, z_f) if taps else out


def _rays_per_block(n_samples: int) -> int:
    """Rays a group of the kernel's blocks: an even count whose coarse samples
    fill two tiles (at 64 samples, four rays: 2 coarse and 6 fine tiles a
    group, which spreads a group's glue and its passes' ends over twice the
    rays of one tile's worth)."""
    return max(2, 2 * TM // n_samples // 2 * 2)


def nerf_render_rays_fused(packed_c, packed_f, rays_o: torch.Tensor, rays_d: torch.Tensor,
                           viewdirs: torch.Tensor, near: float, far: float, n_samples: int,
                           n_importance: int, L: int = 10, L_views: int = 4, *,
                           white_bkgd: bool = False, lindisp: bool = False,
                           taps: bool = False) -> Tuple[torch.Tensor, ...]:
    """Deterministic coarse + fine render of a ray batch. rays_o, rays_d,
    viewdirs [N, 3] f32 (viewdirs the unit directions taken before any NDC
    projection); packed_c, packed_f from `pack_nerf_weights` (packed_f None
    renders the fine pass with the coarse weights; the two must have the same
    architecture). Returns (rgb [N, 3], disp [N], acc [N], depth [N], rgb0
    [N, 3], disp0 [N], acc0 [N], z_std [N]), as `render_rays(cfg.eval_mode())`
    with scalar near/far; with taps=True also the coarse weights [N,
    n_samples] and the fine depths [N, n_importance].

    On CUDA tensors this launches csrc/nerf_frame.cu (bf16 weights; the
    wgmma tile of csrc/nerf_wgmma.cuh) or raises; it never falls back. CPU tensors run the plain version
    `nerf_render_rays_fused_ref`.
    """
    pf = packed_c if packed_f is None else packed_f
    _check(packed_c, pf, rays_o, rays_d, viewdirs, n_samples, n_importance, L, L_views)
    if not rays_o.is_cuda:
        return nerf_render_rays_fused_ref(packed_c, packed_f, rays_o, rays_d, viewdirs, near,
                                          far, n_samples, n_importance, L, L_views,
                                          white_bkgd=white_bkgd, lindisp=lindisp, taps=taps)
    dev = rays_o.device
    for name, t in (("rays_o", rays_o), ("rays_d", rays_d), ("viewdirs", viewdirs)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"nerf_render_rays_fused: {name} must be a contiguous float32 "
                             f"tensor on {dev}")
    for which, packed in (("coarse", packed_c), ("fine", pf)):
        _check_kernel_operands(packed, dev, f"nerf_render_rays_fused ({which})")
    W, depth, in_pad = packed_c["width"], packed_c["depth"], packed_c["in_pad"]
    R = _rays_per_block(n_samples)
    lib = load_kernels("nerf_frame", _SIGNATURES)
    smem = lib.nerf_frame_smem_bytes(in_pad, W, depth, R, n_samples, n_importance)
    if smem > MAX_SMEM:
        raise ValueError(f"nerf_render_rays_fused: width {W}, {n_samples} + {n_importance} "
                         f"samples need {smem} B of shared memory per block (at most "
                         f"{MAX_SMEM})")
    N = rays_o.shape[0]
    out = torch.empty((N, OUT_CH), dtype=torch.float32, device=dev)
    taps_w = torch.empty((N, n_samples), dtype=torch.float32, device=dev) if taps else None
    taps_z = torch.empty((N, n_importance), dtype=torch.float32, device=dev) if taps else None
    if N:
        z, bins, u = _consts(float(near), float(far), n_samples, n_importance, bool(lindisp),
                             dev)
        dirs = embed_dirs(viewdirs, L_views)
        weights = [(ctypes.c_void_p * 13)(*[p[k].data_ptr() for k in FIELD_OPERANDS + ("out_b",)])
                   for p in (packed_c, pf)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nerf_frame_launch(
            rays_o.data_ptr(), rays_d.data_ptr(), dirs.data_ptr(), z.data_ptr(),
            bins.data_ptr(), u.data_ptr(), out.data_ptr(),
            None if taps_w is None else taps_w.data_ptr(),
            None if taps_z is None else taps_z.data_ptr(), N, R, n_samples, n_importance,
            int(bool(white_bkgd)), ctypes.cast(weights[0], ctypes.c_void_p),
            ctypes.cast(weights[1], ctypes.c_void_p), packed_c["in_ch"], in_pad,
            packed_c["in_ch_views"], W, depth, packed_c["skip"], pf["skip"], stream)
        if err:
            raise RuntimeError(f"nerf_frame kernel launch failed: CUDA error {err}")
        nerf_render_rays_fused.launches += 1
    res = (out[:, 0:3], out[:, 3], out[:, 4], out[:, 5], out[:, 6:9], out[:, 9], out[:, 10],
           out[:, 11])
    return res + (taps_w, taps_z) if taps else res


nerf_render_rays_fused.launches = 0
