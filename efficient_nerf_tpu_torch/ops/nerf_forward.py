"""Fused teacher field evaluation: sample points [N, S, 3] and per-ray view
directions [N, 3] -> raw [N, S, 4] (pre-sigmoid rgb, pre-relu sigma).

Port of `efficient_nerf_tpu/ops/pallas/nerf_forward.py::nerf_forward_fused`
(:314) for the reference teacher profile (depth D, one input skip, the viewdir
branch). The kernel is csrc/nerf_forward.cu; this module holds

  * `pack_nerf_weights`: a `NeRFMLP` state_dict as the kernel's operands, in
    nn.Linear's [out, in] layout: the post-skip layer split into its
    embed columns (`skip_x_w`) and hidden columns, the view layer into its
    feature and direction columns, the embed columns zero-padded to a
    multiple of 64; inner biases rounded to the compute dtype as the Pallas
    pack rounds them (:111-114), out_b in f32;
  * `nerf_embed_constants`: the linearized embed, F [3, E], phase [E] and
    the identity flags [E] as numpy arrays (a copy of the Pallas module's
    `_nerf_embed_constants_np`, :57);
  * `nerf_forward_fused`: the wrapper. A CUDA tensor launches the kernel or
    raises; a CPU tensor runs the plain version.
    `nerf_forward_fused.launches` counts kernel launches;
  * `nerf_forward_fused_ref`: the plain version, which repeats the kernel's
    arithmetic in torch: the phased `fast_sin` embed in exact f32, matmuls on
    `dtype` operands with f32 sums, the skip as two products, feat rounded
    to the dtype, the view contribution once per ray.

The view directions are embedded here, elementwise in torch with the same
math as the points (`embed_dirs`; a matmul could run in TF32 on the card).
The TPU layout of the Pallas kernel (channel-major points and raw, the
128-lane output projection, VMEM-resident weights) is not carried over;
`cm=True` keeps its channel-major interface.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..device import to_device
from ._build import load_kernels
from .trig import fast_sin

__all__ = ["pack_nerf_weights", "nerf_embed_constants", "nerf_forward_fused",
           "nerf_forward_fused_ref", "nerf_forward_flops", "embed_dirs"]

MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90
IN_ALIGN = 64      # the kernel streams weights in chunks of 64 input columns
WIDTH_ALIGN = 64   # the tile's widths: 64, 128, 192, 256 (each a wgmma N, as is W/2)
MAX_WIDTH = 256    # the widest wgmma N
MAX_DEPTH = 13     # the tile's nw::MAX_DEPTH

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "nerf_forward_smem_bytes": (_L, (_I, _I, _I, _I)),
    # (pts, s_pt, s_c, dirs, pts0_w, pts0_b, body_w, body_b, skip_x_w, feat_w,
    #  feat_b, views_h_w, views_d_w, views_b, rgb_w, alpha_w, out_b, out,
    #  o_pt, o_c, P, S, in_ch, in_pad, ev, W, depth, skip, stream)
    "nerf_forward_launch": (_I, (_P, _L, _L) + (_P,) * 15 + (_L, _L, _L)
                            + (_I,) * 7 + (_P,)),
}
_OPERANDS = ("pts0_w", "pts0_b", "body_w", "body_b", "skip_x_w", "feat_w",
             "feat_b", "views_h_w", "views_d_w", "views_b", "rgb_w", "alpha_w")


@functools.lru_cache(maxsize=8)
def nerf_embed_constants(L: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Linearized nerf_embed for d = 3: F [3, E], phase [E], identity [E].

    Layout [x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...], f_l = 2^l,
    each group 3 wide; the cos columns are sin columns with a +pi/2 phase.
    """
    E = 3 * (2 * L + 1)
    F = np.zeros((3, E))
    phase = np.zeros((E,), np.float32)
    is_id = np.zeros((E,), np.int32)
    for c in range(3):
        F[c, c] = 1.0
        is_id[c] = 1
    for l in range(L):
        f = 2.0 ** l
        for c in range(3):
            F[c, 3 + 6 * l + c] = f
            F[c, 3 + 6 * l + 3 + c] = f
            phase[3 + 6 * l + 3 + c] = np.pi / 2
    F = F.astype(np.float32)
    for a in (F, phase, is_id):
        a.setflags(write=False)  # shared by every caller through the cache
    return F, phase, is_id


@functools.lru_cache(maxsize=8)
def _embed_columns(L: int, device: torch.device):
    """Per embed column: its coordinate, frequency, phase and identity flag
    on `device`, made once per device (every launch embeds directions)."""
    F, phase, is_id = nerf_embed_constants(L)
    col = np.arange(F.shape[1]) % 3
    return (to_device(col, device, torch.int64), to_device(F.sum(0), device),
            to_device(phase.copy(), device), to_device(is_id != 0, device, torch.bool))


def _linearized_embed(x: torch.Tensor, L: int) -> torch.Tensor:
    """x [..., 3] f32 -> [..., 3(2L+1)]: y = x[c] 2^l exact in f32 (one
    nonzero of F a column, applied elementwise), then fast_sin(y + phase)
    (degree 7) outside the identity columns, as the kernel computes it."""
    col, freq, phase, is_id = _embed_columns(L, x.device)
    y = x[..., col] * freq
    return torch.where(is_id, y, fast_sin(y + phase, 7))


def embed_dirs(viewdirs: torch.Tensor, L_views: int) -> torch.Tensor:
    """Per-ray embedded view directions [N, 3(2 L_views + 1)] f32, the
    kernel's input (the Pallas wrapper's `dirs_emb`, :365)."""
    return _linearized_embed(viewdirs.float(), L_views).contiguous()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _plain_keys(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The state_dict's tensors, detached, under keys without a DataParallel
    `module.` prefix."""
    return {k[len("module."):] if k.startswith("module.") else k: v.detach()
            for k, v in state_dict.items()}


def pack_nerf_weights(state_dict: Mapping[str, torch.Tensor], skip: int = 4,
                      dtype: torch.dtype = torch.bfloat16) -> Dict[str, object]:
    """NeRFMLP state_dict (reference key layout, viewdir branch) -> the
    kernel's operands, on the state_dict's device.

    Weights in `dtype`, nn.Linear's [out, in] layout: pts0_w and skip_x_w
    [W, in_pad] (zero columns past in_ch), body_w [D-1, W, W] (layer skip+1's
    hidden columns), feat_w [W, W], views_h_w [W/2, W], views_d_w [W/2, ev],
    rgb_w [3, W/2], alpha_w [W]. Biases pts0_b [W], body_b [D-1, W], feat_b
    [W], views_b [W/2] in `dtype`; out_b [4] f32 (rgb, then alpha). Also
    depth, skip, width, half, in_ch, in_ch_views (ev) and in_pad.
    """
    sd = _plain_keys(state_dict)
    if "views_linears.0.weight" not in sd:
        raise ValueError("pack_nerf_weights: the fused field eval covers the "
                         "viewdir teacher (no 'views_linears.0' in state_dict)")
    depth = 0
    while f"pts_linears.{depth}.weight" in sd:
        depth += 1
    w0 = sd["pts_linears.0.weight"]
    width, in_ch = w0.shape
    if not 0 <= skip < depth - 1 or sd[f"pts_linears.{skip + 1}.weight"].shape[1] \
            != width + in_ch:
        raise ValueError(f"pack_nerf_weights: no input skip after layer {skip} "
                         f"of a depth-{depth} model")
    vw = sd["views_linears.0.weight"]                   # [half, W + ev]
    half = vw.shape[0]
    in_pad = _round_up(in_ch, IN_ALIGN)

    def pad_cols(w):
        out = torch.zeros((w.shape[0], in_pad), dtype=dtype, device=w.device)
        out[:, :in_ch] = w.to(dtype)
        return out

    body_w, body_b = [], []
    skip_x = torch.zeros((width, in_ch), device=w0.device)
    for i in range(1, depth):
        w = sd[f"pts_linears.{i}.weight"]
        if i == skip + 1:
            skip_x, w = w[:, :in_ch], w[:, in_ch:]
        body_w.append(w)
        body_b.append(sd[f"pts_linears.{i}.bias"])
    out_b = torch.cat([sd["rgb_linear.bias"], sd["alpha_linear.bias"]]).float()
    return {
        "pts0_w": pad_cols(w0), "pts0_b": sd["pts_linears.0.bias"].to(dtype),
        "body_w": torch.stack(body_w).to(dtype).contiguous(),
        "body_b": torch.stack(body_b).to(dtype).contiguous(),
        "skip_x_w": pad_cols(skip_x),
        "feat_w": sd["feature_linear.weight"].to(dtype).contiguous(),
        "feat_b": sd["feature_linear.bias"].to(dtype).contiguous(),
        "views_h_w": vw[:, :width].to(dtype).contiguous(),
        "views_d_w": vw[:, width:].to(dtype).contiguous(),
        "views_b": sd["views_linears.0.bias"].to(dtype).contiguous(),
        "rgb_w": sd["rgb_linear.weight"].to(dtype).contiguous(),
        "alpha_w": sd["alpha_linear.weight"][0].to(dtype).contiguous(),
        "out_b": out_b.contiguous(),
        "depth": depth, "skip": skip, "width": width, "half": half,
        "in_ch": in_ch, "in_ch_views": vw.shape[1] - width, "in_pad": in_pad,
    }


def nerf_forward_flops(packed: Mapping[str, object], n_points: int,
                       n_rays: int) -> int:
    """Operations of one field eval (2 per multiply-add, products only, at
    the unpadded widths): per point the MLP and heads, per ray the view
    directions' rows of the view layer."""
    W, half, ic = packed["width"], packed["half"], packed["in_ch"]
    per_point = (2 * ic * W + (packed["depth"] - 1) * W * W + W + W * W
                 + W * half + half * 3)
    return 2 * (n_points * per_point + n_rays * packed["in_ch_views"] * half)


def _check_embed(packed, L: int, L_views: int) -> None:
    if (packed["in_ch"], packed["in_ch_views"]) != (3 * (2 * L + 1),
                                                    3 * (2 * L_views + 1)):
        raise ValueError(
            f"weights embed {packed['in_ch']} and {packed['in_ch_views']} "
            f"columns; called with L={L}, L_views={L_views}")


def _as_points(pts: torch.Tensor, cm: bool):
    """(N, S) of [N, S, 3] points, or of [3, N, S] with cm."""
    if pts.dim() != 3 or pts.shape[0 if cm else 2] != 3:
        raise ValueError("nerf_forward_fused: pts must be [3, N, S] (cm) or "
                         f"[N, S, 3], got {tuple(pts.shape)}")
    return (pts.shape[1], pts.shape[2]) if cm else (pts.shape[0], pts.shape[1])


def _check_kernel_operands(packed, dev: torch.device, who: str) -> None:
    """Raises unless `packed` holds what the bf16 field kernels take
    (`pack_nerf_weights` with dtype bf16) on `dev`."""
    for name in _OPERANDS:
        t = packed[name]
        if t.dtype != torch.bfloat16 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{who}: packed {name} must be a contiguous bfloat16 tensor "
                             f"on {dev} (pack with dtype=torch.bfloat16)")
    ob = packed["out_b"]
    if ob.dtype != torch.float32 or ob.device != dev or ob.shape != (4,):
        raise ValueError(f"{who}: packed out_b must be float32 [4] on {dev}")
    W, half, depth = packed["width"], packed["half"], packed["depth"]
    ev, in_pad = packed["in_ch_views"], packed["in_pad"]
    if W % WIDTH_ALIGN or W > MAX_WIDTH or half * 2 != W or in_pad % IN_ALIGN \
            or depth > MAX_DEPTH \
            or packed["pts0_w"].shape != (W, in_pad) \
            or packed["skip_x_w"].shape != (W, in_pad) \
            or packed["body_w"].shape != (depth - 1, W, W) \
            or packed["body_b"].shape != (depth - 1, W) \
            or packed["views_h_w"].shape != (half, W) \
            or packed["views_d_w"].shape != (half, ev) \
            or packed["rgb_w"].shape != (3, half) \
            or packed["alpha_w"].shape != (W,):
        raise ValueError(f"{who}: width {W} must be a multiple of {WIDTH_ALIGN} up to "
                         f"{MAX_WIDTH} with a view layer of W/2, depth at most {MAX_DEPTH}, "
                         f"with the shapes pack_nerf_weights gives")


def nerf_forward_fused_ref(packed, pts: torch.Tensor, viewdirs: torch.Tensor,
                           L: int = 10, L_views: int = 4, *,
                           cm: bool = False) -> torch.Tensor:
    """Plain torch version of the kernel, on the points' device: the same
    arithmetic, each product as `matmul(a.to(dtype).float(), w.float().t())`
    (operands rounded to the packed dtype, f32 sums) with TF32 off."""
    _check_embed(packed, L, L_views)
    N, S = _as_points(pts, cm)
    x = (pts.reshape(3, -1).t() if cm else pts.reshape(-1, 3)).float()
    dt = packed["pts0_w"].dtype
    ic = packed["in_ch"]

    def mm(a, w):  # a @ w.T, w in nn.Linear's [out, in] layout
        return torch.matmul(a.to(dt).float(), w.float().t())

    def bias(b):
        return b.float()

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        e = _linearized_embed(x, L)                     # [P, in_ch] f32
        h = torch.relu(mm(e, packed["pts0_w"][:, :ic]) + bias(packed["pts0_b"]))
        for i in range(1, packed["depth"]):
            g = mm(h, packed["body_w"][i - 1])
            if i == packed["skip"] + 1:
                g = g + mm(e, packed["skip_x_w"][:, :ic])
            h = torch.relu(g + bias(packed["body_b"][i - 1]))
        alpha = mm(h, packed["alpha_w"][None])          # [P, 1]
        feat = (mm(h, packed["feat_w"]) + bias(packed["feat_b"])).to(dt)
        hv_d = mm(embed_dirs(viewdirs, L_views), packed["views_d_w"])  # [N, half]
        hv = mm(feat, packed["views_h_w"]) + hv_d.repeat_interleave(S, dim=0)
        hv = torch.relu(hv + bias(packed["views_b"]))
        rgb = mm(hv, packed["rgb_w"])                   # [P, 3]
        out_b = packed["out_b"]
        raw = torch.cat([rgb + out_b[:3], alpha + out_b[3:]], dim=-1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return raw.t().reshape(4, N, S) if cm else raw.reshape(N, S, 4)


def nerf_forward_fused(packed, pts: torch.Tensor, viewdirs: torch.Tensor,
                       L: int = 10, L_views: int = 4, *,
                       cm: bool = False) -> torch.Tensor:
    """Fused teacher field evaluation. pts [N, S, 3] f32 (or [3, N, S] with
    cm), viewdirs [N, 3] f32 unit directions, one per ray -> raw [N, S, 4]
    f32 (or [4, N, S] with cm). `packed` comes from `pack_nerf_weights`.

    On CUDA tensors this launches csrc/nerf_forward.cu (bf16 weights, f32
    sums; the wgmma tile of csrc/nerf_wgmma.cuh) or raises; it never falls
    back. CPU tensors run the plain version `nerf_forward_fused_ref`.
    """
    _check_embed(packed, L, L_views)
    N, S = _as_points(pts, cm)
    if viewdirs.shape != (N, 3):
        raise ValueError(f"nerf_forward_fused: viewdirs must be [N, 3] = "
                         f"[{N}, 3], got {tuple(viewdirs.shape)}")
    if not pts.is_cuda:
        return nerf_forward_fused_ref(packed, pts, viewdirs, L, L_views, cm=cm)
    dev = pts.device
    for name, t in (("pts", pts), ("viewdirs", viewdirs)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"nerf_forward_fused: {name} must be a contiguous "
                             f"float32 tensor on {dev}")
    _check_kernel_operands(packed, dev, "nerf_forward_fused")
    W, depth, ob = packed["width"], packed["depth"], packed["out_b"]
    ic, ev, in_pad = packed["in_ch"], packed["in_ch_views"], packed["in_pad"]
    lib = load_kernels("nerf_forward", _SIGNATURES)
    smem = lib.nerf_forward_smem_bytes(in_pad, W, depth, S)
    if smem > MAX_SMEM:
        raise ValueError(f"nerf_forward_fused: width {W}, input {in_pad}, S={S} "
                         f"needs {smem} B of shared memory per block (at most "
                         f"{MAX_SMEM})")

    P = N * S
    out = torch.empty((4, N, S) if cm else (N, S, 4), dtype=torch.float32, device=dev)
    if P == 0:
        return out
    dirs = embed_dirs(viewdirs, L_views)
    s_pt, s_c = (1, P) if cm else (3, 1)
    o_pt, o_c = (1, P) if cm else (4, 1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.nerf_forward_launch(
        pts.data_ptr(), s_pt, s_c, dirs.data_ptr(),
        *(packed[k].data_ptr() for k in _OPERANDS), ob.data_ptr(),
        out.data_ptr(), o_pt, o_c, P, S, ic, in_pad, ev, W, depth,
        packed["skip"], stream)
    if err:
        raise RuntimeError(f"nerf_forward kernel launch failed: CUDA error {err}")
    nerf_forward_fused.launches += 1
    return out


nerf_forward_fused.launches = 0
