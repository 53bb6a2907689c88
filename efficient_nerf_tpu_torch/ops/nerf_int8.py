"""W8A8 teacher field evaluation: sample points [N, S, 3] and per-ray view
directions [N, 3] -> raw [N, S, 4], with the hidden layers and the feature
head on int8 weights and activations.

Port of `efficient_nerf_tpu/ops/pallas/nerf_int8.py::nerf_forward_int8`
(:210), the `--teacher_quant int8` serving mode of the teacher. The kernel is
csrc/nerf_int8.cu, on the wgmma field tile of csrc/nerf_wgmma.cuh with s8
wgmma for the body and the feature head; this module holds

  * `pack_nerf_weights_int8`: `pack_nerf_weights` plus the body layers 1..D-1
    (layer skip+1's hidden columns only) and the feature head as int8 in
    nn.Linear's [out, in] layout, one f32 scale per output row (row n here is
    column n of the JAX kernel's [in, out] weight), quantized from the f32
    weights; the f32 biases of those layers;
  * `calibrate_nerf_int8`: static activation scales [D] from an f32 forward
    over a sample of points, left on the points' device;
  * `nerf_forward_int8`: the wrapper. A CUDA tensor launches the kernel or
    raises; a CPU tensor runs the plain version.
    `nerf_forward_int8.launches` counts kernel launches;
  * `nerf_forward_int8_ref`: the plain version, which repeats the kernel's
    arithmetic: the embed, layer 0, the skip rows, the view branch and the
    heads as in `nerf_forward_fused_ref`, the int8 products as exact f32
    matmuls of the levels, and the folded epilogues of the Pallas kernel
    (:156-207) in its order.

The folded constants (`_fold`) are made once per call on the device from
act_scales, and the kernel and the plain version consume the same tensors,
so the re-rounded bf16 skip weights are the same bits on both sides. Every
division is a true division on every device.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Mapping

import torch

from ._build import load_kernels
from .nerf_forward import (MAX_DEPTH, MAX_SMEM, MAX_WIDTH, _as_points, _check_embed,
                           _linearized_embed, _plain_keys, embed_dirs, pack_nerf_weights)
from .r2l_int8 import _NoTF32, _quantize_rows

__all__ = ["pack_nerf_weights_int8", "calibrate_nerf_int8", "nerf_forward_int8",
           "nerf_forward_int8_ref", "nerf_int8_ops"]

INT8_ALIGN = 128  # the tile's int8 chunks: 128 input columns (W128 and W256)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "nerf_int8_smem_bytes": (_L, (_I, _I, _I, _I)),
    # (pts, s_pt, s_c, dirs, pts0_w, pts0_b, body_qw, body_dqs, body_b,
    #  skip_x_w, feat_qw, feat_dqs, feat_b, invs, views_h_w, views_d_w,
    #  views_b, rgb_w, alpha_w, out_b, out, o_pt, o_c, P, S, in_ch, in_pad,
    #  ev, W, depth, skip, stream) -> cudaError_t
    "nerf_int8_launch": (_I, (_P, _L, _L) + (_P,) * 18 + (_L, _L, _L) + (_I,) * 7 + (_P,)),
}
# packed operand -> dtype the kernel takes
_OPERANDS = {"pts0_w": torch.bfloat16, "pts0_b": torch.bfloat16, "body_qw": torch.int8,
             "feat_qw": torch.int8, "views_h_w": torch.bfloat16, "views_d_w": torch.bfloat16,
             "views_b": torch.bfloat16, "rgb_w": torch.bfloat16, "alpha_w": torch.bfloat16,
             "out_b": torch.float32, "body_sw": torch.float32, "feat_sw": torch.float32,
             "body_b_f32": torch.float32, "feat_b_f32": torch.float32,
             "skip_x_w": torch.bfloat16}


def pack_nerf_weights_int8(state_dict: Mapping[str, torch.Tensor], skip: int = 4,
                           dtype: torch.dtype = torch.bfloat16) -> Dict[str, object]:
    """NeRFMLP state_dict -> the int8 kernel's operands, on the state_dict's
    device: `pack_nerf_weights(state_dict, skip, dtype)` without body_w and
    feat_w, plus body_qw [D-1, W, W] int8 with body_sw [D-1, W] f32, feat_qw
    [W, W] int8 with feat_sw [W] f32 (`_quantize_cols`, :50-55: scale =
    max(max |row|, 1e-12) / 127, levels round half to even, clipped at 127),
    and the f32 biases body_b_f32 [D-1, W] and feat_b_f32 [W]."""
    packed = pack_nerf_weights(state_dict, skip=skip, dtype=dtype)
    sd = _plain_keys(state_dict)
    in_ch, depth = packed["in_ch"], packed["depth"]
    ws = []
    for i in range(1, depth):
        w = sd[f"pts_linears.{i}.weight"].float()
        ws.append(w[:, in_ch:] if i == skip + 1 else w)   # skip rows stay bf16
    packed["body_qw"], packed["body_sw"] = (t.contiguous() for t in _quantize_rows(
        torch.stack(ws)))
    packed["feat_qw"], packed["feat_sw"] = (t.contiguous() for t in _quantize_rows(
        sd["feature_linear.weight"].float()))
    packed["body_b_f32"] = torch.stack(
        [sd[f"pts_linears.{i}.bias"].float() for i in range(1, depth)]).contiguous()
    packed["feat_b_f32"] = sd["feature_linear.bias"].float().contiguous()
    del packed["body_w"], packed["feat_w"]
    return packed


def calibrate_nerf_int8(packed_or_sd: Mapping[str, object], pts_flat: torch.Tensor, L: int = 10,
                        skip: int = 4, margin: float = 1.02) -> torch.Tensor:
    """Static activation scales for the int8 field eval, as the JAX package's
    `calibrate_nerf_int8` (:78-107) makes them: an f32 forward (the
    linearized embed, f32 matmuls with TF32 off) over the points pts_flat
    [k, 3] records the largest |input| of each hidden layer 1..D-1 and of the
    feature head. Returns [D] f32 (= max * margin / 127) on the points'
    device, with no copy to the host.

    Takes a NeRFMLP state_dict or a `pack_nerf_weights(..., dtype=
    torch.float32)` pack (whose skip it uses): the scales come from the f32
    weights."""
    packed = packed_or_sd
    if "pts0_w" not in packed:
        packed = pack_nerf_weights(packed, skip=skip, dtype=torch.float32)
    if packed["pts0_w"].dtype != torch.float32:
        raise ValueError("calibrate_nerf_int8: the scales come from f32 weights; pass the "
                         "state_dict or a pack made with dtype=torch.float32")
    ic, skip = packed["in_ch"], packed["skip"]
    dev = pts_flat.device
    with _NoTF32():
        x = _linearized_embed(pts_flat.float(), L)
        h = torch.relu(x @ packed["pts0_w"][:, :ic].to(dev).t() + packed["pts0_b"].to(dev))
        maxes = []
        for i in range(1, packed["depth"]):
            maxes.append(h.abs().amax())
            w, b = packed["body_w"][i - 1].to(dev), packed["body_b"][i - 1].to(dev)
            if i == skip + 1:
                g = x @ packed["skip_x_w"][:, :ic].to(dev).t() + h @ w.t() + b
            else:
                g = h @ w.t() + b
            h = torch.relu(g)
        maxes.append(h.abs().amax())                      # the feature input
    return torch.stack(maxes) * (margin / 127.0)


def _fold(packed, act_scales: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The kernel's per-call constants, on act_scales' device (the Pallas
    wrapper's :243-259): the next layer's inverse scale folded into the
    dequantization scales, the biases and the skip rows of every body layer
    but the last; `invs` = (1 / s[0], 1 / s[D-1])."""
    act = act_scales.float()
    depth, skip = packed["depth"], packed["skip"]
    inv = 1.0 / act
    fold = torch.cat([inv[1:depth - 1], inv.new_ones(1)])        # [D-1]
    dt = packed["skip_x_w"].dtype
    return {
        "body_dqs": (act[:-1, None] * packed["body_sw"] * fold[:, None]).contiguous(),
        "body_b": (packed["body_b_f32"] * fold[:, None]).contiguous(),
        "skip_x_w": (packed["skip_x_w"].float() * fold[skip]).to(dt).contiguous(),
        "feat_dqs": (act[-1] * packed["feat_sw"]).contiguous(),
        "invs": torch.stack([inv[0], inv[-1]]).contiguous(),
    }


def nerf_int8_ops(packed: Mapping[str, object], n_points: int, n_rays: int):
    """(int8 operations, bf16 operations) of one field eval, 2 a
    multiply-add, at the unpadded widths: per point the int8 body and feature
    head, and the bf16 layer 0, skip rows, alpha head, view layer and rgb
    head; per ray the view directions' rows of the view layer."""
    W, half, ic = packed["width"], packed["half"], packed["in_ch"]
    int8 = 2 * n_points * (packed["depth"] - 1 + 1) * W * W
    bf16 = 2 * (n_points * (2 * ic * W + W + W * half + half * 3)
                + n_rays * packed["in_ch_views"] * half)
    return int8, bf16


def _levels(x: torch.Tensor) -> torch.Tensor:
    """clip(round(x), -127, 127) as f32 (`_qstatic`, :110, before its cast)."""
    return torch.clamp(torch.round(x), -127, 127)


def _check_scales(packed, act_scales) -> None:
    if act_scales is None:
        raise ValueError("nerf_forward_int8 requires act_scales (calibrate_nerf_int8)")
    if act_scales.shape != (packed["depth"],):
        raise ValueError(f"nerf_forward_int8: act_scales must be [{packed['depth']}], got "
                         f"{tuple(act_scales.shape)}")


def nerf_forward_int8_ref(packed, pts: torch.Tensor, viewdirs: torch.Tensor, L: int = 10,
                          L_views: int = 4, *, act_scales: torch.Tensor,
                          cm: bool = False) -> torch.Tensor:
    """Plain torch version of the kernel, on the points' device: the same
    arithmetic, each bf16 product as `matmul(a.to(dtype).float(),
    w.float().t())` and each int8 product as an exact f32 matmul of the
    levels, TF32 off."""
    _check_scales(packed, act_scales)
    _check_embed(packed, L, L_views)
    N, S = _as_points(pts, cm)
    x = (pts.reshape(3, -1).t() if cm else pts.reshape(-1, 3)).float()
    dt = packed["pts0_w"].dtype
    ic, depth, skip = packed["in_ch"], packed["depth"], packed["skip"]
    k = _fold(packed, act_scales)

    def mm(a, w):  # a @ w.T, w in nn.Linear's [out, in] layout
        return torch.matmul(a.to(dt).float(), w.float().t())

    def imm(q, qw):  # levels @ int8 weights, exact in f32
        return torch.matmul(q, qw.float().t())

    with _NoTF32():
        e = _linearized_embed(x, L)
        h = torch.relu(mm(e, packed["pts0_w"][:, :ic]) + packed["pts0_b"].float())
        q = _levels(h * k["invs"][0])
        for i in range(1, depth):
            t = imm(q, packed["body_qw"][i - 1]) * k["body_dqs"][i - 1] + k["body_b"][i - 1]
            if i == skip + 1:
                t = t + mm(e, k["skip_x_w"][:, :ic])
            if i < depth - 1:
                q = _levels(torch.relu(t))
            else:
                h = torch.relu(t)
        alpha = mm(h, packed["alpha_w"][None])
        feat = (imm(_levels(h * k["invs"][1]), packed["feat_qw"]) * k["feat_dqs"]
                + packed["feat_b_f32"]).to(dt)
        hv_d = mm(embed_dirs(viewdirs, L_views), packed["views_d_w"])
        hv = mm(feat, packed["views_h_w"]) + hv_d.repeat_interleave(S, dim=0)
        hv = torch.relu(hv + packed["views_b"].float())
        rgb = mm(hv, packed["rgb_w"])
        out_b = packed["out_b"]
        raw = torch.cat([rgb + out_b[:3], alpha + out_b[3:]], dim=-1)
    return raw.t().reshape(4, N, S) if cm else raw.reshape(N, S, 4)


def nerf_forward_int8(packed, pts: torch.Tensor, viewdirs: torch.Tensor, L: int = 10,
                      L_views: int = 4, *, act_scales: torch.Tensor,
                      cm: bool = False) -> torch.Tensor:
    """Int8-body teacher field evaluation. pts [N, S, 3] f32 (or [3, N, S]
    with cm), viewdirs [N, 3] f32 unit directions, one per ray -> raw [N, S,
    4] f32 (or [4, N, S] with cm). `packed` comes from
    `pack_nerf_weights_int8`, act_scales [D] f32 from `calibrate_nerf_int8`
    (required: the static scales are the mode).

    On CUDA tensors this launches csrc/nerf_int8.cu (int8 body and feature
    head, bf16 elsewhere) or raises; it never falls back. CPU tensors run the
    plain version `nerf_forward_int8_ref`.
    """
    _check_scales(packed, act_scales)
    _check_embed(packed, L, L_views)
    N, S = _as_points(pts, cm)
    if viewdirs.shape != (N, 3):
        raise ValueError(f"nerf_forward_int8: viewdirs must be [N, 3] = [{N}, 3], got "
                         f"{tuple(viewdirs.shape)}")
    if not pts.is_cuda:
        return nerf_forward_int8_ref(packed, pts, viewdirs, L, L_views,
                                     act_scales=act_scales, cm=cm)
    dev = pts.device
    for name, t in (("pts", pts), ("viewdirs", viewdirs), ("act_scales", act_scales)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"nerf_forward_int8: {name} must be a contiguous float32 "
                             f"tensor on {dev}")
    for name, want in _OPERANDS.items():
        t = packed[name]
        if t.dtype != want or t.device != dev or not t.is_contiguous():
            raise ValueError(f"nerf_forward_int8: packed {name} must be a contiguous {want} "
                             f"tensor on {dev} (pack_nerf_weights_int8 with "
                             f"dtype=torch.bfloat16)")
    W, half, depth = packed["width"], packed["half"], packed["depth"]
    ic, ev, in_pad = packed["in_ch"], packed["in_ch_views"], packed["in_pad"]
    if W % INT8_ALIGN or W > MAX_WIDTH or half * 2 != W or depth > MAX_DEPTH \
            or packed["body_qw"].shape != (depth - 1, W, W) \
            or packed["feat_qw"].shape != (W, W) \
            or packed["pts0_w"].shape != (W, in_pad) \
            or packed["skip_x_w"].shape != (W, in_pad) \
            or packed["views_h_w"].shape != (half, W) \
            or packed["views_d_w"].shape != (half, ev):
        raise ValueError(f"nerf_forward_int8: width {W} must be a multiple of {INT8_ALIGN} "
                         f"up to {MAX_WIDTH} with a view layer of W/2, depth at most "
                         f"{MAX_DEPTH}, with the shapes pack_nerf_weights_int8 gives")
    lib = load_kernels("nerf_int8", _SIGNATURES)
    smem = lib.nerf_int8_smem_bytes(in_pad, W, depth, S)
    if smem > MAX_SMEM:
        raise ValueError(f"nerf_forward_int8: width {W}, input {in_pad}, S={S} needs {smem} B "
                         f"of shared memory per block (at most {MAX_SMEM})")
    P = N * S
    out = torch.empty((4, N, S) if cm else (N, S, 4), dtype=torch.float32, device=dev)
    if P == 0:
        return out
    k = _fold(packed, act_scales)
    dirs = embed_dirs(viewdirs, L_views)
    s_pt, s_c = (1, P) if cm else (3, 1)
    o_pt, o_c = (1, P) if cm else (4, 1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.nerf_int8_launch(
        pts.data_ptr(), s_pt, s_c, dirs.data_ptr(),
        packed["pts0_w"].data_ptr(), packed["pts0_b"].data_ptr(),
        packed["body_qw"].data_ptr(), k["body_dqs"].data_ptr(), k["body_b"].data_ptr(),
        k["skip_x_w"].data_ptr(), packed["feat_qw"].data_ptr(), k["feat_dqs"].data_ptr(),
        packed["feat_b_f32"].data_ptr(), k["invs"].data_ptr(),
        *(packed[n].data_ptr() for n in ("views_h_w", "views_d_w", "views_b", "rgb_w",
                                         "alpha_w", "out_b")),
        out.data_ptr(), o_pt, o_c, P, S, ic, in_pad, ev, W, depth, packed["skip"], stream)
    if err:
        raise RuntimeError(f"nerf_int8 kernel launch failed: CUDA error {err}")
    nerf_forward_int8.launches += 1
    return out


nerf_forward_int8.launches = 0
