"""Fused R2L training forward and backward behind a `torch.autograd.Function`.

Port of `efficient_nerf_tpu/ops/pallas/r2l_train.py::r2l_train_apply`
(:397): `_fwd_kernel` (:85) and `_bwd_kernel` (:115) behind the custom VJP
`_apply` (:348, `_apply_fwd` :355, `_apply_bwd` :361). The forward kernel is
csrc/r2l_train.cu's, on the wgmma tile of csrc/r2l_wgmma.cuh that the
serving forward shares; the backward runs in two passes, the activation chain
(csrc/r2l_train.cu) and the weight gradients (csrc/r2l_wgrad.cu), which
sums over the rays what the TPU grid summed tile by tile. This module holds

  * `pack_r2l_train_weights`: the operands, from the live parameters on every
    call, as `_pack` does (:233-244): nn.Linear's [out, in] layout in the
    compute dtype, the head's input columns permuted into the doubling
    embed's block order when `embed_L > 0` and zero padded to a multiple of
    64; f32 biases. No 128-lane tail padding: `out_dim` is 3 or 4;
  * `r2l_train_fwd`, `r2l_train_bwd_act` (pass 1) and `r2l_train_wgrad`
    (pass 2): the kernels' wrappers. A CUDA tensor launches the kernel or
    raises; a CPU tensor runs the plain version. Each counts its launches in
    `.launches`, and `r2l_train_fwd.panel_launches` those of the forward
    tile's per-panel instantiation (`r2l_forward.tile_kind`);
  * `r2l_train_bwd`: the whole backward, both passes over ray chunks of at
    most `RAY_CAP` rays, each chunk's gradients added in order;
  * `r2l_train_fwd_ref`, `r2l_train_bwd_act_ref`, `r2l_train_wgrad_ref`: the
    plain versions, which repeat the kernels' arithmetic and roundings in
    torch (products as `matmul(a.to(dtype).float(), w.float()...)` with TF32
    off), and `r2l_train_bwd_ref`, the plain whole backward (pass 1's plain
    version, then pass 2's);
  * `R2LTrainFunction` and `r2l_train_apply(model, x)`: the differentiable
    apply. Gradients come back in f32; the body's are views into the
    kernel's stacked gradient buffer, the head's are scattered back through
    the inverse permutation (:368-376).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ._build import load_kernels
from ..device import to_device
from ..utils.profiling import span
from .r2l_forward import _doubling_head_perm_np, doubling_embed, doubling_sincos, tile_kind

__all__ = ["pack_r2l_train_weights", "r2l_train_fwd", "r2l_train_bwd",
           "r2l_train_bwd_act", "r2l_train_wgrad", "r2l_train_fwd_ref",
           "r2l_train_bwd_ref", "r2l_train_bwd_act_ref", "r2l_train_wgrad_ref",
           "R2LTrainFunction", "r2l_train_apply", "r2l_train_flops",
           "r2l_train_pass_flops", "train_profile_eligible", "RAY_CAP"]

MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90
IN_ALIGN = 64      # the kernels stream weights in chunks of 64 rows
WIDTH_ALIGN = 64   # ... and the width is a contraction length too
MAX_WIDTH = 256    # the backward's two warpgroups of 128 output columns
MAX_OUT = 4        # rgb, or rgb + depth
TILE = 64          # rays a block of the backward's pass 1 (a row of `part`)
# Rays a pair of backward passes takes at most: pass 1's scratch is 3 bf16
# [n_block, B, W] operand stacks plus the embed, 8.9 GB at W256 D88 and
# 131,072 rays. A larger batch runs both passes on chunks of RAY_CAP rays.
RAY_CAP = 131072

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "r2l_train_fwd_smem_bytes": (ctypes.c_longlong, (_I, _I)),
    "r2l_train_fwd_tile_kind": (_I, (_I, _I)),
    "r2l_train_bwd_smem_bytes": (ctypes.c_longlong, (_I, _I)),
    # (x, head_w, head_b, body_w, body_b, tail_w, tail_b, out, hs, B, x_cols,
    #  embed_L, in_pad, W, n_block, out_dim, res_scale, global_residual,
    #  stream) -> cudaError_t
    "r2l_train_fwd_launch": (_I, (_P,) * 9 + (_I,) * 7 + (_F, _I, _P)),
    # (x, hs, dout, head_w, head_b, body_w, body_b, tail_w, tail_b, body_wt,
    #  dg2, dg1, g1, dpre, emb, part, dx, B, hs_rows, x_cols, embed_L, in_pad,
    #  W, n_block, out_dim, res_scale, global_residual, stream) -> cudaError_t
    "r2l_train_bwd_launch": (_I, (_P,) * 17 + (_I,) * 8 + (_F, _I, _P)),
    "r2l_train_bwd_stages": (_I, (_I,)),
}
_WGRAD_SIGNATURES = {
    # (n_rt, W, in_pad, n_block) -> floats of workspace
    "r2l_wgrad_work_floats": (ctypes.c_longlong, (_I,) * 4),
    # (dg2, dg1, g1, hs, dpre, emb, part, work, 6 grads, n_rt, B, hs_rows, W,
    #  in_pad, n_block, out_dim, accumulate, stream) -> cudaError_t
    "r2l_wgrad_launch": (_I, (_P,) * 14 + (_I,) * 8 + (_P,)),
}
_OPERANDS = ("head_w", "head_b", "body_w", "body_b", "tail_w", "tail_b")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _perm(in_dim: int, embed_L: int) -> Optional[np.ndarray]:
    """The doubling row order of the head's input for embed_L > 0 (None for
    embed_L = 0)."""
    if not embed_L:
        return None
    K, rem = divmod(in_dim, 2 * embed_L + 1)
    if rem or K % 3:
        raise ValueError(f"embed_L={embed_L}: head input {in_dim} is not "
                         "K*(2L+1) with K a multiple of 3")
    return _doubling_head_perm_np(K // 3, embed_L)


@functools.lru_cache(maxsize=8)
def _head_perm_index(in_dim: int, embed_L: int, device: torch.device
                     ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(perm, inv): `_perm` and its inverse argsort(perm) as int64 index
    tensors on `device` (None for embed_L = 0), built on the host and copied
    once per (in_dim, embed_L, device) through pinned memory: the forward's
    pack and the backward ask for them every step, and a copy from pageable
    memory would wait for the work queued on the stream. Tensors shared by
    the callers: do not write into them. `.builds` counts the host builds."""
    perm = _perm(in_dim, embed_L)
    if perm is None:
        return None
    _head_perm_index.builds += 1
    return (to_device(perm.copy(), device, torch.int64),
            to_device(np.argsort(perm), device, torch.int64))


_head_perm_index.builds = 0


def pack_r2l_train_weights(params: Sequence[torch.Tensor], embed_L: int = 0,
                           dtype: torch.dtype = torch.bfloat16
                           ) -> Dict[str, object]:
    """Parameters [head.w, head.b, (w0, b0, w1, b1) per block, tail.w,
    tail.b] (nn.Linear's layout, the order of `_model_params`) -> the
    kernels' operands, on the parameters' device.

    head_w [W, in_pad] in `dtype` (columns in the doubling order when
    embed_L > 0, zeros past in_dim), body_w [n_block, 2, W, W], tail_w
    [out_dim, W]; f32 biases head_b [W], body_b [n_block, 2, W], tail_b
    [out_dim]; body_wt, body_w with each [W, W] layer transposed (the
    backward's pass 1 reads its [k, n] products' weights K-major from it).
    Also in_dim and embed_L.
    """
    n_block, rem = divmod(len(params) - 4, 4)
    if rem or n_block < 1:
        raise ValueError("pack_r2l_train_weights: expected head, 4 tensors "
                         "per residual block and tail")
    with torch.no_grad():
        head_w = params[0].detach()
        width, in_dim = head_w.shape
        index = _head_perm_index(in_dim, embed_L, head_w.device)
        head_p = torch.zeros((width, _round_up(in_dim, IN_ALIGN)), dtype=dtype,
                             device=head_w.device)
        head_p[:, :in_dim] = (head_w if index is None
                              else head_w[:, index[0]]).to(dtype)
        body = params[2:-2]
        body_w = torch.stack([p.detach() for p in body[0::2]]).to(dtype)
        body_b = torch.stack([p.detach() for p in body[1::2]]).float()
        body_w = body_w.reshape(n_block, 2, width, width).contiguous()
        return {
            "head_w": head_p,
            "head_b": params[1].detach().float().contiguous(),
            "body_w": body_w,
            "body_wt": body_w.transpose(-1, -2).contiguous(),
            "body_b": body_b.reshape(n_block, 2, width).contiguous(),
            "tail_w": params[-2].detach().to(dtype).contiguous(),
            "tail_b": params[-1].detach().float().contiguous(),
            "in_dim": in_dim, "embed_L": embed_L,
        }


def r2l_train_flops(packed: Dict[str, object], n_rays: int):
    """(forward, backward with need_dx off) operations over n_rays: 2 per
    multiply-add, the products only, at the unpadded input width. The
    backward is its two passes' (`r2l_train_pass_flops`)."""
    nb, _, width, _ = packed["body_w"].shape
    out_dim = packed["tail_w"].shape[0]
    fwd = packed["in_dim"] * width + 2 * nb * width * width + width * out_dim
    return 2 * n_rays * fwd, sum(r2l_train_pass_flops(packed, n_rays))


def r2l_train_pass_flops(packed: Dict[str, object], n_rays: int):
    """(pass 1, pass 2) operations of the backward with need_dx off, as
    r2l_train_flops counts them. Pass 1 counts per block the g1 recompute,
    dg1 and dh, and the tail's recompute, weight gradient and dh; pass 2 dW1
    and dW0 per block and the head's weight gradient."""
    nb, _, width, _ = packed["body_w"].shape
    out_dim = packed["tail_w"].shape[0]
    act = 3 * nb * width * width + 3 * width * out_dim
    wgrad = 2 * nb * width * width + packed["in_dim"] * width
    return 2 * n_rays * act, 2 * n_rays * wgrad


@contextlib.contextmanager
def _no_tf32():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _embed(packed, x: torch.Tensor) -> torch.Tensor:
    """The kernels' f32 network input [B, in_pad]: the doubling embed of the
    points (embed_L > 0) or the given rows, zero padded."""
    x = x.float()
    if packed["embed_L"]:
        x = doubling_embed(x, packed["embed_L"])
    return torch.nn.functional.pad(x, (0, packed["head_w"].shape[1] - x.shape[1]))


def r2l_train_fwd_ref(packed, x: torch.Tensor, *, res_scale: float = 1.0,
                      use_global_residual: bool = False):
    """Plain version of the forward kernel: (out [B, out_dim] f32, hs
    [n_block + 1, B, W] in the packed dtype), on x's device."""
    dt = packed["head_w"].dtype

    def mm(a, w):  # a @ w.T, w in nn.Linear's [out, in] layout
        return torch.matmul(a.to(dt).float(), w.float().t())

    with _no_tf32():
        h = torch.relu(mm(_embed(packed, x), packed["head_w"]) + packed["head_b"])
        h0 = h
        hs: List[torch.Tensor] = []
        body_w, body_b = packed["body_w"], packed["body_b"]
        for i in range(body_w.shape[0]):
            hs.append(h.to(dt))
            g = torch.relu(mm(h, body_w[i, 0]) + body_b[i, 0])
            g = mm(g, body_w[i, 1]) + body_b[i, 1]
            h = g * res_scale + h
        if use_global_residual:
            h = h + h0
        hs.append(h.to(dt))
        out = torch.sigmoid(mm(h, packed["tail_w"]) + packed["tail_b"])
    return out, torch.stack(hs)


def _tile_sums(v: torch.Tensor) -> torch.Tensor:
    """[Bp, C] -> [Bp / TILE, C]: each ray tile's f32 column sums."""
    return v.reshape(-1, TILE, v.shape[-1]).sum(1)


def r2l_train_bwd_act_ref(packed, x: torch.Tensor, hs: torch.Tensor,
                          dout: torch.Tensor, *, res_scale: float = 1.0,
                          use_global_residual: bool = False,
                          need_dx: bool = True) -> Dict[str, Optional[torch.Tensor]]:
    """Plain version of the backward's pass 1, rounding as :143-201 do: dt,
    dg2, dg1 and dpre enter the products in the packed dtype, their bias
    gradients sum the f32 values; g1 is recomputed from the rounded h_in.

    Returns pass 2's operands over Bp = B rounded up to TILE rays (rays past
    B read zero points, h_in and dout, as the kernel's padded rays do): dg2,
    dg1, g1 [n_block, Bp, W] and dpre [Bp, W], emb [Bp, in_pad] in the packed
    dtype; `part` [Bp / TILE, W + 2 n_block W + out_dim W + out_dim] f32, each
    ray tile's column sums of the head bias, body bias, tail weight (of the
    rounded dt against hs[-1]) and tail bias gradients; dx [B, x_cols] (None
    when need_dx is off)."""
    dt = packed["head_w"].dtype

    def rnd(v):
        return v.to(dt).float()

    B = x.shape[0]
    pad = -B % TILE
    head_w, body_w = packed["head_w"].float(), packed["body_w"]
    tail_w = packed["tail_w"].float()
    nb, width = body_w.shape[0], body_w.shape[-1]
    out_dim = tail_w.shape[0]
    hs_p = torch.nn.functional.pad(hs.float(), (0, 0, 0, pad))
    with _no_tf32():
        h_n = hs_p[-1]
        out = torch.sigmoid(h_n @ tail_w.t() + packed["tail_b"])
        d_t = torch.nn.functional.pad(dout.float(), (0, 0, 0, pad)) * out * (1.0 - out)
        dt_b = rnd(d_t)
        part_tail_w = torch.bmm(dt_b.reshape(-1, TILE, out_dim).transpose(1, 2),
                                h_n.reshape(-1, TILE, width))
        dh = dt_b @ tail_w
        dh_tail = dh
        Bp = B + pad
        ops = {k: torch.empty((nb, Bp, width), dtype=dt, device=x.device)
               for k in ("dg2", "dg1", "g1")}
        part_body_b = torch.empty((Bp // TILE, nb, 2, width), dtype=torch.float32,
                                  device=x.device)
        for i in range(nb - 1, -1, -1):
            h_in = hs_p[i]
            w0, w1 = body_w[i, 0].float(), body_w[i, 1].float()
            g1 = torch.relu(h_in @ w0.t() + packed["body_b"][i, 0])
            dg2 = dh * res_scale
            dg2_b = rnd(dg2)
            ops["dg2"][i], ops["g1"][i] = dg2_b, g1
            part_body_b[:, i, 1] = _tile_sums(dg2)
            dg1 = (dg2_b @ w1) * (g1 > 0.0).float()
            dg1_b = rnd(dg1)
            ops["dg1"][i] = dg1_b
            part_body_b[:, i, 0] = _tile_sums(dg1)
            dh = dh + dg1_b @ w0
        if use_global_residual:
            dh = dh + dh_tail
        dpre = torch.where(hs_p[0] > 0, dh, torch.zeros_like(dh))
        dpre_b = rnd(dpre)
        emb = _embed(packed, torch.nn.functional.pad(x.float(), (0, 0, 0, pad)))
        part = torch.cat([_tile_sums(dpre), part_body_b.flatten(1),
                          part_tail_w.flatten(1), _tile_sums(d_t)], 1)
        dx = None
        if need_dx:
            demb = dpre_b[:B] @ head_w                      # [B, in_pad]
            L = packed["embed_L"]
            if L:
                # d sin(2^j p) = 2^j cos(2^j p) dp, d cos(2^j p) = -2^j
                # sin(2^j p) dp; the blocks are K columns wide (:185-196)
                K = x.shape[1]
                sins, coss = doubling_sincos(x.float(), L)
                dx = demb[:, 2 * L * K:(2 * L + 1) * K]
                for j in range(L):
                    f = float(2.0 ** j)
                    dx = dx + demb[:, j * K:(j + 1) * K] * (f * coss[j])
                    dx = dx - demb[:, (L + j) * K:(L + j + 1) * K] * (f * sins[j])
            else:
                dx = demb[:, :x.shape[1]].contiguous()
    return {**ops, "dpre": dpre_b.to(dt), "emb": emb.to(dt), "part": part, "dx": dx}


def _act_dims(act) -> tuple:
    """(n_block, Bp, W, in_pad, out_dim) of a pass-1 scratch."""
    nb, Bp, width = act["dg2"].shape
    P = act["part"].shape[1]
    return nb, Bp, width, act["emb"].shape[1], (P - width - 2 * nb * width) // (width + 1)


def _grad_buffers(act, device) -> Dict[str, torch.Tensor]:
    """Uninitialised f32 gradients in the packed layout, views into one
    buffer in _OPERANDS order."""
    nb, _, width, in_pad, out_dim = _act_dims(act)
    shapes = [(width, in_pad), (width,), (nb, 2, width, width), (nb, 2, width),
              (out_dim, width), (out_dim,)]
    flat = torch.empty(sum(int(np.prod(s)) for s in shapes), dtype=torch.float32,
                       device=device)
    grads, off = {}, 0
    for k, shape in zip(_OPERANDS, shapes):
        n = int(np.prod(shape))
        grads[k] = flat[off:off + n].view(shape)
        off += n
    return grads


def r2l_train_wgrad_ref(act, hs: torch.Tensor,
                        grads: Optional[Dict[str, torch.Tensor]] = None
                        ) -> Dict[str, torch.Tensor]:
    """Plain version of the backward's pass 2: from pass 1's scratch `act`
    and the forward's hs [n_block + 1, B, W] (the body's h_in, zeros past B),
    the f32 weight and bias gradients in the packed layout: dW1 = dg2^T g1,
    dW0 = dg1^T h_in per block and dpre^T emb for the head, each product of
    the stored operands summed in f32 (:132-134), and the bias and tail sums
    of every ray tile. With `grads`, adds into them and returns them."""
    nb, Bp, width, in_pad, out_dim = _act_dims(act)
    hs_p = torch.nn.functional.pad(hs[:nb].float(), (0, 0, 0, Bp - hs.shape[1]))
    new = {"body_w": torch.empty((nb, 2, width, width), dtype=torch.float32,
                                 device=hs.device)}
    with _no_tf32():
        for i in range(nb):
            new["body_w"][i, 0] = act["dg1"][i].float().t() @ hs_p[i]
            new["body_w"][i, 1] = act["dg2"][i].float().t() @ act["g1"][i].float()
        new["head_w"] = act["dpre"].float().t() @ act["emb"].float()
    sums = act["part"].sum(0)
    new["head_b"], rest = sums[:width], sums[width:]
    new["body_b"] = rest[:2 * nb * width].view(nb, 2, width)
    new["tail_w"] = rest[2 * nb * width:-out_dim].view(out_dim, width)
    new["tail_b"] = rest[-out_dim:]
    if grads is None:
        return new
    for k in _OPERANDS:
        grads[k] += new[k]
    return grads


def r2l_train_bwd_ref(packed, x: torch.Tensor, hs: torch.Tensor,
                      dout: torch.Tensor, *, res_scale: float = 1.0,
                      use_global_residual: bool = False,
                      need_dx: bool = True) -> Dict[str, Optional[torch.Tensor]]:
    """Plain version of the whole backward: pass 1's plain version, then
    pass 2's. Returns f32 gradients in the packed layout (head_w [W, in_pad]
    in the doubling order) and dx [B, x_cols] (None when need_dx is off)."""
    act = r2l_train_bwd_act_ref(packed, x, hs, dout, res_scale=res_scale,
                                use_global_residual=use_global_residual,
                                need_dx=need_dx)
    return {**r2l_train_wgrad_ref(act, hs), "dx": act["dx"]}


def _check_operands(name: str, packed, x: torch.Tensor) -> None:
    dev = x.device
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous float32 [B, K] tensor")
    for key in _OPERANDS:
        t = packed[key]
        want = torch.bfloat16 if key.endswith("_w") else torch.float32
        if t.dtype != want or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: packed {key} must be a contiguous {want} "
                             f"tensor on {dev} (the kernels take bf16 operands)")
    width, in_pad = packed["head_w"].shape
    n_block, out_dim = packed["body_w"].shape[0], packed["tail_w"].shape[0]
    L = packed["embed_L"]
    in_dim = x.shape[1] * (2 * L + 1) if L else x.shape[1]
    if width % WIDTH_ALIGN or width > MAX_WIDTH or in_pad % IN_ALIGN \
            or in_dim != packed["in_dim"] or out_dim > MAX_OUT \
            or packed["body_w"].shape[1:] != (2, width, width) \
            or packed["body_b"].shape != (n_block, 2, width) \
            or packed["tail_w"].shape[1] != width \
            or packed["head_b"].shape != (width,) \
            or packed["tail_b"].shape != (out_dim,):
        raise ValueError(
            f"{name}: width {width} must be a multiple of {WIDTH_ALIGN} up to "
            f"{MAX_WIDTH}, out_dim at most {MAX_OUT}, x [B, {x.shape[1]}] must "
            f"give the head's input {packed['in_dim']} with embed_L={L}, and "
            "the operands must have the shapes pack_r2l_train_weights gives")


def _kernels(name: str, packed, which: str):
    lib = load_kernels("r2l_train", _SIGNATURES)
    width, in_pad = packed["head_w"].shape
    smem = getattr(lib, f"r2l_train_{which}_smem_bytes")(in_pad, width)
    if smem > MAX_SMEM:
        raise ValueError(f"{name}: width {width} with input {in_pad} needs "
                         f"{smem} B of shared memory per block (at most {MAX_SMEM})")
    return lib


def _shape_args(packed, x, res_scale, use_global_residual):
    width, in_pad = packed["head_w"].shape
    return (x.shape[0], x.shape[1], packed["embed_L"], in_pad, width,
            packed["body_w"].shape[0], packed["tail_w"].shape[0],
            float(res_scale), int(bool(use_global_residual)),
            torch.cuda.current_stream(x.device).cuda_stream)


def r2l_train_fwd(packed, x: torch.Tensor, *, res_scale: float = 1.0,
                  use_global_residual: bool = False):
    """Training forward: x [B, K] points (embed_L > 0) or [B, in_dim]
    embedded rows -> (out [B, out_dim] f32, hs [n_block + 1, B, W]).

    On CUDA tensors this launches csrc/r2l_train.cu (bf16 operands, f32
    accumulation) or raises; it never falls back. CPU tensors run
    `r2l_train_fwd_ref`.
    """
    if not x.is_cuda:
        return r2l_train_fwd_ref(packed, x, res_scale=res_scale,
                                 use_global_residual=use_global_residual)
    _check_operands("r2l_train_fwd", packed, x)
    lib = _kernels("r2l_train_fwd", packed, "fwd")
    B, width = x.shape[0], packed["head_w"].shape[0]
    out = torch.empty((B, packed["tail_w"].shape[0]), dtype=torch.float32,
                      device=x.device)
    hs = torch.empty((packed["body_w"].shape[0] + 1, B, width),
                     dtype=torch.bfloat16, device=x.device)
    if B == 0:
        return out, hs
    err = lib.r2l_train_fwd_launch(
        x.data_ptr(), *(packed[k].data_ptr() for k in _OPERANDS),
        out.data_ptr(), hs.data_ptr(),
        *_shape_args(packed, x, res_scale, use_global_residual))
    if err:
        raise RuntimeError(f"r2l_train_fwd kernel launch failed: CUDA error {err}")
    r2l_train_fwd.launches += 1
    r2l_train_fwd.panel_launches += tile_kind(width, packed["head_w"].shape[1]).per_panel
    return out, hs


def _check_hs(name: str, hs: torch.Tensor, n_block: int, B: int, width: int,
              dev) -> int:
    """hs [n_block + 1, B, W] bf16 on dev, rows contiguous (a ray chunk of the
    forward's hs is a view); returns the rows between two blocks."""
    if hs.shape != (n_block + 1, B, width) or hs.dtype != torch.bfloat16 \
            or hs.device != dev or (B and (
                hs.stride(2) != 1 or hs.stride(1) != width
                or hs.stride(0) % width or hs.stride(0) < B * width)):
        raise ValueError(f"{name}: hs must be the forward's bf16 [{n_block + 1}, "
                         f"{B}, {width}] tensor (or a ray chunk of it) on {dev}")
    return hs.stride(0) // width


def r2l_train_bwd_act(packed, x: torch.Tensor, hs: torch.Tensor,
                      dout: torch.Tensor, *, res_scale: float = 1.0,
                      use_global_residual: bool = False,
                      need_dx: bool = True) -> Dict[str, Optional[torch.Tensor]]:
    """The backward's pass 1: the scratch of `r2l_train_bwd_act_ref` (the
    weight-gradient operands and each ray tile's bias and tail sums) and dx
    [B, K] (None when need_dx is off, and then neither computed nor stored).
    hs may be a ray chunk of the forward's hs (`hs[:, r0:r1]`).

    On CUDA tensors this launches csrc/r2l_train.cu or raises; CPU tensors
    run `r2l_train_bwd_act_ref`.
    """
    if not x.is_cuda:
        return r2l_train_bwd_act_ref(packed, x, hs, dout, res_scale=res_scale,
                                     use_global_residual=use_global_residual,
                                     need_dx=need_dx)
    _check_operands("r2l_train_bwd_act", packed, x)
    B, width = x.shape[0], packed["head_w"].shape[0]
    in_pad = packed["head_w"].shape[1]
    n_block, out_dim = packed["body_w"].shape[0], packed["tail_w"].shape[0]
    hs_rows = _check_hs("r2l_train_bwd_act", hs, n_block, B, width, x.device)
    if dout.shape != (B, out_dim) or dout.dtype != torch.float32 \
            or not dout.is_contiguous() or dout.device != x.device:
        raise ValueError(f"r2l_train_bwd_act: dout must be a contiguous float32 "
                         f"[{B}, {out_dim}] tensor")
    wt = packed.get("body_wt")
    if wt is None or wt.shape != packed["body_w"].shape or wt.dtype != torch.bfloat16 \
            or wt.device != x.device or not wt.is_contiguous():
        raise ValueError("r2l_train_bwd_act: packed body_wt must be the transposed "
                         "bf16 body that pack_r2l_train_weights makes")
    lib = _kernels("r2l_train_bwd_act", packed, "bwd")
    Bp = B + (-B % TILE)

    def empty(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device=x.device)

    act = {k: empty(n_block, Bp, width) for k in ("dg2", "dg1", "g1")}
    act["dpre"], act["emb"] = empty(Bp, width), empty(Bp, in_pad)
    act["part"] = empty(Bp // TILE, width * (1 + 2 * n_block + out_dim) + out_dim,
                        dtype=torch.float32)
    act["dx"] = empty(B, x.shape[1], dtype=torch.float32) if need_dx else None
    if B == 0:
        return act
    err = lib.r2l_train_bwd_launch(
        x.data_ptr(), hs.data_ptr(), dout.data_ptr(),
        *(packed[k].data_ptr() for k in _OPERANDS), wt.data_ptr(),
        *(act[k].data_ptr() for k in ("dg2", "dg1", "g1", "dpre", "emb", "part")),
        act["dx"].data_ptr() if need_dx else None,
        B, hs_rows, x.shape[1], packed["embed_L"], in_pad, width, n_block, out_dim,
        float(res_scale), int(bool(use_global_residual)),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"r2l_train_bwd kernel launch failed: CUDA error {err}")
    r2l_train_bwd_act.launches += 1
    return act


def r2l_train_wgrad(act, hs: torch.Tensor,
                    grads: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
    """The backward's pass 2: the f32 weight and bias gradients (packed
    layout, views into one buffer) of pass 1's scratch `act` and its hs
    (the same rays, a chunk view allowed), summed over the rays in a fixed
    order: two calls on the same inputs give the same bits. With `grads`
    (an earlier chunk's result), adds into them in place.

    On CUDA tensors this launches csrc/r2l_wgrad.cu or raises; CPU tensors
    run `r2l_train_wgrad_ref`.
    """
    if not hs.is_cuda:
        return r2l_train_wgrad_ref(act, hs, grads)
    nb, Bp, width, in_pad, out_dim = _act_dims(act)
    B = hs.shape[1]
    hs_rows = _check_hs("r2l_train_wgrad", hs, nb, B, width, hs.device)
    for k in ("dg2", "dg1", "g1", "dpre", "emb", "part"):
        t = act[k]
        want = torch.float32 if k == "part" else torch.bfloat16
        if t.dtype != want or t.device != hs.device or not t.is_contiguous():
            raise ValueError(f"r2l_train_wgrad: act[{k!r}] must be a contiguous "
                             f"{want} tensor on {hs.device}")
    if Bp != B + (-B % TILE) or act["dpre"].shape != (Bp, width) \
            or act["emb"].shape[0] != Bp or act["part"].shape[0] != Bp // TILE \
            or width % WIDTH_ALIGN or width > MAX_WIDTH or in_pad % IN_ALIGN:
        raise ValueError("r2l_train_wgrad: act must be r2l_train_bwd_act's scratch "
                         f"for these {B} rays")
    lib = load_kernels("r2l_wgrad", _WGRAD_SIGNATURES)
    accumulate = grads is not None
    if grads is None:
        grads = _grad_buffers(act, hs.device)
        if B == 0:
            for g in grads.values():
                g.zero_()
    if B == 0:
        return grads
    n_rt = Bp // TILE
    work = torch.empty(lib.r2l_wgrad_work_floats(n_rt, width, in_pad, nb),
                       dtype=torch.float32, device=hs.device)
    err = lib.r2l_wgrad_launch(
        *(act[k].data_ptr() for k in ("dg2", "dg1", "g1")), hs.data_ptr(),
        act["dpre"].data_ptr(), act["emb"].data_ptr(),
        act["part"].data_ptr(), work.data_ptr(),
        *(grads[k].data_ptr() for k in _OPERANDS),
        n_rt, B, hs_rows, width, in_pad, nb, out_dim, int(accumulate),
        torch.cuda.current_stream(hs.device).cuda_stream)
    if err:
        raise RuntimeError(f"r2l_train_wgrad kernel launch failed: CUDA error {err}")
    r2l_train_wgrad.launches += 1
    return grads


def r2l_train_bwd(packed, x: torch.Tensor, hs: torch.Tensor,
                  dout: torch.Tensor, *, res_scale: float = 1.0,
                  use_global_residual: bool = False, need_dx: bool = True,
                  ray_cap: int = RAY_CAP) -> Dict[str, Optional[torch.Tensor]]:
    """Training backward: the f32 gradients of every operand (packed layout)
    and dx [B, K] (None when need_dx is off).

    Runs `r2l_train_bwd_act` and `r2l_train_wgrad` on ray chunks of at most
    `ray_cap` rays (a multiple of 64; RAY_CAP = 131,072 bounds pass 1's
    scratch at 8.9 GB at W256 D88), each chunk's gradients added to the
    earlier ones' in order, so the result does not depend on the run. Each
    pass launches its kernel on CUDA tensors (or raises) and runs its plain
    version on CPU tensors.
    """
    if ray_cap < TILE or ray_cap % TILE:
        raise ValueError(f"r2l_train_bwd: ray_cap must be a positive multiple of {TILE}")
    B = x.shape[0]
    grads, dxs = None, []
    for r0 in range(0, max(B, 1), ray_cap):
        r1 = min(B, r0 + ray_cap)
        act = r2l_train_bwd_act(packed, x[r0:r1], hs[:, r0:r1], dout[r0:r1],
                                res_scale=res_scale,
                                use_global_residual=use_global_residual,
                                need_dx=need_dx)
        grads = r2l_train_wgrad(act, hs[:, r0:r1], grads)
        dxs.append(act["dx"])
        del act
    grads["dx"] = (None if not need_dx else dxs[0] if len(dxs) == 1
                   else torch.cat(dxs))
    return grads


r2l_train_fwd.launches = 0
r2l_train_fwd.panel_launches = 0
r2l_train_bwd_act.launches = 0
r2l_train_wgrad.launches = 0


class _Profile(NamedTuple):
    embed_L: int
    need_dx: bool
    res_scale: float
    use_global_residual: bool
    dtype: torch.dtype


class R2LTrainFunction(torch.autograd.Function):
    """The port's counterpart of the custom VJP: forward(x, prof, *params)
    with params in `_model_params` order. The backward returns each
    parameter's gradient in f32 (the body's as views into the backward's
    stacked buffer, no copy) and dx (None when prof.need_dx is off).
    Spans: r2l_train.pack (the forward's pack), r2l_train.backward, and in
    it r2l_train.bwd_kernels (both passes) and r2l_train.bwd_grads (the
    gradients' unpacking)."""

    @staticmethod
    def forward(ctx, x, prof: _Profile, *params):
        with span("r2l_train.pack"):
            packed = pack_r2l_train_weights(params, prof.embed_L, prof.dtype)
        out, hs = r2l_train_fwd(packed, x.contiguous(), res_scale=prof.res_scale,
                                use_global_residual=prof.use_global_residual)
        ctx.prof, ctx.packed = prof, packed
        ctx.save_for_backward(x, hs)
        return out

    @staticmethod
    def backward(ctx, dout):
        with span("r2l_train.backward"):
            x, hs = ctx.saved_tensors
            prof, packed = ctx.prof, ctx.packed
            with span("r2l_train.bwd_kernels"):
                g = r2l_train_bwd(packed, x.contiguous(), hs, dout.float().contiguous(),
                                  res_scale=prof.res_scale,
                                  use_global_residual=prof.use_global_residual,
                                  need_dx=prof.need_dx)
            with span("r2l_train.bwd_grads"):
                in_dim = packed["in_dim"]
                g_head = g["head_w"][:, :in_dim]
                index = _head_perm_index(in_dim, prof.embed_L, g_head.device)
                if index is not None:
                    # kernel column n holds ray_embed column perm[n]
                    g_head = g_head[:, index[1]]
                body = []
                for b in range(packed["body_w"].shape[0]):
                    for j in (0, 1):
                        body += [g["body_w"][b, j], g["body_b"][b, j]]
            return (g["dx"], None, g_head, g["head_b"], *body, g["tail_w"],
                    g["tail_b"])


def train_profile_eligible(model) -> bool:
    """The profile the fused kernels cover, as the JAX step decides it
    (steps.py:86-90): uniform-width resmlp body with two linears a block,
    relu activations, no out-activation, sigmoid tail."""
    return (getattr(model, "body_arch", "") == "resmlp"
            and not getattr(model, "layerwise_widths", ())
            and model.n_learnable == 2 and model.inact == "relu"
            and model.outact == "none" and model.act == "relu"
            and not model.linear_tail)


def _model_params(model) -> List[torch.Tensor]:
    """[head.w, head.b, (w0, b0, w1, b1) per block, tail.w, tail.b]."""
    ps = [model.head[0].weight, model.head[0].bias]
    for blk in model.body:
        ps += [blk.body[0].weight, blk.body[0].bias,
               blk.body[2].weight, blk.body[2].bias]
    return ps + [model.tail[0].weight, model.tail[0].bias]


def r2l_train_apply(model, x: torch.Tensor, *, embed_L: int = 0,
                    need_dx: bool = True) -> torch.Tensor:
    """Differentiable fused R2L forward: x [B, K] sample points (embed_L > 0:
    the kernel embeds them with the fast double-angle encoding) or [B,
    in_dim] embedded rows -> rgb [B, out_dim] f32. Gradients reach the
    model's parameters through the fused backward; need_dx=False skips the
    input gradient (the training step's points are data).

    Operands are in `model.dtype` (the kernels take bf16; the plain
    versions, which CPU tensors run, take any float dtype).
    """
    if not train_profile_eligible(model):
        raise ValueError("r2l_train_apply covers the uniform scan-body R2LNet "
                         "profile (resmlp, 2 linears a block, relu, sigmoid tail)")
    prof = _Profile(int(embed_L), bool(need_dx), float(model.res_scale),
                    bool(model.use_residual), model.dtype)
    return R2LTrainFunction.apply(x, prof, *_model_params(model))
