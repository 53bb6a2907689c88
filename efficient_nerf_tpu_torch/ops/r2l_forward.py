"""Fused R2L inference forward: rays [B, 3] -> rgb [B, out_dim].

Port of `efficient_nerf_tpu/ops/pallas/r2l_forward.py::r2l_forward_fused`
(:388) in its production configuration (the double-angle embedding,
f32 epilogues). The kernel is csrc/r2l_forward.cu; this module holds

  * `pack_r2l_weights`: the model's weights as the kernel's operands, with
    the head's input columns permuted into the doubling embed's block layout
    (`_doubling_head_perm_np`, a copy of the Pallas module's :92) and padded
    to a multiple of 64;
  * `r2l_forward_fused`: the wrapper. A CUDA tensor launches the kernel or
    raises; a CPU tensor runs the plain version. `r2l_forward_fused.launches`
    counts kernel launches;
  * `r2l_forward_fused_ref`: the plain version, which repeats the kernel's
    arithmetic in torch: exact f32 points, `fast_sincos` plus doubling, the
    permuted head, and matmuls with `dtype` operands and f32 accumulation,
    emulated in f32 so that no output is rounded to bf16.

The TPU layout tricks of the Pallas kernel (channel-major rays, the 128-lane
tail padding, VMEM weight residency) are not carried over.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Mapping

import numpy as np
import torch

from ..device import to_device
from ._build import load_kernels
from .trig import fast_sincos

__all__ = ["pack_r2l_weights", "r2l_forward_fused", "r2l_forward_fused_ref",
           "r2l_forward_flops"]

MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90
IN_ALIGN = 64      # the kernel streams weights in chunks of 64 input rows
WIDTH_ALIGN = 32   # each of the kernel's warps owns 32 output columns
MAX_WIDTH = 256    # eight warps

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "r2l_forward_smem_bytes": (ctypes.c_longlong, (_I, _I)),
    # (rays_o, rays_d, z, head_w, head_b, body_w, body_b, tail_w, tail_b,
    #  out, B, n_sample, L, in_pad, W, n_block, out_dim, res_scale,
    #  global_residual, stream) -> cudaError_t
    "r2l_forward_launch": (_I, (_P,) * 10 + (_I,) * 7
                           + (ctypes.c_float, _I, _P)),
}


@functools.lru_cache(maxsize=8)
def _doubling_head_perm_np(n_sample: int, L: int) -> np.ndarray:
    """Row permutation mapping the doubling-embed layout onto ray_embed's.

    ray_embed column m*(2L+1)+j is sin(2^j p_m) for j<L, cos(2^(j-L) p_m)
    for L<=j<2L, p_m for j==2L. The doubling kernel produces
    [sin_0 | sin_1 | ... | sin_{L-1} | cos_0 | ... | cos_{L-1} | p] in
    K-column blocks. perm[n] = the ray_embed column that doubling column n
    holds, so head_w_doubling = head_w[perm] for the [in, out] kernel, or
    weight[:, perm] for nn.Linear's [out, in] weight.
    """
    K = n_sample * 3
    E = 2 * L + 1
    perm = np.empty(K * E, np.int64)
    for j in range(L):
        for m in range(K):
            perm[j * K + m] = m * E + j                # sin block j
            perm[(L + j) * K + m] = m * E + L + j      # cos block j
    for m in range(K):
        perm[2 * L * K + m] = m * E + 2 * L            # identity block
    perm.setflags(write=False)  # shared by every caller through the cache
    return perm


@functools.lru_cache(maxsize=8)
def _zvals(near: float, far: float, n_sample: int,
           device: torch.device) -> torch.Tensor:
    """Sample depths as the Pallas wrapper makes them (:423-424): linspace
    in float64, then cast to f32; made once per device."""
    return to_device(np.linspace(near, far, n_sample).astype(np.float32), device)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_r2l_weights(state_dict: Mapping[str, torch.Tensor], n_sample: int,
                     L: int = 10, dtype: torch.dtype = torch.bfloat16
                     ) -> Dict[str, object]:
    """R2LNet state_dict (reference key layout, n_learnable 2, sigmoid tail)
    -> the kernel's operands, on the state_dict's device.

    Weights keep nn.Linear's [out, in] layout, in `dtype`: head_w [W, in_pad]
    (input columns permuted for the doubling embed, zero columns past in_dim
    up to a multiple of 64), body_w [n_block, 2, W, W], tail_w [out_dim, W].
    Biases are f32: head_b [W], body_b [n_block, 2, W], tail_b [out_dim].
    Also n_sample, L and in_dim.
    """
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    if "tail.0.weight" not in sd:
        raise ValueError("pack_r2l_weights: the fused forward covers the "
                         "sigmoid-tail profile (no 'tail.0' in state_dict)")
    n_block = 0
    while f"body.{n_block}.body.0.weight" in sd:
        n_block += 1
    if n_block == 0 or "body.0.body.4.weight" in sd:
        raise ValueError("pack_r2l_weights: the fused forward covers resmlp "
                         "bodies with n_learnable == 2")
    head_w = sd["head.0.weight"].detach()                # [W, in_dim]
    width, in_dim = head_w.shape
    if in_dim != 3 * n_sample * (2 * L + 1):
        raise ValueError(f"pack_r2l_weights: head input {in_dim} != "
                         f"3*n_sample*(2L+1) for n_sample={n_sample}, L={L}")
    perm = torch.from_numpy(_doubling_head_perm_np(n_sample, L).copy()
                            ).to(head_w.device)
    head_p = torch.zeros((width, _round_up(in_dim, IN_ALIGN)), dtype=dtype,
                         device=head_w.device)
    head_p[:, :in_dim] = head_w[:, perm].to(dtype)

    def stack(kind):
        return torch.stack([torch.stack([
            sd[f"body.{b}.body.{2 * j}.{kind}"].detach() for j in (0, 1)])
            for b in range(n_block)])

    return {
        "head_w": head_p,
        "head_b": sd["head.0.bias"].detach().float().contiguous(),
        "body_w": stack("weight").to(dtype).contiguous(),
        "body_b": stack("bias").float().contiguous(),
        "tail_w": sd["tail.0.weight"].detach().to(dtype).contiguous(),
        "tail_b": sd["tail.0.bias"].detach().float().contiguous(),
        "n_sample": n_sample, "L": L, "in_dim": in_dim,
    }


def r2l_forward_flops(packed: Mapping[str, object], n_rays: int) -> int:
    """Operations of one forward over n_rays (2 per multiply-add, matmuls
    only, at the unpadded input width)."""
    nb, _, width, _ = packed["body_w"].shape
    out_dim = packed["tail_w"].shape[0]
    macs = packed["in_dim"] * width + 2 * nb * width * width + width * out_dim
    return 2 * n_rays * macs


def _check_packed(packed, n_sample: int, L: int) -> None:
    if (packed["n_sample"], packed["L"]) != (n_sample, L):
        raise ValueError(
            f"weights were packed for n_sample={packed['n_sample']}, "
            f"L={packed['L']}; called with n_sample={n_sample}, L={L}")


def doubling_sincos(p: torch.Tensor, L: int):
    """Lists [sin(2^j p)] and [cos(2^j p)], j < L, as the kernels make them:
    `fast_sincos(degree=9)` for j = 0, then the double-angle recurrence."""
    s, c = fast_sincos(p, degree=9)
    sins, coss = [s], [c]
    for _ in range(1, L):
        s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
        sins.append(s)
        coss.append(c)
    return sins, coss


def doubling_embed(p: torch.Tensor, L: int) -> torch.Tensor:
    """[B, K] points -> [B, (2L+1)K] in the kernels' [sins | coss | p] block
    layout."""
    sins, coss = doubling_sincos(p, L)
    return torch.cat(sins + coss + [p], dim=1)


def _doubling_embed(rays_o, rays_d, z, L: int) -> torch.Tensor:
    """[B, (2L+1)K] embed of the rays' points o + z d (exact f32)."""
    B = rays_o.shape[0]
    p = (rays_o[:, None, :] + z[None, :, None] * rays_d[:, None, :]
         ).reshape(B, -1)
    return doubling_embed(p, L)


def r2l_forward_fused_ref(packed, rays_o: torch.Tensor, rays_d: torch.Tensor,
                          near: float, far: float, n_sample: int, L: int = 10,
                          *, res_scale: float = 1.0,
                          use_global_residual: bool = False) -> torch.Tensor:
    """Plain torch version of the kernel, on the rays' device: the same
    arithmetic, each matmul as `matmul(a.to(dtype).float(), w.float().t())`
    (operands rounded to the packed dtype, f32 accumulation) with TF32 off."""
    _check_packed(packed, n_sample, L)
    z = _zvals(float(near), float(far), n_sample, rays_o.device)
    x = _doubling_embed(rays_o.float(), rays_d.float(), z, L)
    in_pad = packed["head_w"].shape[1]
    x = torch.nn.functional.pad(x, (0, in_pad - x.shape[1]))
    dt = packed["head_w"].dtype

    def mm(a, w):  # a @ w.T, w in nn.Linear's [out, in] layout
        return torch.matmul(a.to(dt).float(), w.float().t())

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        h = torch.relu(mm(x, packed["head_w"]) + packed["head_b"])
        h0 = h
        body_w, body_b = packed["body_w"], packed["body_b"]
        for i in range(body_w.shape[0]):
            g = torch.relu(mm(h, body_w[i, 0]) + body_b[i, 0])
            g = mm(g, body_w[i, 1]) + body_b[i, 1]
            h = g * res_scale + h
        if use_global_residual:
            h = h + h0
        return torch.sigmoid(mm(h, packed["tail_w"]) + packed["tail_b"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def r2l_forward_fused(packed, rays_o: torch.Tensor, rays_d: torch.Tensor,
                      near: float, far: float, n_sample: int, L: int = 10, *,
                      res_scale: float = 1.0,
                      use_global_residual: bool = False) -> torch.Tensor:
    """Fused inference forward. rays_o/rays_d: [B, 3] f32 -> rgb [B, out_dim]
    f32. `packed` comes from `pack_r2l_weights`.

    On CUDA tensors this launches csrc/r2l_forward.cu (bf16 weights, f32
    accumulation) or raises; it never falls back. CPU tensors run the plain
    version `r2l_forward_fused_ref`.
    """
    _check_packed(packed, n_sample, L)
    if not rays_o.is_cuda:
        return r2l_forward_fused_ref(packed, rays_o, rays_d, near, far,
                                     n_sample, L, res_scale=res_scale,
                                     use_global_residual=use_global_residual)
    dev = rays_o.device
    for name, t in (("rays_o", rays_o), ("rays_d", rays_d)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 3 \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"r2l_forward_fused: {name} must be a contiguous "
                             f"float32 [B, 3] tensor on {dev}")
    if rays_d.shape[0] != rays_o.shape[0]:
        raise ValueError("r2l_forward_fused: rays_o and rays_d differ in B")
    for name in ("head_w", "head_b", "body_w", "body_b", "tail_w", "tail_b"):
        t = packed[name]
        want = torch.bfloat16 if name.endswith("_w") else torch.float32
        if t.dtype != want or t.device != dev or not t.is_contiguous():
            raise ValueError(f"r2l_forward_fused: packed {name} must be a "
                             f"contiguous {want} tensor on {dev}")
    width, in_pad = packed["head_w"].shape
    n_block = packed["body_w"].shape[0]
    out_dim = packed["tail_w"].shape[0]
    if width % WIDTH_ALIGN or width > MAX_WIDTH or in_pad % IN_ALIGN \
            or packed["body_w"].shape[1:] != (2, width, width) \
            or packed["tail_w"].shape[1] != width \
            or packed["head_b"].shape != (width,) \
            or packed["body_b"].shape != (n_block, 2, width) \
            or packed["tail_b"].shape != (out_dim,):
        raise ValueError(f"r2l_forward_fused: width {width} must be a multiple "
                         f"of {WIDTH_ALIGN} up to {MAX_WIDTH}, with the shapes "
                         f"pack_r2l_weights gives and the input padded to {IN_ALIGN}")
    lib = load_kernels("r2l_forward", _SIGNATURES)
    smem = lib.r2l_forward_smem_bytes(in_pad, width)
    if smem > MAX_SMEM:
        raise ValueError(f"r2l_forward_fused: width {width} with input "
                         f"{in_pad} needs {smem} B of shared memory per block "
                         f"(at most {MAX_SMEM})")

    B = rays_o.shape[0]
    out = torch.empty((B, out_dim), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    z = _zvals(float(near), float(far), n_sample, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.r2l_forward_launch(
        rays_o.data_ptr(), rays_d.data_ptr(), z.data_ptr(),
        packed["head_w"].data_ptr(), packed["head_b"].data_ptr(),
        packed["body_w"].data_ptr(), packed["body_b"].data_ptr(),
        packed["tail_w"].data_ptr(), packed["tail_b"].data_ptr(),
        out.data_ptr(), B, n_sample, L, in_pad, width, n_block, out_dim,
        float(res_scale), int(bool(use_global_residual)), stream)
    if err:
        raise RuntimeError(f"r2l_forward kernel launch failed: CUDA error {err}")
    r2l_forward_fused.launches += 1
    return out


r2l_forward_fused.launches = 0
