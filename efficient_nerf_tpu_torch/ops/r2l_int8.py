"""W8A8 R2L inference forward: rays [B, 3] -> rgb [B, out_dim], with the
43-block residual body on int8 weights and activations.

Port of `efficient_nerf_tpu/ops/pallas/r2l_int8.py::r2l_forward_int8` (:230)
in both of its modes: static activation scales from `calibrate_r2l_int8`
(the served mode) and per-row dynamic scales. The kernel is
csrc/r2l_int8.cu, on the wgmma tile of csrc/r2l_wgmma.cuh with s8 wgmma for
the body; this module holds

  * `pack_r2l_weights_int8`: the bf16 head and tail of `pack_r2l_weights`
    (head columns permuted and padded for the doubling embed) and the body as
    int8 in nn.Linear's [out, in] layout with one f32 scale per output row
    (row n here is column n of the JAX kernel's [in, out] weight);
  * `calibrate_r2l_int8`: static activation scales [n_block, 2] from an f32
    forward over calibration rays;
  * `r2l_forward_int8`: the wrapper. A CUDA tensor launches the kernel or
    raises; a CPU tensor runs the plain version.
    `r2l_forward_int8.launches` counts kernel launches;
  * `r2l_forward_int8_ref`: the plain version, which repeats the kernel's
    arithmetic: a bf16 head and tail with f32 sums, the int8 products as
    f32 matmuls of the int8 values (exact: every partial sum is at most
    256 * 127 * 127 < 2^24, in any order) and the f32 epilogues of
    `_int8_block_math` (:82-115) in its order. On CPU tensors it also takes
    an f32 head, as the JAX function's head_dtype does.

Every division of the JAX functions stays a true division here, on the CPU
and on the card (XLA under jit turns `x / 127.0` into a multiplication by
its reciprocal; the JAX functions as the tests call them, eagerly, do not).
The TPU layout tricks of the Pallas kernel (channel-major rays, 128-lane
tail padding, VMEM residency, `interleave`) are not carried over.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Optional

import torch

from ._build import load_kernels
from .r2l_forward import (IN_ALIGN, MAX_SMEM, MAX_WIDTH, WIDTH_ALIGN, _check_packed,
                          _doubling_embed, _zvals, pack_r2l_weights)

__all__ = ["pack_r2l_weights_int8", "calibrate_r2l_int8", "r2l_forward_int8",
           "r2l_forward_int8_ref", "r2l_int8_ops"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "r2l_int8_smem_bytes": (ctypes.c_longlong, (_I, _I)),
    # (rays_o, rays_d, z, head_w, head_b, body_qw, body_sw, body_b,
    #  act_scales or NULL, tail_w, tail_b, out, B, n_sample, L, in_pad, W,
    #  n_block, out_dim, res_scale, global_residual, stream) -> cudaError_t
    "r2l_int8_launch": (_I, (_P,) * 12 + (_I,) * 7 + (ctypes.c_float, _I, _P)),
}
# operand -> dtype; None: the head's type, bf16 for the kernel (or f32 for
# the plain version)
_OPERANDS = {"head_w": None, "head_b": torch.float32, "body_qw": torch.int8,
             "body_sw": torch.float32, "body_b": torch.float32, "tail_w": None,
             "tail_b": torch.float32}


def _div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 as a true division on every device (torch on CUDA multiplies
    by the reciprocal of a Python scalar divisor)."""
    return x / torch.tensor(127.0, device=x.device)


def _quantize_rows(w: torch.Tensor):
    """f32 [..., N, K] -> (int8 [..., N, K], f32 [..., N] per-row scales):
    `_quantize_cols` (:44) on the transposed layout."""
    s = _div127(w.abs().amax(-1).clamp_min(1e-12))
    q = torch.clamp(torch.round(w / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def pack_r2l_weights_int8(state_dict: Mapping[str, torch.Tensor], n_sample: int,
                          L: int = 10, head_dtype: torch.dtype = torch.bfloat16
                          ) -> Dict[str, object]:
    """R2LNet state_dict -> the int8 kernel's operands, on the state_dict's
    device: head_w [W, in_pad] and tail_w [out_dim, W] in head_dtype as
    `pack_r2l_weights` makes them, body_qw [n_block, 2, W, W] int8 ([out,
    in]) with body_sw [n_block, 2, W] f32, the f32 biases, and n_sample, L,
    in_dim. The kernel takes a bf16 head; an f32 head serves the plain
    version, as the JAX function's head_dtype does."""
    packed = pack_r2l_weights(state_dict, n_sample, L, dtype=torch.float32)
    body = packed.pop("body_w")
    packed["body_qw"], packed["body_sw"] = (t.contiguous() for t in _quantize_rows(body))
    for k in ("head_w", "tail_w"):
        packed[k] = packed[k].to(head_dtype)
    return packed


def r2l_int8_ops(packed: Mapping[str, object], n_rays: int):
    """(int8 operations of the body, bf16 operations of head and tail) of one
    forward over n_rays, 2 a multiply-add, at the unpadded input width."""
    nb, _, width, _ = packed["body_qw"].shape
    out_dim = packed["tail_w"].shape[0]
    return (2 * n_rays * 2 * nb * width * width,
            2 * n_rays * (packed["in_dim"] * width + width * out_dim))


class _NoTF32:
    """f32 matmuls in full f32 on the card inside the block."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.saved


def calibrate_r2l_int8(state_dict: Mapping[str, torch.Tensor], rays_o: torch.Tensor,
                       rays_d: torch.Tensor, near: float, far: float, n_sample: int,
                       L: int = 10, *, res_scale: float = 1.0,
                       margin: float = 1.02) -> torch.Tensor:
    """Static activation scales for the int8 forward, as the JAX package's
    `calibrate_r2l_int8` (:188) makes them: an f32 forward over the
    calibration rays (exact elementwise points, the doubling embed, f32
    matmuls with TF32 off) records each block's largest |input| and largest
    inner activation. Returns act_scales [n_block, 2] f32 (= max * margin /
    127) on the rays' device. Takes the state_dict, not a pack: the scales
    come from the f32 weights."""
    packed = pack_r2l_weights(state_dict, n_sample, L, dtype=torch.float32)
    dev = rays_o.device
    z = _zvals(float(near), float(far), n_sample, dev)
    x = _doubling_embed(rays_o.float(), rays_d.float(), z, L)
    head_w = packed["head_w"][:, :packed["in_dim"]].to(dev)
    body_w = packed["body_w"].to(dev)
    body_b = packed["body_b"].to(dev)
    maxes = []
    with _NoTF32():
        h = torch.relu(x @ head_w.t() + packed["head_b"].to(dev))
        for i in range(body_w.shape[0]):
            s_h = h.abs().amax()
            g = torch.relu(h @ body_w[i, 0].t() + body_b[i, 0])
            s_g = g.abs().amax()
            h = (g @ body_w[i, 1].t() + body_b[i, 1]) * res_scale + h
            maxes.append(torch.stack([s_h, s_g]))
    return torch.stack(maxes) * (margin / 127.0)


def _qdyn(h: torch.Tensor):
    """Per-row dynamic quantization (`_qdyn`, :65): (levels as f32, [T, 1]
    scales max(max |row|, 1e-12) / 127); note the division h / s."""
    s = _div127(h.abs().amax(-1, keepdim=True).clamp_min(1e-12))
    return torch.clamp(torch.round(h / s), -127, 127), s


def _levels(x: torch.Tensor) -> torch.Tensor:
    """clip(round(x), -127, 127) as f32 (`_qstatic`, :76, before its cast)."""
    return torch.clamp(torch.round(x), -127, 127)


def r2l_forward_int8_ref(packed, rays_o: torch.Tensor, rays_d: torch.Tensor,
                         near: float, far: float, n_sample: int, L: int = 10, *,
                         res_scale: float = 1.0, use_global_residual: bool = False,
                         act_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch version of the kernel, on the rays' device: the same
    arithmetic, with the int8 products as exact f32 matmuls of the levels and
    TF32 off. act_scales None selects the dynamic per-row mode."""
    _check_packed(packed, n_sample, L)
    z = _zvals(float(near), float(far), n_sample, rays_o.device)
    x = _doubling_embed(rays_o.float(), rays_d.float(), z, L)
    in_pad = packed["head_w"].shape[1]
    x = torch.nn.functional.pad(x, (0, in_pad - x.shape[1]))

    def mm(a, w):  # a @ w.T on operands of the weight's type, f32 sums
        return torch.matmul(a.to(w.dtype).float(), w.float().t())

    with _NoTF32():
        h = torch.relu(mm(x, packed["head_w"]) + packed["head_b"])
        h0 = h
        qw, sw, bias = packed["body_qw"], packed["body_sw"], packed["body_b"]
        if act_scales is not None:
            act = act_scales.float()
            dqs = act[:, :, None] * sw          # [n, 2, W]
            invs = torch.reciprocal(act)        # [n, 2]
        for i in range(qw.shape[0]):
            w0, w1 = qw[i, 0].float().t(), qw[i, 1].float().t()
            if act_scales is not None:
                t = ((_levels(h * invs[i, 0]) @ w0) * (dqs[i, 0] * invs[i, 1])
                     + bias[i, 0] * invs[i, 1])
                g = (_levels(torch.relu(t)) @ w1) * dqs[i, 1] + bias[i, 1]
            else:
                qh, sh = _qdyn(h)
                g = torch.relu((qh @ w0) * (sh * sw[i, 0]) + bias[i, 0])
                qg, sg = _qdyn(g)
                g = (qg @ w1) * (sg * sw[i, 1]) + bias[i, 1]
            h = g * res_scale + h
        if use_global_residual:
            h = h + h0
        return torch.sigmoid(mm(h, packed["tail_w"]) + packed["tail_b"])


def _check_operands(packed, rays_o, rays_d, act_scales) -> None:
    dev = rays_o.device
    for name, t in (("rays_o", rays_o), ("rays_d", rays_d)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 3 \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"r2l_forward_int8: {name} must be a contiguous "
                             f"float32 [B, 3] tensor on {dev}")
    if rays_d.shape[0] != rays_o.shape[0]:
        raise ValueError("r2l_forward_int8: rays_o and rays_d differ in B")
    head_types = (torch.bfloat16,) if rays_o.is_cuda else (torch.bfloat16, torch.float32)
    for name, want in _OPERANDS.items():
        t = packed[name]
        types = (want,) if want else head_types
        if t.dtype not in types or t.device != dev or not t.is_contiguous():
            raise ValueError(f"r2l_forward_int8: packed {name} must be a "
                             f"contiguous {' or '.join(map(str, types))} tensor on {dev}")
    width, in_pad = packed["head_w"].shape
    n_block = packed["body_qw"].shape[0]
    out_dim = packed["tail_w"].shape[0]
    if width % WIDTH_ALIGN or width > MAX_WIDTH or in_pad % IN_ALIGN \
            or packed["body_qw"].shape[1:] != (2, width, width) \
            or packed["body_sw"].shape != (n_block, 2, width) \
            or packed["body_b"].shape != (n_block, 2, width) \
            or packed["tail_w"].shape[1] != width \
            or packed["head_b"].shape != (width,) \
            or packed["tail_b"].shape != (out_dim,):
        raise ValueError(f"r2l_forward_int8: width {width} must be a multiple "
                         f"of {WIDTH_ALIGN} up to {MAX_WIDTH}, with the shapes "
                         f"pack_r2l_weights_int8 gives and the input padded to "
                         f"{IN_ALIGN}")
    if act_scales is not None and (
            act_scales.dtype != torch.float32 or act_scales.shape != (n_block, 2)
            or act_scales.device != dev or not act_scales.is_contiguous()):
        raise ValueError(f"r2l_forward_int8: act_scales must be a contiguous "
                         f"float32 [{n_block}, 2] tensor on {dev}")


def r2l_forward_int8(packed, rays_o: torch.Tensor, rays_d: torch.Tensor,
                     near: float, far: float, n_sample: int, L: int = 10, *,
                     res_scale: float = 1.0, use_global_residual: bool = False,
                     act_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W8A8 inference forward. rays_o/rays_d: [B, 3] f32 -> rgb [B, out_dim]
    f32. `packed` comes from `pack_r2l_weights_int8`; act_scales [n_block, 2]
    f32 from `calibrate_r2l_int8` selects static scales, None the per-row
    dynamic ones.

    On CUDA tensors this launches csrc/r2l_int8.cu or raises; it never falls
    back. CPU tensors run the plain version `r2l_forward_int8_ref`.
    """
    _check_packed(packed, n_sample, L)
    _check_operands(packed, rays_o, rays_d, act_scales)
    if not rays_o.is_cuda:
        return r2l_forward_int8_ref(packed, rays_o, rays_d, near, far, n_sample, L,
                                    res_scale=res_scale,
                                    use_global_residual=use_global_residual,
                                    act_scales=act_scales)
    dev = rays_o.device
    width, in_pad = packed["head_w"].shape
    lib = load_kernels("r2l_int8", _SIGNATURES)
    smem = lib.r2l_int8_smem_bytes(in_pad, width)
    if smem > MAX_SMEM:
        raise ValueError(f"r2l_forward_int8: width {width} with input {in_pad} "
                         f"needs {smem} B of shared memory per block (at most "
                         f"{MAX_SMEM})")
    B = rays_o.shape[0]
    out_dim = packed["tail_w"].shape[0]
    out = torch.empty((B, out_dim), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    z = _zvals(float(near), float(far), n_sample, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.r2l_int8_launch(
        rays_o.data_ptr(), rays_d.data_ptr(), z.data_ptr(),
        packed["head_w"].data_ptr(), packed["head_b"].data_ptr(),
        packed["body_qw"].data_ptr(), packed["body_sw"].data_ptr(),
        packed["body_b"].data_ptr(),
        None if act_scales is None else act_scales.data_ptr(),
        packed["tail_w"].data_ptr(), packed["tail_b"].data_ptr(),
        out.data_ptr(), B, n_sample, L, in_pad, width, packed["body_qw"].shape[0],
        out_dim, float(res_scale), int(bool(use_global_residual)), stream)
    if err:
        raise RuntimeError(f"r2l_int8 kernel launch failed: CUDA error {err}")
    r2l_forward_int8.launches += 1
    return out


r2l_forward_int8.launches = 0
