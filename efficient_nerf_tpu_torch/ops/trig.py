"""Fast polynomial sine/cosine: the plain torch version of the device helpers
in csrc/trig.cuh, and a wrapper that launches them on the card.

Port of `efficient_nerf_tpu/ops/pallas/trig.py` (`fast_sin` :30, `fast_cos`
:44, `fast_sincos` :53) with the same constants: a Cody-Waite two-term pi
range reduction, then an odd minimax polynomial of degree 7 or 9 on
[-pi/2, pi/2] (and an even degree-8 one for the cosine of `fast_sincos`).
`torch.round` rounds half to even like `jnp.round` (`rintf` in CUDA).

On the card the helpers run inside the fused R2L kernel, which takes
`fast_sincos(degree=9)` once per point as the base angle of its double-angle
recurrence. `fast_sincos_cuda` launches a kernel that does nothing but call
the helper, so that the helper can be held against this plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import load_kernels

__all__ = ["fast_sin", "fast_cos", "fast_sincos", "fast_sincos_cuda"]

_INV_PI = 0.3183098861837907
_PI_HI = 3.140625
_PI_LO = 9.676535897932e-4
_HALF_PI = 1.5707963267948966

# odd minimax coefficients for sin on [-pi/2, pi/2]
_C7 = (0.9999966, -0.16664824, 0.00830629, -0.00018363)
_C9 = (0.99999998278, -0.16666651520, 8.3329640073e-3, -1.9804754584e-4,
       2.5981089066e-6)
# even minimax coefficients for cos on [-pi/2, pi/2]
_CC8 = (0.99999996727, -0.49999926896, 4.1664091297e-2, -1.3857421328e-3,
        2.3237633547e-5)


def _reduce(y: torch.Tensor):
    """(r, r^2, (-1)^k) with y = k*pi + r, |r| <= pi/2."""
    k = torch.round(y * _INV_PI)
    r = y - k * _PI_HI - k * _PI_LO
    sign = 1.0 - 2.0 * (k - 2.0 * torch.floor(k * 0.5))
    return r, r * r, sign


def _odd_poly(r: torch.Tensor, r2: torch.Tensor, degree: int) -> torch.Tensor:
    if degree >= 9:
        c1, c3, c5, c7, c9 = _C9
        return r * (c1 + r2 * (c3 + r2 * (c5 + r2 * (c7 + r2 * c9))))
    c1, c3, c5, c7 = _C7
    return r * (c1 + r2 * (c3 + r2 * (c5 + r2 * c7)))


def fast_sin(y: torch.Tensor, degree: int = 7) -> torch.Tensor:
    r, r2, sign = _reduce(y)
    return _odd_poly(r, r2, degree) * sign


def fast_cos(y: torch.Tensor, degree: int = 7) -> torch.Tensor:
    return fast_sin(y + _HALF_PI, degree)


def fast_sincos(y: torch.Tensor, degree: int = 9):
    """(sin y, cos y) sharing one range reduction: the base-angle pair of the
    double-angle recurrence embeds (cos gets its own even polynomial, since
    the recurrence amplifies base error by about 2^L)."""
    r, r2, sign = _reduce(y)
    s = _odd_poly(r, r2, degree)
    d0, d2, d4, d6, d8 = _CC8
    c = d0 + r2 * (d2 + r2 * (d4 + r2 * (d6 + r2 * d8)))
    return s * sign, c * sign


_P = ctypes.c_void_p
# fast_sincos_launch(y, s, c, n, degree, stream) -> cudaError_t
_SIGNATURES = {"fast_sincos_launch": (
    ctypes.c_int, (_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P))}


def fast_sincos_cuda(y: torch.Tensor, degree: int = 9):
    """(sin y, cos y) computed by csrc/trig.cuh on the card: one thread per
    element. For a CPU tensor, the plain version above."""
    if not y.is_cuda:
        return fast_sincos(y, degree)
    if y.dtype != torch.float32 or not y.is_contiguous():
        raise ValueError("fast_sincos_cuda takes a contiguous float32 tensor")
    if degree not in (7, 9):
        raise ValueError(f"fast_sincos_cuda: degree {degree} (7 or 9)")
    lib = load_kernels("trig", _SIGNATURES)
    s = torch.empty_like(y)
    c = torch.empty_like(y)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = lib.fast_sincos_launch(y.data_ptr(), s.data_ptr(), c.data_ptr(),
                                 y.numel(), degree, stream)
    if err:
        raise RuntimeError(f"fast_sincos kernel launch failed: CUDA error {err}")
    fast_sincos_cuda.launches += 1
    return s, c


fast_sincos_cuda.launches = 0
