"""Deterministic inverse-CDF importance sampling: bins [N, C], weights
[N, C-1] -> sorted samples [N, n].

Port of `efficient_nerf_tpu/ops/pallas/sample_pdf.py::sample_pdf_det_fused`
(:123) with the semantics of its default (use_roll=False) kernel: the 1e-5
weight floor, pdf = w / sum(w), the CDF accumulated sequentially, the
denom < 1e-5 guard, the tail at u >= cdf[-1] and the top level u >= 1 pinned
to the top bin edge. The kernel is csrc/sample_pdf.cu; this module holds

  * `sample_pdf_det_fused`: the wrapper. A CUDA tensor launches the kernel
    or raises; a CPU tensor runs the plain version.
    `sample_pdf_det_fused.launches` counts kernel launches;
  * `sample_pdf_det_fused_ref`: the plain version, the Pallas kernel's masked
    sum over the intervals in torch, with the weight total and the CDF summed
    one column at a time in the kernel's order. It agrees with the kernel bit
    for bit.

The levels are XLA's f32 linspace (`core.sampling._linspace01`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..core.sampling import _linspace01
from ..device import to_device
from ._build import load_kernels

__all__ = ["sample_pdf_det_fused", "sample_pdf_det_fused_ref"]

MAX_SMEM = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "sample_pdf_smem_bytes": (_L, (_I, _I)),
    # (bins, weights, u, out, N, C, n, stream) -> cudaError_t
    "sample_pdf_det_launch": (_I, (_P, _P, _P, _P, _L, _I, _I, _P)),
}


@functools.lru_cache(maxsize=8)
def _levels(n: int, device: torch.device) -> torch.Tensor:
    """The n det levels on `device`, made once per device."""
    return to_device(_linspace01(n), device)


def sample_pdf_det_fused_ref(bins: torch.Tensor, weights: torch.Tensor,
                             n_samples: int, levels: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain torch version of the kernel, on the inputs' device."""
    bins = bins.float()
    w = weights.float() + 1e-5
    u = _levels(n_samples, bins.device) if levels is None else levels
    total = torch.zeros_like(w[:, 0])
    for i in range(w.shape[1]):
        total = total + w[:, i]
    pdf = w / total[:, None]
    acc = torch.zeros((bins.shape[0], n_samples), dtype=torch.float32,
                      device=bins.device)
    cdf_lo = torch.zeros_like(bins[:, :1])
    for i in range(w.shape[1]):
        cdf_hi = cdf_lo + pdf[:, i:i + 1]
        mask = (cdf_lo <= u) & (u < cdf_hi)
        denom = cdf_hi - cdf_lo
        denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
        t = (u - cdf_lo) / denom
        b_lo = bins[:, i:i + 1]
        val = b_lo + t * (bins[:, i + 1:i + 2] - b_lo)
        acc = acc + torch.where(mask, val, torch.zeros_like(val))
        cdf_lo = cdf_hi
    acc = acc + (u >= cdf_lo) * bins[:, -1:]
    return torch.where(u >= 1.0, bins[:, -1:], acc)


def sample_pdf_det_fused(bins: torch.Tensor, weights: torch.Tensor,
                         n_samples: int, levels: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Deterministic inverse-CDF sampling: bins [N, C], weights [N, C-1]
    (f32) -> sorted samples [N, n_samples] (f32). `levels` [n_samples]
    (sorted, f32, on the inputs' device) replaces the linspace levels: the
    whole-ray kernel's own levels (ops/nerf_frame.py).

    On CUDA tensors this launches csrc/sample_pdf.cu or raises; it never
    falls back. CPU tensors run the plain version `sample_pdf_det_fused_ref`.
    """
    if bins.dim() != 2 or weights.shape != (bins.shape[0], bins.shape[1] - 1) \
            or bins.shape[1] < 2 or n_samples < 1:
        raise ValueError(f"sample_pdf_det_fused: bins [N, C] and weights "
                         f"[N, C-1] with C >= 2, got {tuple(bins.shape)} and "
                         f"{tuple(weights.shape)}")
    if levels is not None and levels.shape != (n_samples,):
        raise ValueError(f"sample_pdf_det_fused: levels must be [{n_samples}], got "
                         f"{tuple(levels.shape)}")
    if not bins.is_cuda:
        return sample_pdf_det_fused_ref(bins, weights, n_samples, levels)
    dev = bins.device
    u = _levels(n_samples, dev) if levels is None else levels
    for name, t in (("bins", bins), ("weights", weights), ("levels", u)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"sample_pdf_det_fused: {name} must be a "
                             f"contiguous float32 tensor on {dev}")
    N, C = bins.shape
    lib = load_kernels("sample_pdf", _SIGNATURES)
    smem = lib.sample_pdf_smem_bytes(C, n_samples)
    if smem > MAX_SMEM:
        raise ValueError(f"sample_pdf_det_fused: C={C}, n={n_samples} needs "
                         f"{smem} B of shared memory per block (at most {MAX_SMEM})")
    out = torch.empty((N, n_samples), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.sample_pdf_det_launch(bins.data_ptr(), weights.data_ptr(),
                                    u.data_ptr(), out.data_ptr(), N, C,
                                    n_samples, stream)
    if err:
        raise RuntimeError(f"sample_pdf kernel launch failed: CUDA error {err}")
    sample_pdf_det_fused.launches += 1
    return out


sample_pdf_det_fused.launches = 0
