"""NVIDIA FLIP perceptual error (LDR-FLIP, HPG'20), as
`efficient_nerf_tpu.metrics.flip`, NHWC.

sRGB -> YCxCz, per-channel CSF spatial filtering, Hunt-adjusted L*a*b*, the
HyAB colour error with its redistribution, and an edge/point feature
pipeline on luminance; the error is deltaE_c^(1 - deltaE_f). The filters are
numpy constants, the colour transforms act on the last axis, and the
convolutions are depthwise `conv2d`s over replicate-padded images.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["flip", "flip_error_map", "default_pixels_per_degree"]

_QC, _QF, _PC, _PT = 0.7, 0.5, 0.4, 0.95


def default_pixels_per_degree(monitor_distance=0.7, monitor_width=0.7,
                              monitor_resolution_x=3840) -> float:
    return monitor_distance * (monitor_resolution_x / monitor_width) * (np.pi / 180)


# --- colour transforms (numpy matrices; applied along the last axis) -------

_A_RGB2XYZ = np.array(
    [[10135552 / 24577794, 8788810 / 24577794, 4435075 / 24577794],
     [2613072 / 12288897, 8788810 / 12288897, 887015 / 12288897],
     [1425312 / 73733382, 8788810 / 73733382, 70074185 / 73733382]],
    np.float64)
_REF_ILLUM = (_A_RGB2XYZ @ np.ones(3)).astype(np.float64)  # D65 white XYZ


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _srgb_to_linear(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)


def _lin_to_xyz(c):
    return c @ _const(_A_RGB2XYZ.T, c)


def _xyz_to_lin(c):
    return c @ _const(np.linalg.inv(_A_RGB2XYZ).T, c)


def _xyz_to_ycxcz(c):
    c = c / _const(_REF_ILLUM, c)
    y = 116.0 * c[..., 1:2] - 16.0
    cx = 500.0 * (c[..., 0:1] - c[..., 1:2])
    cz = 200.0 * (c[..., 1:2] - c[..., 2:3])
    return torch.cat([y, cx, cz], -1)


def _ycxcz_to_xyz(c):
    y = (c[..., 0:1] + 16.0) / 116.0
    cx = c[..., 1:2] / 500.0
    cz = c[..., 2:3] / 200.0
    xyz = torch.cat([y + cx, y, y - cz], -1)
    return xyz * _const(_REF_ILLUM, c)


def _xyz_to_lab(c):
    c = c / _const(_REF_ILLUM, c)
    delta = 6 / 29
    # torch has no cbrt; the branch takes only c > 0.00885, where the power
    # is the real cube root
    c = torch.where(c > 0.00885, torch.abs(c) ** (1.0 / 3.0),
                    c / (3 * delta * delta) + 4 / 29)
    l = 116.0 * c[..., 1:2] - 16.0
    a = 500.0 * (c[..., 0:1] - c[..., 1:2])
    b = 200.0 * (c[..., 1:2] - c[..., 2:3])
    return torch.cat([l, a, b], -1)


def _srgb_to_ycxcz(c):
    return _xyz_to_ycxcz(_lin_to_xyz(_srgb_to_linear(c)))


def _lin_to_lab(c):
    return _xyz_to_lab(_lin_to_xyz(c))


# --- filters ---------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _csf_filters(ppd: float) -> Tuple[np.ndarray, int]:
    """Stacked [k, k, 3] CSF kernels (A, RG, BY) and their shared radius."""
    params = {
        "A": (1.0, 0.0047, 0.0, 1e-5),
        "RG": (1.0, 0.0053, 0.0, 1e-5),
        "BY": (34.1, 0.04, 13.5, 0.025),
    }
    max_b = max(b for p in params.values() for b in (p[1], p[3]))
    r = int(np.ceil(3 * np.sqrt(max_b / (2 * np.pi ** 2)) * ppd))
    dx = 1.0 / ppd
    x, y = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1))
    z = (x * dx) ** 2 + (y * dx) ** 2
    ks = []
    for name in ("A", "RG", "BY"):
        a1, b1, a2, b2 = params[name]
        g = (a1 * np.sqrt(np.pi / b1) * np.exp(-np.pi ** 2 * z / b1)
             + a2 * np.sqrt(np.pi / b2) * np.exp(-np.pi ** 2 * z / b2))
        ks.append((g / g.sum()).astype(np.float32))
    out = np.stack(ks, -1)
    out.setflags(write=False)  # shared by every caller through the cache
    return out, r


@functools.lru_cache(maxsize=8)
def _feature_filter(ppd: float, kind: str) -> Tuple[np.ndarray, int]:
    w = 0.082
    sd = 0.5 * w * ppd
    radius = int(np.ceil(3 * sd))
    x, y = np.meshgrid(np.arange(-radius, radius + 1),
                       np.arange(-radius, radius + 1))
    g = np.exp(-(x ** 2 + y ** 2) / (2 * sd * sd))
    if kind == "edge":
        Gx = -x * g
    else:  # point
        Gx = (x ** 2 / (sd * sd) - 1) * g
    Gx = np.where(Gx < 0, Gx / (-Gx[Gx < 0].sum()), Gx / Gx[Gx > 0].sum())
    Gx = Gx.astype(np.float32)
    Gx.setflags(write=False)
    return Gx, radius


def _conv_replicate(img: torch.Tensor, kernels: np.ndarray, radius: int) -> torch.Tensor:
    """img [N, H, W, C], kernels [k, k, C] applied depthwise (cross-
    correlation, as XLA's convolution), replicate padding."""
    C = img.shape[-1]
    x = F.pad(img.permute(0, 3, 1, 2), (radius,) * 4, mode="replicate")
    filt = torch.from_numpy(np.moveaxis(kernels, -1, 0).copy())
    out = F.conv2d(x, filt.to(img)[:, None], groups=C)
    return out.permute(0, 2, 3, 1)


def _hunt(lab):
    L = lab[..., 0:1]
    return torch.cat([L, 0.01 * L * lab[..., 1:2], 0.01 * L * lab[..., 2:3]], -1)


def _hyab(a, b):
    d = a - b
    return torch.abs(d[..., 0:1]) + torch.linalg.norm(d[..., 1:3], dim=-1, keepdim=True)


def _redistribute(p, cmax, pc=_PC, pt=_PT):
    pccmax = pc * cmax
    return torch.where(p < pccmax, (pt / pccmax) * p,
                       pt + ((p - pccmax) / (cmax - pccmax)) * (1.0 - pt))


def flip_error_map(reference: torch.Tensor, test: torch.Tensor,
                   pixels_per_degree: Optional[float] = None) -> torch.Tensor:
    """Per-pixel FLIP error. reference/test: [N, H, W, 3] sRGB in [0, 1].

    Returns [N, H, W, 1].
    """
    ppd = float(pixels_per_degree or default_pixels_per_degree())
    ref_yc = _srgb_to_ycxcz(reference)
    test_yc = _srgb_to_ycxcz(test)

    # --- colour pipeline
    csf, radius = _csf_filters(ppd)

    def prefilter(yc):
        filtered = _conv_replicate(yc, csf, radius)
        lin = torch.clamp(_xyz_to_lin(_ycxcz_to_xyz(filtered)), 0.0, 1.0)
        return _hunt(_lin_to_lab(lin))

    power_d = _hyab(prefilter(ref_yc), prefilter(test_yc)) ** _QC

    primaries = torch.tensor([[[[0.0, 1.0, 0.0]]], [[[0.0, 0.0, 1.0]]]],
                             dtype=reference.dtype, device=reference.device)
    green, blue = _hunt(_lin_to_lab(primaries))
    cmax = float(_hyab(green, blue).reshape(()) ** _QC)
    delta_c = _redistribute(power_d, cmax)

    # --- feature pipeline (luminance)
    ref_y = (ref_yc[..., 0:1] + 16.0) / 116.0
    test_y = (test_yc[..., 0:1] + 16.0) / 116.0

    def features(y, kind):
        Gx, r = _feature_filter(ppd, kind)
        fx = _conv_replicate(y, Gx[:, :, None], r)
        fy = _conv_replicate(y, Gx.T[:, :, None], r)
        return torch.cat([fx, fy], -1)

    def fnorm(f):
        return torch.linalg.norm(f, dim=-1, keepdim=True)

    delta_f = torch.maximum(
        torch.abs(fnorm(features(ref_y, "edge")) - fnorm(features(test_y, "edge"))),
        torch.abs(fnorm(features(test_y, "point")) - fnorm(features(ref_y, "point"))),
    )
    delta_f = torch.clamp(((1 / np.sqrt(2)) * delta_f) ** _QF, 0.0, 1.0)

    return delta_c ** (1.0 - delta_f)


def flip(reference: torch.Tensor, test: torch.Tensor,
         pixels_per_degree: Optional[float] = None) -> torch.Tensor:
    """Mean FLIP error (scalar)."""
    return torch.mean(flip_error_map(reference, test, pixels_per_degree))
