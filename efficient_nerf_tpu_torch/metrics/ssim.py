"""SSIM with an 11x11 sigma-1.5 gaussian window, as
`efficient_nerf_tpu.metrics.ssim`.

Zero padding of window // 2, C1 = 0.01^2, C2 = 0.03^2, biased variance
estimates (reference utils/ssim_torch.py). Images are NHWC in and out, as
in the JAX package; a helper takes single [H, W, C] images.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ssim", "ssim_image"]


@functools.lru_cache(maxsize=8)
def _window_np(window_size: int, sigma: float) -> np.ndarray:
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    w2d = np.outer(g, g).astype(np.float32)
    w2d.setflags(write=False)  # shared by every caller through the cache
    return w2d


def _depthwise_filter(img: torch.Tensor, window: np.ndarray) -> torch.Tensor:
    """NHWC depthwise convolution with zero 'same' padding."""
    k, C = window.shape[0], img.shape[-1]
    filt = torch.from_numpy(window.copy()).to(img)
    filt = filt.reshape(1, 1, k, k).expand(C, 1, k, k)
    out = F.conv2d(img.permute(0, 3, 1, 2), filt, padding=k // 2, groups=C)
    return out.permute(0, 2, 3, 1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, size_average: bool = True) -> torch.Tensor:
    """img1/img2: [N, H, W, C] in [0, 1]. Returns a scalar (or per-image
    [N])."""
    w = _window_np(window_size, sigma)

    mu1 = _depthwise_filter(img1, w)
    mu2 = _depthwise_filter(img2, w)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2

    sigma1_sq = _depthwise_filter(img1 * img1, w) - mu1_sq
    sigma2_sq = _depthwise_filter(img2 * img2, w) - mu2_sq
    sigma12 = _depthwise_filter(img1 * img2, w) - mu1_mu2

    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))

    if size_average:
        return torch.mean(ssim_map)
    return torch.mean(ssim_map, dim=(1, 2, 3))


def ssim_image(img1: torch.Tensor, img2: torch.Tensor, **kw) -> torch.Tensor:
    """[H, W, C] convenience wrapper."""
    return ssim(img1[None], img2[None], **kw)
