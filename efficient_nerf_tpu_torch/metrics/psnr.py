"""MSE / PSNR, as `efficient_nerf_tpu.metrics.psnr` (reference
helpers.py:19-20)."""
from __future__ import annotations

import math

import torch

__all__ = ["img2mse", "mse2psnr", "psnr"]


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def psnr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return mse2psnr(img2mse(x, y))
