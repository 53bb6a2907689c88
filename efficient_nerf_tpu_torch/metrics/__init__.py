"""Image metrics, after `efficient_nerf_tpu.metrics`: MSE/PSNR, SSIM, FLIP
and LPIPS. Plain PyTorch on whatever device the images are on (the JAX
package computes them with XLA, outside any Pallas kernel)."""
from .psnr import img2mse, mse2psnr, psnr
from .ssim import ssim, ssim_image
from .flip import default_pixels_per_degree, flip, flip_error_map
from .lpips import lpips, lpips_available

__all__ = ["img2mse", "mse2psnr", "psnr", "ssim", "ssim_image",
           "default_pixels_per_degree", "flip", "flip_error_map", "lpips",
           "lpips_available"]
