"""Analytic per-pixel FLOP counting, a copy of
`efficient_nerf_tpu.models.flops` (which this package must not import).

As the reference's startup complexity report (main.py:540-552): teacher
FLOPs are multiplied by (N_samples + N_samples + N_importance) network
evaluations per pixel (coarse pass + fine pass over all samples); the R2L
student is a single forward per pixel. A multiply-accumulate counts as 2
FLOPs (the paper's Table 2: R2L W256D88 with 1008-d input = 11.79
MFLOPs/pixel, teacher = 303.82 MFLOPs/pixel at 64+64+128 evals).

`r2l_flops_per_pixel` counts the body as n_block x n_learnable width x
width layers whatever the body is, as the JAX function does: for the 'mlp'
body at an even depth that is the depth - 2 layers it has; for
`layerwise_widths` it is not the layers' own widths. Copied as it is, so
that the two packages log the same number.
"""
from __future__ import annotations

__all__ = ["linear_flops", "nerf_flops_per_pixel", "r2l_flops_per_pixel"]


def linear_flops(d_in: int, d_out: int) -> int:
    return 2 * d_in * d_out


def nerf_flops_per_pixel(depth: int = 8, width: int = 256, input_ch: int = 63,
                         input_ch_views: int = 27, skips=(4,),
                         use_viewdirs: bool = True, n_samples: int = 64,
                         n_importance: int = 128) -> int:
    f = linear_flops(input_ch, width)
    d_in = width
    for i in range(1, depth):
        if (i - 1) in skips:
            d_in = width + input_ch
        f += linear_flops(d_in, width)
        d_in = width
    if use_viewdirs:
        f += linear_flops(width, 1)           # alpha
        f += linear_flops(width, width)       # feature
        f += linear_flops(width + input_ch_views, width // 2)
        f += linear_flops(width // 2, 3)      # rgb
    else:
        f += linear_flops(width, 4)
    return f * (n_samples + n_samples + n_importance)


def r2l_flops_per_pixel(input_dim: int, depth: int = 88, width: int = 256,
                        output_dim: int = 3, n_block: int = -1,
                        n_learnable: int = 2) -> int:
    if n_block <= 0:
        n_block = (depth - 2) // 2
    f = linear_flops(input_dim, width)
    f += n_block * n_learnable * linear_flops(width, width)
    f += linear_flops(width, output_dim)
    return f
