"""Teacher model: the classic 8-layer NeRF MLP as an `nn.Module`, after
`efficient_nerf_tpu.models.nerf.NeRFMLP`.

D ReLU layers of width W over the 63-d encoded point, the encoded point
concatenated in front of the hidden state after each layer in `skips`, then
either the viewdir branch (an alpha head, a feature head, one W/2 view layer
over [feature, encoded dir], an rgb head; outputs [rgb, alpha]) or a single
output head. Parameter names follow the reference `NeRF` state_dict
(models/weights.py), so weights cross between the two packages unchanged.

This is the unfused path, the port's counterpart of the JAX XLA path: its
`nn.Linear`s go through cuBLAS on the card. The teacher's eval path runs the
fused field-eval kernel of ops/nerf_forward.py on packed copies of these
weights.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .r2l import _linear
from .weights import nerf_state_dict_from_jax

__all__ = ["NeRFMLP"]


class NeRFMLP(nn.Module):
    """x: [..., input_ch + input_ch_views] -> [..., 4] (rgb, sigma) in f32.

    `dtype` is the compute dtype (inputs, weights and biases of every linear
    are cast to it, as a flax Dense with `dtype` does); parameters stay f32.
    """

    def __init__(self, depth: int = 8, width: int = 256, input_ch: int = 63,
                 input_ch_views: int = 27, output_ch: int = 4,
                 skips: Sequence[int] = (4,), use_viewdirs: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth, self.width = depth, width
        self.input_ch, self.input_ch_views = input_ch, input_ch_views
        self.output_ch = output_ch
        self.skips = tuple(skips)
        self.use_viewdirs = use_viewdirs
        self.dtype = dtype
        self.pts_linears = nn.ModuleList(
            [nn.Linear(input_ch, width)]
            + [nn.Linear(width + input_ch if i in self.skips else width, width)
               for i in range(depth - 1)])
        if use_viewdirs:
            self.feature_linear = nn.Linear(width, width)
            self.alpha_linear = nn.Linear(width, 1)
            self.views_linears = nn.ModuleList(
                [nn.Linear(width + input_ch_views, width // 2)])
            self.rgb_linear = nn.Linear(width // 2, 3)
        else:
            self.output_linear = nn.Linear(width, output_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        pts = x[..., :self.input_ch]
        views = x[..., self.input_ch:self.input_ch + self.input_ch_views]
        h = pts
        for i, layer in enumerate(self.pts_linears):
            h = torch.relu(_linear(layer, h, dt))
            if i in self.skips:
                h = torch.cat([pts.to(h.dtype), h], dim=-1)
        if not self.use_viewdirs:
            return _linear(self.output_linear, h, dt).float()
        alpha = _linear(self.alpha_linear, h, dt)
        feature = _linear(self.feature_linear, h, dt)
        h = torch.cat([feature, views.to(feature.dtype)], dim=-1)
        h = torch.relu(_linear(self.views_linears[0], h, dt))
        rgb = _linear(self.rgb_linear, h, dt)
        return torch.cat([rgb, alpha], dim=-1).float()

    def load_jax_params(self, params_np) -> "NeRFMLP":
        """Load the JAX NeRFMLP param tree (leaves as numpy arrays)."""
        self.load_state_dict(nerf_state_dict_from_jax(
            params_np, self.depth, self.use_viewdirs))
        return self
