"""R2L student: a deep residual MLP neural light field (one ray -> one RGB),
as `nn.Module`s, after `efficient_nerf_tpu.models.r2l`.

Head Linear+act over the [B, K*(2L+1)] embedded ray, a body of residual
blocks (x + res_scale * body(x), body = n_learnable Linears with `inact`
between them), optional global residual, and a Linear+sigmoid tail.
W256 D88 = head + 43 blocks x 2 + tail = 88 linears. Parameter names follow
the reference state_dict (models/weights.py), so weights cross between the
two packages unchanged.

This is the unfused path, the port's counterpart of the JAX XLA path: its
`nn.Linear`s go through cuBLAS on the card. The served path for the flagship
profile is the fused kernel in ops/r2l_forward.py.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .weights import r2l_state_dict_from_jax

__all__ = ["R2LNet", "ResBlock", "get_activation"]


def get_activation(name: str) -> Optional[nn.Module]:
    name = (name or "none").lower()
    if name == "relu":
        return nn.ReLU()
    if name == "lrelu":
        return nn.LeakyReLU(negative_slope=0.01)
    if name == "none":
        return None
    raise NotImplementedError(f"activation {name!r}")


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`layer(x)` with inputs, weights and bias in the compute dtype, as a
    flax Dense with `dtype` computes."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class ResBlock(nn.Module):
    """x + res_scale * (Linear [act Linear]*) with optional output act.

    The Sequential keeps the reference's indices: linears at even positions,
    the in-activation (or an Identity for 'none') between them.
    """

    def __init__(self, width: int, n_learnable: int = 2, inact: str = "relu",
                 outact: str = "none", res_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        layers = []
        for i in range(n_learnable):
            if i > 0:
                layers.append(get_activation(inact) or nn.Identity())
            layers.append(nn.Linear(width, width))
        self.body = nn.Sequential(*layers)
        self.outact = get_activation(outact)
        self.res_scale = res_scale
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.body:
            h = _linear(layer, h, self.dtype) if isinstance(layer, nn.Linear) \
                else layer(h)
        x = h * self.res_scale + x
        if self.outact is not None:
            x = self.outact(x)
        return x


class R2LNet(nn.Module):
    """Neural light field student.

    input_dim: K*(2L+1) for flattened-ray PE inputs (1008 for 16 samples,
    L=10) or 6*(2L+1) for Plucker rays. `dtype` is the compute dtype;
    parameters stay f32. Only the 'resmlp' body is ported: the 'mlp' body and
    `layerwise_widths` raise NotImplementedError.
    """

    def __init__(self, input_dim: int, depth: int = 88, width: int = 256,
                 output_dim: int = 3, n_block: int = -1, n_learnable: int = 2,
                 body_arch: str = "resmlp", act: str = "relu",
                 inact: str = "relu", outact: str = "none",
                 res_scale: float = 1.0, use_residual: bool = False,
                 linear_tail: bool = False,
                 layerwise_widths: Tuple[int, ...] = (),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if body_arch != "resmlp" or layerwise_widths:
            raise NotImplementedError(
                "R2LNet: only the 'resmlp' body with uniform width is ported; "
                "the 'mlp' body and layerwise_widths are still to be ported "
                "(ROADMAP.md queue 1)")
        self.input_dim, self.depth, self.width = input_dim, depth, width
        self.output_dim = output_dim
        self.n_block = n_block if n_block > 0 else (depth - 2) // 2
        self.n_learnable = n_learnable
        self.body_arch = body_arch
        self.act, self.inact, self.outact = act, inact, outact
        self.res_scale = res_scale
        self.use_residual = use_residual
        self.linear_tail = linear_tail
        self.layerwise_widths = tuple(layerwise_widths)
        self.dtype = dtype

        head_act = get_activation(act)
        self.head = nn.Sequential(nn.Linear(input_dim, width),
                                  *([head_act] if head_act is not None else []))
        self.body = nn.Sequential(*[
            ResBlock(width, n_learnable, inact, outact, res_scale, dtype)
            for _ in range(self.n_block)])
        if linear_tail:
            self.tail = nn.Linear(width, output_dim)
        else:
            self.tail = nn.Sequential(nn.Linear(width, output_dim), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _linear(self.head[0], x, self.dtype)
        if len(self.head) > 1:
            x = self.head[1](x)
        h = self.body(x)
        x = h + x if self.use_residual else h
        if self.linear_tail:
            x = _linear(self.tail, x, self.dtype)
        else:
            x = self.tail[1](_linear(self.tail[0], x, self.dtype))
        return x.float()

    def load_jax_params(self, params_np) -> "R2LNet":
        """Load the JAX R2LNet param tree (leaves as numpy arrays)."""
        sd = r2l_state_dict_from_jax(params_np, self.n_learnable,
                                     self.linear_tail)
        self.load_state_dict(sd)
        return self
