"""R2L student: a deep MLP neural light field (one ray -> one RGB), as
`nn.Module`s, after `efficient_nerf_tpu.models.r2l`.

Head Linear+act over the [B, K*(2L+1)] embedded ray, a body, optional
global residual, and a Linear+sigmoid tail. The body is one of:
  * 'resmlp': residual blocks (x + res_scale * body(x), body = n_learnable
    Linears with `inact` between them). W256 D88 = head + 43 blocks x 2 +
    tail = 88 linears. Parameter names follow the reference state_dict
    (models/weights.py), so weights cross between the two packages
    unchanged.
  * 'mlp': depth - 2 plain Linears, each followed by `act` (the driver's
    default student when the trial flags are off).
  * `layerwise_widths` (any body_arch): the 'mlp' body with per-layer widths.

This is the unfused path, the port's counterpart of the JAX XLA path: its
`nn.Linear`s go through cuBLAS on the card. The served path for the flagship
profile (the resmlp body) is the fused kernel in ops/r2l_forward.py; no
kernel covers the 'mlp' and layerwise bodies, in either package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .weights import plain_r2l_state_dict_from_jax, r2l_state_dict_from_jax

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
    parameters stay f32.

    body_arch 'mlp' or nonempty `layerwise_widths` build a plain body of
    depth - 2 Linears (`body.{2i}`; `act` or an Identity at the odd
    indices), as the JAX module's unrolled `body_{i}` Denses. With
    `layerwise_widths` the head is widths[0] wide, body layer i (1-based)
    widths[i], where widths = layerwise_widths + (output_dim,) as in the
    JAX module, and the tail reads widths[depth - 2]. Shapes the JAX module
    fails on at apply raise ValueError here: `layerwise_widths` too short
    for the depth (fewer than max(1, depth - 2) entries) and a global
    residual across unequal widths.
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
        if body_arch not in ("resmlp", "mlp"):
            raise ValueError(f"R2LNet: unknown body_arch {body_arch!r}")
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
        if self.layerwise_widths or body_arch == "mlp":
            widths = _plain_widths(self.layerwise_widths, depth, width,
                                   output_dim, use_residual)
            layers = []
            for i in range(1, depth - 1):
                layers += [nn.Linear(widths[i - 1], widths[i]),
                           get_activation(act) or nn.Identity()]
            self.body = nn.Sequential(*layers)
            head_width, tail_in = widths[0], widths[max(depth - 2, 0)]
        else:
            self.body = nn.Sequential(*[
                ResBlock(width, n_learnable, inact, outact, res_scale, dtype)
                for _ in range(self.n_block)])
            head_width = tail_in = width
        self.head = nn.Sequential(nn.Linear(input_dim, head_width),
                                  *([head_act] if head_act is not None else []))
        if linear_tail:
            self.tail = nn.Linear(tail_in, output_dim)
        else:
            self.tail = nn.Sequential(nn.Linear(tail_in, output_dim), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _linear(self.head[0], x, self.dtype)
        if len(self.head) > 1:
            x = self.head[1](x)
        h = x
        for layer in self.body:
            h = _linear(layer, h, self.dtype) if isinstance(layer, nn.Linear) \
                else layer(h)
        x = h + x if self.use_residual else h
        if self.linear_tail:
            x = _linear(self.tail, x, self.dtype)
        else:
            x = self.tail[1](_linear(self.tail[0], x, self.dtype))
        return x.float()

    def load_jax_params(self, params_np) -> "R2LNet":
        """Load the JAX R2LNet param tree (leaves as numpy arrays)."""
        if self.layerwise_widths or self.body_arch == "mlp":
            sd = plain_r2l_state_dict_from_jax(params_np, self.depth,
                                               self.linear_tail)
        else:
            sd = r2l_state_dict_from_jax(params_np, self.n_learnable,
                                         self.linear_tail)
        self.load_state_dict(sd)
        return self


def _plain_widths(layerwise_widths: Tuple[int, ...], depth: int, width: int,
                  output_dim: int, use_residual: bool) -> Tuple[int, ...]:
    """The widths of the plain body's activations: [0] the head's output,
    [i] body layer i's. Raises ValueError where the JAX module's apply
    fails."""
    if not layerwise_widths:
        return (width,) * max(depth - 1, 1)
    # the JAX module pads with output_dim and indexes [0, depth - 2]
    widths = tuple(layerwise_widths) + (output_dim,)
    if len(layerwise_widths) < max(1, depth - 2):
        raise ValueError(
            f"R2LNet: layerwise_widths has {len(layerwise_widths)} entries; "
            f"depth {depth} needs at least {max(1, depth - 2)}")
    last = widths[max(depth - 2, 0)]
    if use_residual and last != widths[0]:
        raise ValueError(
            f"R2LNet: the global residual adds the body's output ({last} wide) "
            f"to the head's ({widths[0]} wide); they must be equal")
    return widths
