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

`R2LConvNet` is the conv student of the patch modes (`--data_mode
patches`): 1x1 conv head, a body of SAME-padded convs or residual conv
pairs, optional BatchNorm, 1x1 conv + sigmoid tail, over NHWC patches.

This is the unfused path, the port's counterpart of the JAX XLA path: its
`nn.Linear`s go through cuBLAS on the card. The served path for the flagship
profile (the resmlp body) is the fused kernel in ops/r2l_forward.py; no
kernel covers the 'mlp' and layerwise bodies or the conv student, in
either package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .weights import (conv_state_dict_from_jax, plain_r2l_state_dict_from_jax,
                      r2l_state_dict_from_jax)

__all__ = ["R2LNet", "R2LConvNet", "ResBlock", "get_activation"]


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


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over NCHW with flax's arithmetic and its state_dict keys as
    nn.BatchNorm2d's. flax's `momentum=0.99`, `epsilon=1e-5` are torch's
    `momentum=0.01`, `eps=1e-5`. Training normalizes with the batch's mean
    and its biased variance E[x^2] - E[x]^2 (flax's fast variance, clipped
    at 0; nn.BatchNorm2d would put the unbiased variance into its running
    statistic), in f32; y = (x - mean) * (rsqrt(var + eps) * scale) + bias,
    cast to `dtype`."""

    def __init__(self, width: int, dtype: torch.dtype = torch.float32):
        super().__init__(width, eps=1e-5, momentum=0.01)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
                self.running_var.copy_(keep * self.running_var + self.momentum * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)


class R2LConvNet(nn.Module):
    """CNN-style patch student, after `efficient_nerf_tpu.models.r2l.
    R2LConvNet` (:156-220).

    Input [N, ph, pw, C] (NHWC, as in JAX), permuted to NCHW for the convs;
    output [N, ph, pw, output_dim] f32. Head 1x1 conv (+ BatchNorm) + act,
    then a body of depth - 2 convs ('conv') or max(1, (depth - 2) // 2)
    residual conv pairs h + res_scale * bn(conv(act(bn(conv(h))))) with no
    act after the pair ('resblock'), then a 1x1 conv + sigmoid tail. Body
    convs are kernel_size x kernel_size with SAME padding, so patch
    geometry and residual shapes stay. `use_bn` puts a `FlaxBatchNorm2d`
    after every conv but the tail: in train mode it normalizes with the
    batch's statistics and updates its running ones, in eval mode it uses
    them. Modules carry the flax names (head, head_bn, body_{i},
    body_bn_{i}, block{b}_conv{0,1}, block{b}_bn{0,1}, tail).
    """

    def __init__(self, input_dim: int, depth: int = 6, width: int = 64,
                 output_dim: int = 3, kernel_size: int = 3,
                 body_arch: str = "resblock", use_bn: bool = False,
                 act: str = "relu", res_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if body_arch not in ("conv", "resblock"):
            raise ValueError(f"R2LConvNet: unknown body_arch {body_arch!r}")
        self.input_dim, self.depth, self.width = input_dim, depth, width
        self.output_dim, self.kernel_size = output_dim, kernel_size
        self.body_arch, self.use_bn, self.act = body_arch, use_bn, act
        self.res_scale, self.dtype = res_scale, dtype
        self._act = get_activation(act) or nn.Identity()

        def conv(name, c_in, c_out, k=kernel_size):
            self.add_module(name, nn.Conv2d(c_in, c_out, k, padding="same"))

        def bn(name):
            if use_bn:
                self.add_module(name, FlaxBatchNorm2d(width, dtype))

        conv("head", input_dim, width, 1)
        bn("head_bn")
        if body_arch == "conv":
            for i in range(depth - 2):
                conv(f"body_{i}", width, width)
                bn(f"body_bn_{i}")
        else:
            for b in range(self._n_block()):
                for j in range(2):
                    conv(f"block{b}_conv{j}", width, width)
                    bn(f"block{b}_bn{j}")
        conv("tail", width, output_dim, 1)

    def _n_block(self) -> int:
        return max(1, (self.depth - 2) // 2)

    def _conv(self, name: str, h: torch.Tensor) -> torch.Tensor:
        """The conv `name` in the compute dtype, as flax's Conv with dtype."""
        layer, dt = getattr(self, name), self.dtype
        return F.conv2d(h.to(dt), layer.weight.to(dt), layer.bias.to(dt), padding="same")

    def _bn(self, name: str, h: torch.Tensor) -> torch.Tensor:
        return getattr(self, name)(h) if self.use_bn else h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = self._act
        h = act(self._bn("head_bn", self._conv("head", x.permute(0, 3, 1, 2))))
        if self.body_arch == "conv":
            for i in range(self.depth - 2):
                h = act(self._bn(f"body_bn_{i}", self._conv(f"body_{i}", h)))
        else:
            for b in range(self._n_block()):
                g = act(self._bn(f"block{b}_bn0", self._conv(f"block{b}_conv0", h)))
                g = self._bn(f"block{b}_bn1", self._conv(f"block{b}_conv1", g))
                h = g * self.res_scale + h
        return torch.sigmoid(self._conv("tail", h)).permute(0, 2, 3, 1).float()

    def load_jax_params(self, params_np, batch_stats_np=None) -> "R2LConvNet":
        """Load the JAX R2LConvNet's `params` (and `batch_stats`) trees,
        leaves as numpy arrays."""
        self.load_state_dict(conv_state_dict_from_jax(params_np, batch_stats_np))
        return self
