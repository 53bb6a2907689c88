"""The tensor-parallel R2LNet forward over the mesh's 'model' axis, with
Megatron's conjugate pair of autograd Functions.

JAX gets this forward from GSPMD: the specs of `_tp_spec_for_path` make XLA
insert one all-gather after the head and one psum after each block's second
linear. Here each rank holds the slices of `mesh.shard_params_tp` and runs

    head (output slice) -> all_gather -> per block:
        copy_to_model -> linear 0 (output slice) -> act -> linear 1 (input
        slice) -> reduce_from_model -> + bias -> residual
    -> tail (replicated)

`copy_to_model` is the identity forward and an all_reduce of the gradient
backward; `reduce_from_model` the all_reduce forward and the identity
backward. `torch.distributed.nn.functional.all_reduce` all-reduces in its
backward as well, which under a loss that every model rank computes alike
would count each gradient n_model times; hence the pair by hand. The
partial sums are reduced in float32 and rounded to the compute dtype once.
This path is unfused (cuBLAS linears): the fused kernels take whole weights.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import Mesh

__all__ = ["tp_r2l_forward"]


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    y = x.float().contiguous()   # a copy for narrower dtypes; cloned below otherwise
    if y is x:
        y = y.clone()
    dist.all_reduce(y, group=group)
    return y


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """[n, c] column slices -> [n, n_model * c] in model order; the backward
    keeps this rank's columns of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group, n_model: int, index: int):
        ctx.index, ctx.c = index, x.shape[1]
        xf = x.float().contiguous()
        parts = [torch.empty_like(xf) for _ in range(n_model)]
        dist.all_gather(parts, xf, group=group)
        return torch.cat(parts, 1).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        c = ctx.c
        return g[:, ctx.index * c:(ctx.index + 1) * c].contiguous(), None, None, None


def tp_r2l_forward(model, mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """R2LNet.forward (resmlp body) on this rank's tensor-parallel slices:
    x [n, in_dim] embedded rays, the same rows on every model rank -> [n,
    out_dim] float32, alike on every model rank."""
    grp, dt = mesh.group("model"), model.dtype

    def lin(layer, h, bias=True):
        return F.linear(h.to(dt), layer.weight.to(dt),
                        layer.bias.to(dt) if bias else None)

    x = lin(model.head[0], x)
    if len(model.head) > 1:
        x = model.head[1](x)
    x = _GatherFromModel.apply(x, grp, mesh.n_model, mesh.model_index)
    h = x
    for blk in model.body:
        l0, act, l1 = blk.body
        g = act(lin(l0, _CopyToModel.apply(h, grp)))
        g = (_ReduceFromModel.apply(lin(l1, g, bias=False), grp)
             + l1.bias.float()).to(dt)
        h = g * blk.res_scale + h
        if blk.outact is not None:
            h = blk.outact(h)
    x = h + x if model.use_residual else h
    if model.linear_tail:
        x = lin(model.tail, x)
    else:
        x = model.tail[1](lin(model.tail[0], x))
    return x.float()
