"""Sharded training-step builders, after `efficient_nerf_tpu.parallel.train`
(:29-78).

The JAX package jits the single-chip steps with shardings and lets GSPMD
insert the gradient all-reduce. Here the steps themselves take the mesh
(`train.steps`, `mesh=`): each rank computes its rows of the global batch
with the per-card kernels, and one all_reduce of one flat bucket sums the
gradients and the losses over 'data' before Adam. Build every rank's state
alike (same seed) or call `replicate_state` once before the first step.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike
from ..train.hard_mining import HardPool
from ..train.steps import TrainState, make_r2l_train_step, make_teacher_train_step
from .mesh import Mesh

__all__ = ["replicate_state", "make_sharded_r2l_train_step",
           "make_sharded_teacher_train_step"]


def _broadcast(mesh: Mesh, t: torch.Tensor) -> None:
    """t, in place, from the first rank of this rank's 'data' group."""
    grp = mesh.group("data")
    buf = t if t.device == mesh.device else t.to(mesh.device)
    dist.broadcast(buf, src=dist.get_global_rank(grp, 0), group=grp)
    if buf is not t:
        t.copy_(buf)


def replicate_state(mesh: Mesh, state: TrainState, pool: Optional[HardPool] = None):
    """Make every data rank's state the first data rank's, in place: the
    model's parameters and buffers, the optimizer's state tensors (Adam's
    moments and step counts) and the pool's rows and fill count. With a
    tensor-parallel model each model coordinate broadcasts its own slices.
    Returns state, or (state, pool)."""
    with torch.no_grad():
        for t in list(state.model.parameters()) + list(state.model.buffers()):
            _broadcast(mesh, t)
        for p in (p for g in state.optimizer.param_groups for p in g["params"]):
            for v in state.optimizer.state.get(p, {}).values():
                if torch.is_tensor(v):
                    _broadcast(mesh, v)
    if pool is None:
        return state
    count = torch.tensor([pool.count], dtype=torch.int64, device=mesh.device)
    _broadcast(mesh, count)
    _broadcast(mesh, pool.rays)
    return state, HardPool(pool.rays, int(count.item()))


def make_sharded_r2l_train_step(model, optimizer: torch.optim.Optimizer, mesh: Mesh, *,
                                near: float, far: float, n_sample: int,
                                hard: Optional[Tuple[int, int]] = None, **kw):
    """`make_r2l_train_step(..., mesh=mesh)` on the mesh's device.

    step(state, pool, generator, rays_o, rays_d, target, noise=None), with
    this rank's rows of the batch (`shard_batch`). The flagship profile runs
    the fused training kernels on every data rank's rows; with n_model > 1
    fused defaults to False (the tensor-parallel forward is unfused), as the
    JAX package pins it (:61-62).
    """
    if mesh.n_model > 1:
        kw.setdefault("fused", False)
    kw.setdefault("device", mesh.device)
    return make_r2l_train_step(model, optimizer, near=near, far=far, n_sample=n_sample,
                               hard=hard, mesh=mesh, **kw)


def make_sharded_teacher_train_step(model, model_fine, optimizer: torch.optim.Optimizer,
                                    mesh: Mesh, cfg, hwf=None, schedule=None,
                                    device: DeviceLike = None):
    """`make_teacher_train_step(..., mesh=mesh)` on the mesh's device:
    step(state, generator, rays_o, rays_d, target, noise=None) with this
    rank's rows; the draws are the global batch's, the metrics global."""
    return make_teacher_train_step(model, model_fine, optimizer, cfg, hwf=hwf,
                                   schedule=schedule,
                                   device=mesh.device if device is None else device,
                                   mesh=mesh)
