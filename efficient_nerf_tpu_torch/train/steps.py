"""The R2L student's training step, after
`efficient_nerf_tpu.train.steps.make_r2l_train_step` (:40-185).

One step: draw the hard rows and append them to the batch, sample the
points (perturbed), compute the MSE loss, take the gradient, run one Adam
update at this step's learning rate, and mine the pool. The JAX package
builds one jitted program with donated buffers; the port runs eagerly and
updates in place: the model's parameters, the optimizer's state and the
pool's rows change where they lie, and the returned TrainState and HardPool
name the same objects.

On a CUDA device the flagship profile goes through the fused training
kernels (`ops.r2l_train_apply`, csrc/r2l_train.cu); on the CPU the unfused
`R2LNet` autograd path runs, as the JAX package takes XLA off the TPU.
`mesh` and `interpret` are not ported: multi-GPU training is ROADMAP queue
1 item 10, and the kernels' plain versions take interpret mode's place.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.encoding import ray_embed
from ..core.ray_sampler import sample_ray_points
from ..core.rays import plucker_rays
from ..device import DeviceLike, resolve_device
from ..ops import fused_r2l_train_available
from ..ops.r2l_train import r2l_train_apply, train_profile_eligible
from .hard_mining import HardPool, pick_hard_rays, update_hard_pool

__all__ = ["TrainState", "init_train_state", "make_r2l_train_step",
           "mse_to_psnr"]


class TrainState(NamedTuple):
    model: torch.nn.Module            # parameters, updated in place
    optimizer: torch.optim.Optimizer  # Adam state, updated in place
    step: int                         # updates taken so far


def init_train_state(model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer) -> TrainState:
    return TrainState(model, optimizer, 0)


def mse_to_psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def make_r2l_train_step(model, optimizer: torch.optim.Optimizer, *,
                        near: float, far: float, n_sample: int, L: int = 10,
                        perturb: bool = True, lw_rgb: float = 1.0,
                        learn_depth: bool = False, lw_depth: float = 0.1,
                        plucker: bool = False,
                        hard: Optional[Tuple[int, int]] = None,
                        fast_embed: bool = True, fused: Optional[bool] = None,
                        schedule: Optional[Callable[[int], float]] = None,
                        device: DeviceLike = None):
    """Build the R2L distillation step.

    step(state, pool, generator, rays_o, rays_d, target, noise=None) ->
        (state, pool, metrics)

    target is [B, 3] rgb ([B, 4] with depth when learn_depth); hard is
    (n_hard_in, n_hard_out) or None. metrics holds 0-dim tensors loss_rgb,
    loss_depth and psnr on the device (reading them waits for the step).

    The optimizer is `torch.optim.Adam(model.parameters(), betas=(0.9,
    0.999), eps=1e-8)` as the JAX package's factory builds optax.adam
    (factory.py:126-127); on the card pass `fused=True`, whose one kernel
    beats the default's per-tensor launches at D88's 176 tensors. It sees
    the gradients as autograd returns them (the fused backward's body
    gradients are views of one buffer). With a schedule, each param group's
    lr is set to schedule(state.step) before the update: optax evaluates
    the schedule at the update count before it increments, so step 0 runs
    at schedule(0).

    fused: the fused training kernels. None takes them on a CUDA device for
    the eligible profile (steps.py:83-94), and the unfused path otherwise;
    the kernels take bf16 operands (model.dtype), so an eligible model of
    another dtype on the card raises ValueError unless fused=False. True on
    an ineligible model raises ValueError; True on the CPU runs the kernels'
    plain versions.
    The fused apply embeds in the kernel (embed_L = L when fast_embed) and
    skips the input gradient (need_dx=False): the points are data.

    noise: an optional dict with 't_rand' [B_aug, n_sample], 'idx_out' and
    'batch_idx' [n_hard_out] that replaces the generator's draws, so that a
    test can feed the JAX step's own random numbers.
    """
    dev = resolve_device(device)
    if next(model.parameters()).device != dev:
        raise ValueError(f"model is on {next(model.parameters()).device}, "
                         f"training on {dev}: move the model with model.to(device)")
    if fused is None or fused:
        eligible = train_profile_eligible(model)
        if fused and not eligible:
            raise ValueError("fused train step requires the uniform "
                             "scan-body R2LNet profile")
        on_card = fused_r2l_train_available(dev)
        if eligible and on_card and model.dtype != torch.bfloat16:
            raise ValueError("the fused training kernels take bf16 operands: "
                             "build the model with dtype=torch.bfloat16, or "
                             "pass fused=False for the unfused R2LNet path")
        # off the card the plain versions run, in any dtype
        fused = eligible and (bool(fused) or on_card)

    def forward(pts: torch.Tensor) -> torch.Tensor:
        if fused:
            return r2l_train_apply(model, pts if fast_embed else ray_embed(pts, L),
                                   embed_L=L if fast_embed else 0, need_dx=False)
        return model(ray_embed(pts, L, fast=fast_embed))

    def step(state: TrainState, pool: Optional[HardPool],
             generator: Optional[torch.Generator], rays_o: torch.Tensor,
             rays_d: torch.Tensor, target: torch.Tensor,
             noise: Optional[Dict[str, torch.Tensor]] = None):
        noise = noise or {}
        batch_size = rays_o.shape[0]
        idx_out = None
        if hard is not None:
            n_hard_in, n_hard_out = hard
            rows = torch.cat([rays_o, rays_d, target], -1)
            picked, idx_out = pick_hard_rays(
                pool, generator, rows, n_hard_out,
                idx_out=noise.get("idx_out"), batch_idx=noise.get("batch_idx"))
            rays_o = torch.cat([rays_o, picked[:, :3]], 0)
            rays_d = torch.cat([rays_d, picked[:, 3:6]], 0)
            target = torch.cat([target, picked[:, 6:]], 0)

        if plucker:
            pts = plucker_rays(rays_o, rays_d)
        else:
            pts = sample_ray_points(rays_o, rays_d, near, far, n_sample,
                                    perturb=perturb, generator=generator,
                                    t_rand=noise.get("t_rand"))
        out = forward(pts)
        per_ray_mse = torch.mean((out[:, :3] - target[:, :3]) ** 2, dim=-1)
        loss_rgb = torch.mean(per_ray_mse) * lw_rgb
        loss = loss_rgb
        loss_d = torch.zeros((), device=out.device)
        if learn_depth:
            loss_d = torch.mean((out[:, 3:] - target[:, 3:]) ** 2)
            loss = loss + loss_d * lw_depth

        # the gradients go to the optimizer as autograd returns them: the
        # fused backward's body gradients stay views of its one buffer,
        # where backward() would copy each into .grad
        params = [p for group in optimizer.param_groups for p in group["params"]]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = g
        if schedule is not None:
            lr = schedule(state.step)
            for group in optimizer.param_groups:
                group["lr"] = lr
        optimizer.step()

        if hard is not None:
            rows_aug = torch.cat([rays_o, rays_d, target], -1)
            pool = update_hard_pool(pool, rows_aug, per_ray_mse, idx_out,
                                    hard[0], batch_size)

        loss_rgb = loss_rgb.detach()
        metrics = {"loss_rgb": loss_rgb, "loss_depth": loss_d.detach(),
                   "psnr": mse_to_psnr(loss_rgb / lw_rgb)}
        return state._replace(step=state.step + 1), pool, metrics

    return step
