"""The training steps: the R2L student's, after
`efficient_nerf_tpu.train.steps.make_r2l_train_step` (:40-185), the conv
student's over patches, after `make_patch_train_step` (:188-245), and the
NeRF teacher's, after `make_teacher_train_step` (:248-308).

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
`interpret` is not ported: on CPU tensors the kernels' plain versions take
interpret mode's place.

`mesh` (a `parallel.Mesh`) runs the R2L and the teacher step over the ranks
of a process group and computes the single step on the global batch, as
GSPMD gives the JAX package: every rank draws the global batch's random
numbers from a generator seeded alike, computes the loss's share of its
rows, and the gradients and losses are summed over 'data' in one all_reduce
before Adam. Without a mesh the same code runs with no collective.

The teacher's step runs `render.render_rays` under autograd on its unfused
path (`nerf_embed` -> `NeRFMLP`, cuBLAS products on the card): the JAX
package's training config turns on neither the fused field eval nor the
int8 teacher, and the kernels have no backward.

Spans (`utils.profiling.span`): train.r2l_step around the R2L step, with
train.hard_pick, train.sample, train.forward (forward and loss),
train.backward, train.adam and train.mine inside; train.teacher_step around
the teacher's, with train.backward and train.adam inside.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.encoding import ray_embed
from ..core.ray_sampler import sample_patch_points, sample_ray_points
from ..core.rays import ndc_rays, plucker_rays
from ..core.sampling import sorted_uniform
from ..device import DeviceLike, resolve_device
from ..ops import fused_r2l_train_available
from ..ops.r2l_train import r2l_train_apply, train_profile_eligible
from ..render.renderer import RenderConfig, render_rays
from ..utils.profiling import span
from .hard_mining import HardPool, pick_hard_rays, update_hard_pool

__all__ = ["TrainState", "init_train_state", "make_r2l_train_step",
           "make_patch_train_step", "make_teacher_train_step", "mse_to_psnr"]


class TrainState(NamedTuple):
    # parameters, updated in place; the teacher's coarse and fine models
    # as an nn.ModuleDict({"coarse": ..., "fine": ...})
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer  # Adam state, updated in place
    step: int                         # updates taken so far


def init_train_state(model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer) -> TrainState:
    return TrainState(model, optimizer, 0)


def mse_to_psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def _check_device(model: torch.nn.Module, dev: torch.device) -> None:
    if next(model.parameters()).device != dev:
        raise ValueError(f"model is on {next(model.parameters()).device}, "
                         f"training on {dev}: move the model with model.to(device)")


def _set_lr(optimizer: torch.optim.Optimizer, schedule, step: int) -> None:
    """Each param group's lr at schedule(step): optax evaluates the schedule
    at the update count before it increments, so step 0 runs at
    schedule(0)."""
    if schedule is not None:
        lr = schedule(step)
        for group in optimizer.param_groups:
            group["lr"] = lr


def _rank_rows(mesh, n: int) -> Tuple[int, int]:
    """This rank's rows [lo, hi) of n global rows: the block of its data
    coordinate, as JAX's P("data") places them (all n without a mesh)."""
    if mesh is None:
        return 0, n
    if n % mesh.n_data:
        raise ValueError(f"{n} rows a step do not divide over {mesh.n_data} "
                         "data ranks")
    k = n // mesh.n_data
    return mesh.data_index * k, (mesh.data_index + 1) * k


def make_r2l_train_step(model, optimizer: torch.optim.Optimizer, *,
                        near: float, far: float, n_sample: int, L: int = 10,
                        perturb: bool = True, lw_rgb: float = 1.0,
                        learn_depth: bool = False, lw_depth: float = 0.1,
                        plucker: bool = False,
                        hard: Optional[Tuple[int, int]] = None,
                        fast_embed: bool = True, fused: Optional[bool] = None,
                        schedule: Optional[Callable[[int], float]] = None,
                        device: DeviceLike = None, mesh=None):
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

    mesh: a `parallel.Mesh`, the counterpart of the JAX step's mesh
    argument (steps.py:57, :112-123). The step then takes
    this rank's rows of the batch (`parallel.shard_batch`), gathers the
    global [B, 9] rows over 'data', draws from `generator` (seeded alike on
    every rank) what the single step draws, in its order, on the global
    shapes (noise, if given, holds global draws), and computes rows [d
    B_aug / n_data, (d + 1) B_aug / n_data) of the augmented batch: B_aug =
    B + n_hard_out must divide over 'data' (ValueError). Its loss share is
    sum(per_ray_mse) / B_aug, so that the sum over 'data' of the gradients
    and losses, one all_reduce of one flat bucket, is the single step's;
    per_ray_mse is gathered over 'data' and every rank mines the global rows
    into its replica of the pool. The device must be the mesh's. With
    n_model > 1 the model holds `parallel.shard_params_tp`'s slices and runs
    the tensor-parallel forward (`parallel.tp`), unfused: fused=True raises
    ValueError, as the JAX package pins its XLA path there.
    """
    dev = resolve_device(device)
    _check_device(model, dev)
    if mesh is not None and mesh.device != dev:
        raise ValueError(f"the mesh computes on {mesh.device}, the step on {dev}")
    tp = mesh is not None and mesh.n_model > 1
    if tp:
        if fused:
            raise ValueError("tensor parallelism runs the unfused path: the fused "
                             "training kernels take whole weights")
        fused = False
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

    if mesh is not None:
        # imported here: parallel.train imports this module
        from ..parallel.mesh import all_reduce_bucket, gather_batch
        from ..parallel.tp import tp_r2l_forward

    def forward(pts: torch.Tensor) -> torch.Tensor:
        if fused:
            return r2l_train_apply(model, pts if fast_embed else ray_embed(pts, L),
                                   embed_L=L if fast_embed else 0, need_dx=False)
        x = ray_embed(pts, L, fast=fast_embed)
        return tp_r2l_forward(model, mesh, x) if tp else model(x)

    def step(state: TrainState, pool: Optional[HardPool],
             generator: Optional[torch.Generator], rays_o: torch.Tensor,
             rays_d: torch.Tensor, target: torch.Tensor,
             noise: Optional[Dict[str, torch.Tensor]] = None):
        with span("train.r2l_step"):
            return _step(state, pool, generator, rays_o, rays_d, target, noise or {})

    def _step(state, pool, generator, rays_o, rays_d, target, noise):
        if mesh is not None:
            rows = gather_batch(mesh, torch.cat([rays_o, rays_d, target], -1))
            rays_o, rays_d, target = rows[:, :3], rows[:, 3:6], rows[:, 6:]
        batch_size = rays_o.shape[0]
        idx_out = None
        if hard is not None:
            with span("train.hard_pick"):
                n_hard_in, n_hard_out = hard
                rows = torch.cat([rays_o, rays_d, target], -1)
                picked, idx_out = pick_hard_rays(
                    pool, generator, rows, n_hard_out,
                    idx_out=noise.get("idx_out"), batch_idx=noise.get("batch_idx"))
                rays_o = torch.cat([rays_o, picked[:, :3]], 0)
                rays_d = torch.cat([rays_d, picked[:, 3:6]], 0)
                target = torch.cat([target, picked[:, 6:]], 0)

        with span("train.sample"):
            if plucker:
                pts = plucker_rays(rays_o, rays_d)
            else:
                pts = sample_ray_points(rays_o, rays_d, near, far, n_sample,
                                        perturb=perturb, generator=generator,
                                        t_rand=noise.get("t_rand"))
        with span("train.forward"):
            lo, hi = _rank_rows(mesh, pts.shape[0])
            share = (hi - lo) / pts.shape[0]   # 1.0 without a mesh
            out = forward(pts[lo:hi])
            tgt = target[lo:hi]
            per_ray_mse = torch.mean((out[:, :3] - tgt[:, :3]) ** 2, dim=-1)
            loss_rgb = torch.mean(per_ray_mse) * share * lw_rgb
            loss = loss_rgb
            loss_d = torch.zeros((), device=out.device)
            if learn_depth:
                loss_d = torch.mean((out[:, 3:] - tgt[:, 3:]) ** 2) * share
                loss = loss + loss_d * lw_depth

        # the gradients go to the optimizer as autograd returns them: the
        # fused backward's body gradients stay views of its one buffer,
        # where backward() would copy each into .grad
        params = [p for group in optimizer.param_groups for p in group["params"]]
        with span("train.backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        loss_rgb, loss_d = loss_rgb.detach(), loss_d.detach()
        if mesh is not None:
            *grads, loss_rgb, loss_d = all_reduce_bucket(mesh, [*grads, loss_rgb, loss_d])
        with span("train.adam"):
            for p, g in zip(params, grads):
                p.grad = g
            _set_lr(optimizer, schedule, state.step)
            optimizer.step()

        if hard is not None:
            with span("train.mine"):
                if mesh is not None:
                    per_ray_mse = gather_batch(mesh, per_ray_mse.detach())
                rows_aug = torch.cat([rays_o, rays_d, target], -1)
                pool = update_hard_pool(pool, rows_aug, per_ray_mse, idx_out,
                                        hard[0], batch_size)

        metrics = {"loss_rgb": loss_rgb, "loss_depth": loss_d,
                   "psnr": mse_to_psnr(loss_rgb / lw_rgb)}
        return state._replace(step=state.step + 1), pool, metrics

    return step


def make_patch_train_step(model, optimizer: torch.optim.Optimizer, *,
                          near: float, far: float, n_sample: int, L: int = 10,
                          perturb: bool = True, lw_rgb: float = 1.0,
                          fast_embed: bool = True,
                          schedule: Optional[Callable[[int], float]] = None,
                          device: DeviceLike = None):
    """Build the conv student's step over patches (`R2LConvNet`, the
    consumer of the 16x16patches / 3x3rays / rand_tworays shards).

    step(state, generator, rays_o, rays_d, target, t_rand=None) ->
        (state, metrics)

    rays and target are [N, ph, pw, 3]. The stratified jitter draws one
    uniform a patch (`sample_patch_points`) from `generator`, or takes
    t_rand [N] (the tests hand in the JAX step's draws). The model runs in
    train mode: a BatchNorm normalizes with the batch's statistics and
    updates its running ones in place (the JAX step threads flax's
    batch_stats collection through instead). No kernel covers a conv body,
    in either package: this is the unfused autograd path on every device.
    metrics: loss_rgb, loss_depth (zero) and psnr, 0-dim tensors.
    """
    dev = resolve_device(device)
    _check_device(model, dev)

    def step(state: TrainState, generator: Optional[torch.Generator],
             rays_o: torch.Tensor, rays_d: torch.Tensor, target: torch.Tensor,
             t_rand: Optional[torch.Tensor] = None):
        model.train()
        pts = sample_patch_points(rays_o, rays_d, near, far, n_sample,
                                  perturb=perturb, generator=generator, t_rand=t_rand)
        rgb = model(ray_embed(pts, L, fast=fast_embed))
        loss_rgb = torch.mean((rgb - target) ** 2) * lw_rgb
        optimizer.zero_grad(set_to_none=True)
        loss_rgb.backward()
        _set_lr(optimizer, schedule, state.step)
        optimizer.step()
        loss_rgb = loss_rgb.detach()
        metrics = {"loss_rgb": loss_rgb, "loss_depth": torch.zeros((), device=loss_rgb.device),
                   "psnr": mse_to_psnr(loss_rgb / lw_rgb)}
        return state._replace(step=state.step + 1), metrics

    return step


def make_teacher_train_step(model, model_fine, optimizer: torch.optim.Optimizer,
                            cfg: RenderConfig,
                            hwf: Optional[Tuple[int, int, float]] = None,
                            schedule: Optional[Callable[[int], float]] = None,
                            device: DeviceLike = None, mesh=None):
    """Build the NeRF teacher's step (coarse + fine MSE losses).

    step(state, generator, rays_o, rays_d, target, noise=None) ->
        (state, metrics)

    state = init_train_state(nn.ModuleDict({"coarse": model, "fine":
    model_fine}), optimizer), with the optimizer over both models'
    parameters: `torch.optim.Adam(..., betas=(0.9, 0.999))` as the JAX
    package's factory builds optax.adam. model_fine=None trains one network
    for both passes, as the JAX step does when the params have no 'fine'.
    The models and the optimizer are updated in place; with a schedule, the
    lr is schedule(state.step) for this update. metrics holds 0-dim tensors
    on the device: loss (fine MSE, plus the coarse MSE when n_importance >
    0) and psnr (of the fine MSE alone).

    rays_o/rays_d [B, 3] are RAW world rays in every mode. With cfg.ndc the
    step applies the projection itself: viewdirs are normalised from the
    PRE-NDC world dirs, then o/d are projected before z is sampled in [0,
    1] (reference main.py:148-162); hwf=(H, W, focal) is required for that.

    cfg is the training config: perturbed sampling, and the unfused field
    eval (a kernel path raises under autograd, render_rays). generator
    draws the sampling's random numbers on the device; noise, an optional
    dict with 't_rand' [B, n_samples], 'u' [B, n_importance] and 'noise'
    [B, n_samples] (the coarse pass's sigma noise), replaces those draws
    through render_rays' hooks, so that a test can feed the JAX step's own
    random numbers. The fine pass's sigma noise (raw_noise_std > 0) comes
    from `generator` unless noise holds 'noise_fine' [B, n_samples +
    n_importance].

    mesh: a `parallel.Mesh` with n_model 1 (ValueError otherwise). The
    rays are then this rank's rows of a global batch of n_data times as
    many; the step draws the global batch's t_rand, sigma noise and u from
    `generator` (seeded alike on every rank) in the single step's order and
    shapes, or takes them from noise (global draws, the fine pass's as
    'noise_fine'), and renders its rows of them (with u handed in,
    render_rays sorts the merged depths instead of its bitonic merge: the
    same values). Each mean is scaled by
    1 / n_data, and the gradients and the losses are summed over 'data' in
    one all_reduce before Adam: the single step's on the global batch.
    """
    dev = resolve_device(device)
    for m in (model,) if model_fine is None else (model, model_fine):
        _check_device(m, dev)
    if cfg.ndc and hwf is None:
        raise ValueError("cfg.ndc requires hwf=(H, W, focal) so the step "
                         "can project raw rays itself")
    has_fine = cfg.n_importance > 0
    if mesh is not None:
        if mesh.n_model > 1 or mesh.device != dev:
            raise ValueError(f"the teacher step shards over 'data' on its own "
                             f"device: mesh {mesh.shape} on {mesh.device}, step on {dev}")
        from ..parallel.mesh import all_reduce_bucket

    def global_draws(n: int, generator, noise):
        """The single step's draws on n rays, in its order: t_rand
        (stratify_zvals), the coarse sigma noise (raw2outputs), u
        (sample_pdf's sorted_uniform) and the fine sigma noise."""
        S, n_imp, std = cfg.n_samples, cfg.n_importance, cfg.raw_noise_std
        noise = dict(noise)
        if cfg.perturb and "t_rand" not in noise:
            noise["t_rand"] = torch.rand((n, S), generator=generator, device=dev)
        if std > 0.0 and "noise" not in noise:
            noise["noise"] = torch.randn((n, S), generator=generator, device=dev) * std
        if has_fine and cfg.perturb and "u" not in noise:
            noise["u"] = sorted_uniform((n, n_imp), generator, device=dev)
        if has_fine and std > 0.0 and "noise_fine" not in noise:
            noise["noise_fine"] = torch.randn((n, S + n_imp), generator=generator,
                                              device=dev) * std
        return noise

    def step(state: TrainState, generator: Optional[torch.Generator],
             rays_o: torch.Tensor, rays_d: torch.Tensor, target: torch.Tensor,
             noise: Optional[Dict[str, torch.Tensor]] = None):
        with span("train.teacher_step"):
            return _step(state, generator, rays_o, rays_d, target, noise or {})

    def _step(state, generator, rays_o, rays_d, target, noise):
        share = 1.0
        if mesh is not None:
            lo, hi = _rank_rows(mesh, rays_o.shape[0] * mesh.n_data)
            noise = {k: v[lo:hi] for k, v in
                     global_draws(rays_o.shape[0] * mesh.n_data, generator, noise).items()}
            share = 1.0 / mesh.n_data
        viewdirs = None
        if cfg.use_viewdirs:
            viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        ro, rd = rays_o, rays_d
        if cfg.ndc:
            H, W, focal = hwf
            ro, rd = ndc_rays(H, W, focal, 1.0, ro, rd)
        res = render_rays(model, model_fine, ro, rd, viewdirs, cfg,
                          t_rand=noise.get("t_rand"), u=noise.get("u"),
                          noise=noise.get("noise"), noise_fine=noise.get("noise_fine"),
                          generator=generator)
        loss_fine = torch.mean((res.rgb - target) ** 2) * share
        loss = loss_fine
        if has_fine:
            loss = loss + torch.mean((res.rgb0 - target) ** 2) * share
        optimizer.zero_grad(set_to_none=True)
        with span("train.backward"):
            loss.backward()
        loss, loss_fine = loss.detach(), loss_fine.detach()
        if mesh is not None:
            params = [p for group in optimizer.param_groups for p in group["params"]]
            *grads, loss, loss_fine = all_reduce_bucket(
                mesh, [p.grad for p in params] + [loss, loss_fine])
            for p, g in zip(params, grads):
                p.grad = g
        with span("train.adam"):
            _set_lr(optimizer, schedule, state.step)
            optimizer.step()
        metrics = {"loss": loss, "psnr": mse_to_psnr(loss_fine)}
        return state._replace(step=state.step + 1), metrics

    return step
