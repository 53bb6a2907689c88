"""Model/optimizer construction from parsed args, after
`efficient_nerf_tpu.factory` (create_nerf parity, reference main.py:407-553).

Models are `nn.Module`s on the device, in `--compute_dtype` (their
parameters stay f32), initialised from a fixed seed without touching the
process's random state. The optimizer is `torch.optim.Adam` (fused on a
card) whose lr the train step sets from `train/schedules.py` before each
update; `--freeze_pretrained` takes an optimizer that updates nothing, as
`optax.set_to_zero()` does. --pretrained_ckpt takes the port's `.tar`,
the reference's (with its pickled module) or the JAX package's ENTPUCK1
file (train/checkpoints.py); with `--resume` the step, the best PSNR and
the Adam state come back. `input_dim`, `flops_per_pixel` and `n_params` are the
JAX package's numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from .core.encoding import nerf_embed_dim, ray_embed_dim
from .device import DeviceLike, resolve_device
from .models import (NeRFMLP, R2LConvNet, R2LNet, nerf_flops_per_pixel,
                     r2l_flops_per_pixel)
from .render.renderer import RenderConfig
from .train.checkpoints import import_reference_checkpoint
from .train.schedules import make_lr_schedule, parse_warmup
from .utils.meters import count_params

__all__ = ["Bundle", "create_models", "render_config_from_args"]


class Bundle(NamedTuple):
    model: torch.nn.Module      # nerf: ModuleDict {'coarse', 'fine'?}; r2l: the student
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    cfg_train: RenderConfig
    cfg_test: RenderConfig
    history: Dict[str, Any]     # start / best_psnr / best_psnr_step
    restored_opt_state: Any     # the optimizer's state_dict when --resume, else None
    input_dim: int              # r2l network input dim (0 for nerf)
    flops_per_pixel: float
    n_params: int
    device: torch.device


class _Frozen(torch.optim.Optimizer):
    """--freeze_pretrained: the reference leaves frozen parameters out of
    grad_vars (main.py:461), the JAX package updates by zero; so does this."""

    def __init__(self, params):
        super().__init__(params, {"lr": 0.0})

    def step(self, closure=None):
        return None


def render_config_from_args(args, near: float, far: float) -> RenderConfig:
    ndc = (args.dataset_type == "llff") and not args.no_ndc
    return RenderConfig(
        n_samples=args.N_samples,
        n_importance=args.N_importance,
        perturb=args.perturb > 0,
        lindisp=bool(args.lindisp) and not ndc,
        white_bkgd=bool(args.white_bkgd),
        raw_noise_std=float(args.raw_noise_std),
        use_viewdirs=bool(args.use_viewdirs),
        multires=args.multires,
        multires_views=args.multires_views,
        ndc=ndc,
        near=float(near),
        far=float(far),
        chunk=args.chunk,
        fast_embed=not getattr(args, "exact_embed", False),
        # --no_pallas: every teacher render takes the unfused path, even
        # where eval_mode() turns fused_teacher on
        kernels=not getattr(args, "no_pallas", False),
    )


def _compute_dtype(args) -> torch.dtype:
    return (torch.bfloat16 if getattr(args, "compute_dtype", "f32") == "bf16"
            else torch.float32)


def _r2l_from_args(args, input_dim: int) -> torch.nn.Module:
    trial_on = getattr(args.trial, "ON", False)
    body_arch = args.trial.body_arch if trial_on else "mlp"
    out_dim = {"": 3, "depth": 4, "surface": 6}[getattr(args, "learn_depth", "") or ""]
    if getattr(args, "data_mode", "") == "patches":
        # the conv student of the 16x16patches/3x3rays shards (reference
        # --body_arch/--use_bn/--kernel_size, option.py:297-304)
        return R2LConvNet(
            input_dim=input_dim, depth=args.netdepth, width=args.netwidth,
            output_dim=out_dim, kernel_size=args.kernel_size,
            body_arch=args.body_arch, use_bn=bool(args.use_bn), act=args.act,
            res_scale=args.trial.res_scale if trial_on else 1.0,
            dtype=_compute_dtype(args))
    return R2LNet(
        input_dim=input_dim, depth=args.netdepth, width=args.netwidth,
        output_dim=out_dim,
        n_block=args.trial.n_block if trial_on else -1,
        n_learnable=args.trial.n_learnable if trial_on else 2,
        body_arch=body_arch, act=args.act,
        inact=args.trial.inact if trial_on else "relu",
        outact=args.trial.outact if trial_on else "none",
        res_scale=args.trial.res_scale if trial_on else 1.0,
        use_residual=bool(args.use_residual),
        linear_tail=bool(args.linear_tail),
        layerwise_widths=tuple(int(x) for x in args.layerwise_netwidths.split(","))
        if args.layerwise_netwidths else (),
        dtype=_compute_dtype(args))


def _nerf_from_args(args) -> Tuple[torch.nn.ModuleDict, int, int, Tuple[int, ...]]:
    input_ch = nerf_embed_dim(3, args.multires) if args.i_embed != -1 else 3
    input_ch_views = nerf_embed_dim(3, args.multires_views) if args.use_viewdirs else 0
    skips = tuple(int(s) for s in str(args.skips).split(","))
    kw = dict(input_ch=input_ch, input_ch_views=input_ch_views, skips=skips,
              use_viewdirs=bool(args.use_viewdirs), dtype=_compute_dtype(args))
    nets = {"coarse": NeRFMLP(depth=args.netdepth, width=args.netwidth,
                              output_ch=5 if args.N_importance > 0 else 4, **kw)}
    if args.N_importance > 0:
        nets["fine"] = NeRFMLP(depth=args.netdepth_fine, width=args.netwidth_fine,
                               output_ch=5, **kw)
    return torch.nn.ModuleDict(nets), input_ch, input_ch_views, skips


def create_models(args, near: float, far: float, device: DeviceLike = None,
                  seed: int = 0) -> Bundle:
    """The models of args.model_name on `device` (default CUDA), their
    optimizer and lr schedule, the train and test render configs, and the
    checkpoint's history when --pretrained_ckpt is given."""
    dev = resolve_device(device)
    cfg_train = render_config_from_args(args, near, far)
    cfg_test = cfg_train.eval_mode()
    if args.perturb_test > 0:
        cfg_test = dataclasses.replace(cfg_test, perturb=True)
    if getattr(args, "teacher_quant", ""):
        # eval/pseudo-gen serving mode only (no backward): cfg_train stays ''
        cfg_test = dataclasses.replace(cfg_test, teacher_quant=args.teacher_quant)

    # a fixed init that leaves the process's random state alone
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if args.model_name == "nerf":
            model, input_ch, input_ch_views, skips = _nerf_from_args(args)
            input_dim = 0
            flops = nerf_flops_per_pixel(
                args.netdepth, args.netwidth, input_ch, input_ch_views, skips,
                bool(args.use_viewdirs), args.N_samples, args.N_importance)
        else:
            if args.plucker:
                input_dim = 6 * (2 * args.multires + 1)
            else:
                input_dim = ray_embed_dim(args.n_sample_per_ray * 3, args.multires)
            model = _r2l_from_args(args, input_dim)
            trial_on = getattr(args.trial, "ON", False)
            flops = r2l_flops_per_pixel(
                input_dim, args.netdepth, args.netwidth,
                n_block=args.trial.n_block if trial_on else -1,
                n_learnable=args.trial.n_learnable if trial_on else 2)
    model = model.to(dev)

    schedule = make_lr_schedule(args.lrate, args.lrate_decay, parse_warmup(args.warmup_lr))
    if getattr(args, "freeze_pretrained", False):
        optimizer = _Frozen(model.parameters())
    else:
        optimizer = torch.optim.Adam(model.parameters(), lr=schedule(0), betas=(0.9, 0.999),
                                     eps=1e-8, fused=dev.type == "cuda")

    history = {"start": 0, "best_psnr": 0.0, "best_psnr_step": 0}
    restored_opt_state = None
    if args.pretrained_ckpt:
        meta = import_reference_checkpoint(args.pretrained_ckpt, model, optimizer)
        if args.resume:
            history = {"start": meta["step"], "best_psnr": meta["best_psnr"],
                       "best_psnr_step": meta["best_psnr_step"]}
            restored_opt_state = meta["optimizer_state_dict"]
    return Bundle(model, optimizer, schedule, cfg_train, cfg_test, history,
                  restored_opt_state, input_dim, flops, count_params(model), dev)

