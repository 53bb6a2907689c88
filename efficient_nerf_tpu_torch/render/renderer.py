"""The teacher's volumetric renderer (coarse + hierarchical fine pass), after
`efficient_nerf_tpu.render.renderer`.

Rays are (o, d) pairs with near/far from the config (or per call); viewdirs
are the normalized rays_d taken BEFORE the NDC projection. Random draws come
from a `torch.Generator` or through the hooks `t_rand=`, `u=` and `noise=`
(the coarse pass's sigma noise), as the JAX package's golden tests feed them.

Dispatch follows the JAX package's eligibility: the teacher profile (viewdir
branch, one input skip, embed widths that match the config) with
`cfg.fused_teacher` (on in `eval_mode()` unless exact embeds are asked for)
evaluates the field with `ops.nerf_forward_fused`, and, for deterministic
levels (no `u`, no perturb), draws the fine depths with
`ops.sample_pdf_det_fused`. `teacher_quant="int8"` evaluates every field
with `ops.nerf_forward_int8` instead, whether or not `fused_teacher` is on,
after calibrating static activation scales on the first 1024 points of the
call (`ops.calibrate_nerf_int8`). `frame_fused` with the deterministic eval
profile (no int8, scalar config near/far, no hooks, 16 or more samples a
pass, multiples of 8) renders the whole ray batch with
`ops.nerf_render_rays_fused`. The device then picks: a CUDA tensor launches
the kernel, a CPU tensor runs its plain version. A deliberate divergence:
the JAX package takes its XLA path off the TPU, where its Pallas kernels are
unavailable (for int8 its jnp twin, which is the port's plain version too);
here the CPU runs the kernels' plain versions, so that the tests hold the
eval path that runs on the card against the JAX package's fused path (its
Pallas kernels in interpret mode). Everything else (the training profile,
`u`, perturbed sampling, other models) takes the unfused path: `nerf_embed`
-> `NeRFMLP` -> `raw2outputs`, `core.sampling.sample_pdf`.

The card's kernels take bf16 weights: on a CUDA tensor the kernel paths pack
the teacher's weights in bf16, whatever its compute dtype, and the module
itself keeps its own (a divergence: the JAX package's Pallas kernels run the
model's own dtype). On the CPU the plain versions take the model's dtype.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..core.encoding import nerf_embed
from ..core.rays import get_rays, ndc_rays
from ..core.sampling import linear_zvals, merge_sorted, sample_pdf, stratify_zvals
from ..core.volume import raw2outputs
from ..device import DeviceLike, resolve_device
from ..ops import (calibrate_nerf_int8, nerf_forward_fused, nerf_forward_int8,
                   nerf_render_rays_fused, pack_nerf_weights, pack_nerf_weights_int8,
                   sample_pdf_det_fused)
from ..utils.profiling import span
from ._pack_cache import cached_pack

__all__ = ["RenderConfig", "RenderResult", "render_rays", "render_image",
           "make_ray_renderer"]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Rendering options, the JAX package's fields and defaults."""

    n_samples: int = 64
    n_importance: int = 128
    perturb: bool = True          # stratified jitter of coarse depths
    lindisp: bool = False
    white_bkgd: bool = False
    raw_noise_std: float = 0.0
    use_viewdirs: bool = True
    multires: int = 10            # positional-encoding L for points
    multires_views: int = 4       # positional-encoding L for view dirs
    ndc: bool = False
    near: float = 2.0
    far: float = 6.0
    chunk: int = 32768            # rays per render_rays call in render_image
    # the fused field eval (inference only); eval_mode() turns it on
    fused_teacher: bool = False
    # double-angle-recurrence encoding on the unfused path
    fast_embed: bool = True
    # '' | 'int8': the W8A8 teacher field eval (eval only)
    teacher_quant: str = ""
    # the whole-ray teacher kernel (deterministic eval only); its two tiling
    # options below tune the Pallas kernel and are kept for the JAX
    # package's field set: the CUDA kernel picks its own rays a block, and
    # nothing reads them
    frame_fused: bool = False
    frame_tile_r: int = 256
    frame_eval_chunks: int = 4
    # the port's counterpart of the JAX driver's --no_pallas (an environment
    # variable there): False takes the unfused path for every field eval
    # and fine sampling, whatever fused_teacher and frame_fused say, and
    # teacher_quant='int8', which has no unfused path, raises
    kernels: bool = True

    def eval_mode(self) -> "RenderConfig":
        """Test-time variant: no jitter, no sigma noise, and the fused field
        eval unless the config pins exact embeds (fast_embed=False)."""
        return dataclasses.replace(
            self, perturb=False, raw_noise_std=0.0,
            fused_teacher=self.fused_teacher or self.fast_embed)


class RenderResult(NamedTuple):
    rgb: torch.Tensor
    disp: torch.Tensor
    acc: torch.Tensor
    depth: torch.Tensor
    # coarse-pass outputs (meaningful when n_importance > 0)
    rgb0: torch.Tensor
    disp0: torch.Tensor
    acc0: torch.Tensor
    z_std: torch.Tensor


def _check_modes(cfg: RenderConfig) -> None:
    if cfg.teacher_quant not in ("", "int8"):
        raise ValueError(f"unknown teacher_quant {cfg.teacher_quant!r}")
    if cfg.teacher_quant and not cfg.kernels:
        raise ValueError("teacher_quant='int8' runs the int8 field-eval kernel; "
                         "with kernels=False (--no_pallas) there is none to run")


def _teacher_profile_ok(model, cfg: RenderConfig) -> bool:
    """The teacher kernel covers the reference profile: viewdir branch, one
    input skip before a following pts layer, embed widths matching the
    config."""
    skips = tuple(getattr(model, "skips", ()))
    return (cfg.use_viewdirs
            and getattr(model, "use_viewdirs", False)
            and len(skips) == 1
            and 0 <= skips[0] < model.depth - 1
            and model.input_ch == 3 * (2 * cfg.multires + 1)
            and model.input_ch_views == 3 * (2 * cfg.multires_views + 1))


def _nerf_profile_ok(model, cfg: RenderConfig) -> bool:
    return cfg.kernels and cfg.fused_teacher and _teacher_profile_ok(model, cfg)


def _pack_dtype(model, on_card: bool) -> torch.dtype:
    """The kernels' weight dtype: bf16 on the card, where the kernels take
    nothing else; the model's own for the plain versions on the CPU."""
    return torch.bfloat16 if on_card else model.dtype


def _packed(model, on_card: bool) -> dict:
    """The model's kernel operands in `_pack_dtype`, kept on the model and
    made again when a parameter or the pack's dtype changes (`cached_pack`)."""
    dtype = _pack_dtype(model, on_card)
    return cached_pack(model, "_nerf_pack", (model.skips[0], dtype),
                       lambda: pack_nerf_weights(model.state_dict(), skip=model.skips[0],
                                                 dtype=dtype))


def _packed_int8(model, on_card: bool):
    """(the int8 kernel's operands in `_pack_dtype`, an f32 pack that the
    per-call calibration reads), kept as `_packed` keeps its pack."""
    dtype = _pack_dtype(model, on_card)

    def make():
        sd, skip = model.state_dict(), model.skips[0]
        return (pack_nerf_weights_int8(sd, skip, dtype),
                pack_nerf_weights(sd, skip, torch.float32))
    return cached_pack(model, "_nerf_pack_int8", (model.skips[0], dtype), make)


def _frame_fused_eligible(model, cfg: RenderConfig, near, far, t_rand, u, noise) -> bool:
    """The whole-ray kernel's profile (the JAX package's
    `_frame_fused_eligible`, :141-155, without its TPU gate): deterministic
    eval with the config's scalar near/far and no determinism hooks."""
    return (cfg.frame_fused and not cfg.teacher_quant
            and _nerf_profile_ok(model, cfg)
            and cfg.n_importance >= 16 and cfg.n_samples >= 16
            and cfg.n_samples % 8 == 0 and cfg.n_importance % 8 == 0
            and not cfg.perturb and cfg.raw_noise_std == 0.0
            and near is None and far is None
            and t_rand is None and u is None and noise is None)


def _no_autograd(path: str, models, *tensors) -> None:
    """The kernels have no backward: a kernel path asked for while autograd
    would track its inputs raises instead of returning outputs that carry
    no gradient. Training takes the unfused path (fused_teacher,
    teacher_quant and frame_fused off, as the JAX package's training config
    has them); evaluation runs under torch.no_grad(), as render_image does."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.requires_grad for t in tensors) or any(
            p.requires_grad for m in models for p in m.parameters()):
        raise RuntimeError(
            f"the teacher's {path} has no backward, and autograd is tracking its "
            f"inputs: train with fused_teacher, teacher_quant and frame_fused off, "
            f"or evaluate under torch.no_grad()")


def _render_frame(model, model_fine, rays_o, rays_d, viewdirs,
                  cfg: RenderConfig) -> RenderResult:
    """render_rays through the whole-ray kernel."""
    if model_fine is not None and not _teacher_profile_ok(model_fine, cfg):
        raise ValueError("nerf_render_rays_fused requires matching coarse/fine "
                         "architectures; the fine model is not the teacher profile")
    models = (model,) if model_fine is None else (model, model_fine)
    _no_autograd("whole-ray kernel (frame_fused)", models, rays_o, rays_d, viewdirs)
    card = rays_o.is_cuda
    out = nerf_render_rays_fused(
        _packed(model, card), None if model_fine is None else _packed(model_fine, card),
        rays_o.contiguous(), rays_d.contiguous(), viewdirs.contiguous(), cfg.near,
        cfg.far, cfg.n_samples, cfg.n_importance, cfg.multires, cfg.multires_views,
        white_bkgd=cfg.white_bkgd, lindisp=cfg.lindisp)
    return RenderResult(*out)


def _query_int8(model, pts, viewdirs, cfg: RenderConfig) -> torch.Tensor:
    """teacher_quant='int8' (the JAX package's `_query_int8`, :158-180):
    static scales calibrated on the first 1024 points of this very call, in
    ray-major order, then the W8A8 field eval. pts [N, S, 3] -> raw."""
    if not _teacher_profile_ok(model, cfg):
        raise ValueError("teacher_quant=int8 requires the standard viewdir teacher profile")
    _no_autograd("int8 field eval (teacher_quant='int8')", (model,), pts, viewdirs)
    packed, packed_f32 = _packed_int8(model, pts.is_cuda)
    scales = calibrate_nerf_int8(packed_f32, pts.reshape(-1, 3)[:1024], cfg.multires)
    return nerf_forward_int8(packed, pts.contiguous(), viewdirs.contiguous(), cfg.multires,
                             cfg.multires_views, act_scales=scales)


def _query(model, pts, viewdirs, cfg: RenderConfig) -> torch.Tensor:
    """The unfused field eval: embed the points (+ dirs), run the MLP.
    pts [N, S, 3]; viewdirs [N, 3] or None -> raw [N, S, 4]."""
    emb = nerf_embed(pts, cfg.multires, fast=cfg.fast_embed)
    if cfg.use_viewdirs:
        dirs = nerf_embed(viewdirs, cfg.multires_views, fast=cfg.fast_embed)
        dirs = dirs[..., None, :].expand(pts.shape[:-1] + (dirs.shape[-1],))
        emb = torch.cat([emb, dirs], dim=-1)
    return model(emb)


def _field(model, rays_o, rays_d, z_vals, viewdirs, cfg: RenderConfig,
           fused: bool) -> torch.Tensor:
    """raw [N, S, 4] at the depths z_vals [N, S] along the rays."""
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    if cfg.teacher_quant:
        return _query_int8(model, pts, viewdirs, cfg)
    if not fused:
        return _query(model, pts, viewdirs, cfg)
    _no_autograd("fused field eval (fused_teacher)", (model,), pts, viewdirs)
    return nerf_forward_fused(_packed(model, pts.is_cuda), pts.contiguous(),
                              viewdirs.contiguous(), cfg.multires,
                              cfg.multires_views)


def render_rays(model, model_fine, rays_o: torch.Tensor, rays_d: torch.Tensor,
                viewdirs: Optional[torch.Tensor], cfg: RenderConfig, near=None,
                far=None, t_rand=None, u=None, noise=None, noise_fine=None,
                generator: Optional[torch.Generator] = None) -> RenderResult:
    """Render rays [N, 3] through the coarse and fine fields, on the rays'
    device (the models must be there too).

    model_fine=None renders the fine pass with `model`. near/far override
    the config (scalars or per-ray [N, 1]). t_rand [N, n_samples], u [N,
    n_importance] and noise [N, n_samples] are the determinism hooks; noise
    is the coarse pass's sigma noise, as in the JAX package (the fine pass
    draws its own from `generator` when raw_noise_std > 0, or takes
    noise_fine [N, n_samples + n_importance], which the sharded teacher step
    hands in: its rows of the global batch's draws).

    The unfused path is differentiable in the models' parameters (the fine
    depths are detached, as the JAX package stops their gradient); a kernel
    path raises RuntimeError while autograd tracks its inputs.

    Spans on the composed path (`utils.profiling.span`): render.coarse (the
    depths, the field, raw2outputs), render.fine_depths (the sampler and the
    merge), render.fine.
    """
    _check_modes(cfg)
    if _frame_fused_eligible(model, cfg, near, far, t_rand, u, noise):
        return _render_frame(model, model_fine, rays_o, rays_d, viewdirs, cfg)
    n_rays = rays_o.shape[0]
    dev = rays_o.device
    near = cfg.near if near is None else near
    far = cfg.far if far is None else far
    model_f = model_fine if model_fine is not None else model

    with span("render.coarse"):
        z_vals = linear_zvals(near, far, cfg.n_samples, cfg.lindisp, device=dev)
        z_vals = z_vals.expand(n_rays, cfg.n_samples)
        if cfg.perturb:
            z_vals = stratify_zvals(z_vals, t_rand, generator)

        fused = _nerf_profile_ok(model, cfg)
        raw = _field(model, rays_o, rays_d, z_vals, viewdirs, cfg, fused)
        coarse = raw2outputs(raw, z_vals, rays_d, cfg.raw_noise_std, cfg.white_bkgd,
                             noise=noise, generator=generator)

    if cfg.n_importance <= 0:
        zeros = torch.zeros((n_rays,), dtype=rays_o.dtype, device=dev)
        return RenderResult(coarse.rgb, coarse.disp, coarse.acc, coarse.depth,
                            coarse.rgb, coarse.disp, coarse.acc, zeros)

    with span("render.fine_depths"):
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        w_mid = coarse.weights[..., 1:-1]
        if fused and u is None and not cfg.perturb:
            z_samples = sample_pdf_det_fused(z_mid.contiguous(), w_mid.contiguous(),
                                             cfg.n_importance)
        else:
            z_samples = sample_pdf(z_mid, w_mid, cfg.n_importance,
                                   det=not cfg.perturb, u=u, sorted_u=True,
                                   generator=generator)
        z_samples = z_samples.detach()
        if u is None:
            # both sorted per ray: the bitonic merge, as the JAX package
            z_all = merge_sorted(z_vals, z_samples)
        else:
            # the hook's levels come in any order
            z_all = torch.sort(torch.cat([z_vals, z_samples], -1), dim=-1).values

    with span("render.fine"):
        fused_f = _nerf_profile_ok(model_f, cfg)
        raw = _field(model_f, rays_o, rays_d, z_all, viewdirs, cfg, fused_f)
        fine = raw2outputs(raw, z_all, rays_d, cfg.raw_noise_std, cfg.white_bkgd,
                           noise=noise_fine, generator=generator)
    z_std = torch.std(z_samples, dim=-1, correction=0)  # jnp.std's ddof 0
    return RenderResult(fine.rgb, fine.disp, fine.acc, fine.depth,
                        coarse.rgb, coarse.disp, coarse.acc, z_std)


def _prep_full_image_rays(H: int, W: int, focal: float, c2w, cfg: RenderConfig,
                          dev: torch.device):
    rays_o, rays_d = get_rays(H, W, focal, c2w, device=dev)
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    viewdirs = None
    if cfg.use_viewdirs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if cfg.ndc:
        rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    return rays_o, rays_d, viewdirs


def render_chunks(model, model_fine, rays_o, rays_d, viewdirs, cfg: RenderConfig,
                  generator: Optional[torch.Generator] = None) -> RenderResult:
    """render_rays over cfg.chunk rays at a time (the last chunk ragged:
    rays are independent), without autograd; outputs concatenated."""
    n = rays_o.shape[0]
    chunk = min(cfg.chunk, n)
    parts = []
    with torch.no_grad():
        for s in range(0, n, chunk):
            vd = viewdirs[s:s + chunk] if viewdirs is not None else None
            parts.append(render_rays(model, model_fine, rays_o[s:s + chunk],
                                     rays_d[s:s + chunk], vd, cfg,
                                     generator=generator))
    return RenderResult(*[torch.cat(xs) for xs in zip(*parts)])


def make_ray_renderer(model, cfg: RenderConfig):
    """Chunk renderer closure: (model_fine, rays_o, rays_d, viewdirs,
    generator=None) -> RenderResult. PyTorch runs eagerly, so there is
    nothing to compile."""

    def fn(model_fine, rays_o, rays_d, viewdirs, generator=None):
        return render_rays(model, model_fine, rays_o, rays_d, viewdirs, cfg,
                           generator=generator)

    return fn


def render_image(model, model_fine, H: int, W: int, focal: float, c2w,
                 cfg: RenderConfig, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None) -> RenderResult:
    """Render a full H x W image on `device` (default CUDA) in chunks of
    cfg.chunk rays; outputs are [H, W, ...]. c2w: numpy or tensor, [3, 4]
    or [4, 4]."""
    dev = resolve_device(device)
    rays_o, rays_d, viewdirs = _prep_full_image_rays(H, W, focal, c2w, cfg, dev)
    res = render_chunks(model, model_fine, rays_o, rays_d,
                        viewdirs if cfg.use_viewdirs else None, cfg, generator)
    return RenderResult(*[x.reshape((H, W) + x.shape[1:]) for x in res])
