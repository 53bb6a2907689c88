"""Plain PyTorch reference of the NeRF teacher (Mildenhall et al., ECCV 2020)
at the lego configuration: a coarse and a fine D8 W256 MLP (the embedded
point joins the hidden state again after layer 4; an alpha head, a feature
head, one W/2 layer over [feature, embedded direction], an rgb head), points
embedded as [x, sin(2^j x), cos(2^j x), ...], alpha compositing over a white
background, and fine depths by the inverse CDF of the coarse weights.
Float32 with TF32 off; `tf32` runs the products in TF32 for the control.

Its training step is the coarse and the fine MSE over the rays, with the
fine depths held constant, then Adam. The weights come from `init_params`,
which the benchmark calls once and hands to both sides; the parameter names
are the reference state_dict's.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ._plain import (Adam, leaf_norms, linear, linspace, lr_at, octave_sincos, precision,
                     stratify)

Params = Dict[str, torch.Tensor]
NETS = ("coarse", "fine")


def leaf_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, std) of one network's parameters, in the module's
    order: kernels lecun-normal, biases 0.01."""
    w, c, cv, b_std = cfg["width"], cfg["input_ch"], cfg["input_ch_views"], cfg["init"]["bias_std"]

    def lin(name, d_in, d_out):
        return [(f"{name}.weight", (d_out, d_in), d_in ** -0.5), (f"{name}.bias", (d_out,), b_std)]

    out = lin("pts_linears.0", c, w)
    for i in range(cfg["depth"] - 1):
        out += lin(f"pts_linears.{i + 1}", w + c if i in cfg["skips"] else w, w)
    out += lin("feature_linear", w, w) + lin("alpha_linear", w, 1)
    out += lin("views_linears.0", w + cv, w // 2) + lin("rgb_linear", w // 2, 3)
    return out


def init_params(cfg: Dict, generator: torch.Generator) -> Dict[str, Params]:
    """Both networks' parameters from one normal draw on the generator's
    device."""
    leaves = leaf_shapes(cfg) * len(NETS)
    sizes = [int(np.prod(s)) for _, s, _ in leaves]
    flat = torch.randn(sum(sizes), generator=generator, device=generator.device)
    std = torch.repeat_interleave(
        torch.tensor([s for _, _, s in leaves], device=flat.device),
        torch.tensor(sizes, device=flat.device))
    parts = torch.split(flat * std, sizes)
    n = len(leaves) // len(NETS)
    return {net: {name: t.view(shape) for (name, shape, _), t in
                  zip(leaves[i * n:(i + 1) * n], parts[i * n:(i + 1) * n])}
            for i, net in enumerate(NETS)}


def embed(x: torch.Tensor, L: int, recurrence: bool = False) -> torch.Tensor:
    """[..., d] -> [..., d (2L + 1)]: x, then sin(2^j x) and cos(2^j x) for
    each j < L; `recurrence`: the octaves by the double-angle recurrence,
    as the configuration's fast embed states."""
    sin, cos = octave_sincos(x, L, recurrence)                 # [..., d, L]
    sc = torch.stack([sin.movedim(-1, -2), cos.movedim(-1, -2)], -2)   # [..., L, 2, d]
    return torch.cat([x, sc.reshape(x.shape[:-1] + (-1,))], -1)


def field(p: Params, pts_emb: torch.Tensor, dirs_emb: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """raw [..., 4]: pre-sigmoid rgb and pre-relu density."""
    def lin(x, name):
        return linear(x, p[f"{name}.weight"], p[f"{name}.bias"])

    h = pts_emb
    for i in range(cfg["depth"]):
        h = torch.relu(lin(h, f"pts_linears.{i}"))
        if i in cfg["skips"]:
            h = torch.cat([pts_emb, h], -1)
    alpha = lin(h, "alpha_linear")
    feat = lin(h, "feature_linear")
    h = torch.relu(lin(torch.cat([feat, dirs_emb], -1), "views_linears.0"))
    return torch.cat([lin(h, "rgb_linear"), alpha], -1)


def composite(raw, z, rays_d, white_bkgd: bool):
    """(rgb [N, 3], weights [N, S]) by alpha compositing; the last interval
    is 1e10 long."""
    dists = torch.cat([z[..., 1:] - z[..., :-1], torch.full_like(z[..., :1], 1e10)], -1)
    dists = dists * torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                     1.0 - alpha[..., :-1] + 1e-10], -1), -1)
    weights = alpha * trans
    rgb = torch.sum(weights[..., None] * torch.sigmoid(raw[..., :3]), -2)
    if white_bkgd:
        rgb = rgb + (1.0 - weights.sum(-1, keepdim=True))
    return rgb, weights


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Depths at levels u [N, n] of the piecewise-linear inverse CDF of
    weights [N, C-1] over bin edges [N, C] (each weight raised by 1e-5; a
    bin under 1e-5 of the mass counts as width 1)."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, -1)], -1)
    idx = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = (idx - 1).clamp(0, cdf.shape[-1] - 1)
    above = idx.clamp(0, cdf.shape[-1] - 1)
    c0, c1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    b0, b1 = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = torch.where(c1 - c0 < 1e-5, torch.ones_like(c0), c1 - c0)
    return b0 + (u - c0) / denom * (b1 - b0)


def render_rays(p: Dict[str, Params], rays_o, rays_d, cfg: Dict, t_rand, u,
                recurrence: bool = False):
    """(fine rgb, coarse rgb) of rays [N, 3]: coarse depths stratified by
    t_rand, fine levels u; embeds by the recurrence with `recurrence`."""
    n = rays_o.shape[0]
    viewdirs = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    dirs_emb = embed(viewdirs, cfg["multires_views"], recurrence)
    z = stratify(linspace(cfg["near"], cfg["far"], cfg["n_samples"], rays_o.device).expand(n, -1),
                 t_rand)

    def run(net, z):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        d = dirs_emb[:, None, :].expand(pts.shape[:-1] + dirs_emb.shape[-1:])
        raw = field(p[net], embed(pts, cfg["multires"], recurrence), d, cfg)
        return composite(raw, z, rays_d, cfg["white_bkgd"])

    rgb0, w0 = run("coarse", z)
    z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
    z_fine = sample_pdf(z_mid, w0[..., 1:-1], u).detach()
    z_all = torch.sort(torch.cat([z, z_fine], -1), -1).values
    rgb, _ = run("fine" if cfg["fine_network"] else "coarse", z_all)
    return rgb, rgb0


def train_steps(params0: Dict[str, Params], batches: Sequence, noises: Sequence[Dict],
                cfg: Dict, tf32: bool = False, drop_half: bool = False) -> Dict:
    """The teacher's steps from params0 on the given batches (host arrays
    rays_o, rays_d, rgb) and draws ('t_rand', 'u'): the coarse plus the fine
    MSE (over the first half of the rays alone with drop_half, the fault of
    a batch half left out), then Adam at the step's lr; the embed by the
    recurrence where train.fast_embed says so. Returns the losses, the fine
    MSEs and each step's fine and coarse rgb, each leaf's gradient norm at the first
    step and its change norm after the last, leaves named
    '<net>.<parameter>'."""
    device = params0["coarse"]["pts_linears.0.weight"].device
    train = cfg["train"]
    p = {net: {k: v.detach().clone().float() for k, v in sub.items()}
         for net, sub in params0.items()}
    flat = {f"{net}.{k}": v for net, sub in p.items() for k, v in sub.items()}
    opt = Adam(flat, train["betas"], train["eps"])
    losses, fine_losses, fine_rgb, coarse_rgb, grad_norms = [], [], [], [], None
    with precision(tf32):
        for k, (batch, noise) in enumerate(zip(batches, noises)):
            o, d, tgt = (torch.as_tensor(a, dtype=torch.float32, device=device) for a in batch)
            t_rand, u = noise["t_rand"], noise["u"]
            if drop_half:
                h = o.shape[0] // 2
                o, d, tgt, t_rand, u = o[:h], d[:h], tgt[:h], t_rand[:h], u[:h]
            for v in flat.values():
                v.requires_grad_(True)
            rgb, rgb0 = render_rays(p, o, d, cfg, t_rand, u, train["fast_embed"])
            fine = torch.mean((rgb - tgt) ** 2)
            loss = fine + torch.mean((rgb0 - tgt) ** 2)
            grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
            for v in flat.values():
                v.requires_grad_(False)
            losses.append(float(loss.detach()))
            fine_losses.append(float(fine.detach()))
            fine_rgb.append(rgb.detach().cpu())
            coarse_rgb.append(rgb0.detach().cpu())
            if grad_norms is None:
                grad_norms = leaf_norms(grads)
            opt.step(grads, lr_at(train, k))
    change = {f"{net}.{k}": p[net][k] - params0[net][k].float()
              for net in p for k in p[net]}
    return {"losses": losses, "fine_losses": fine_losses, "fine_rgb": fine_rgb,
            "coarse_rgb": coarse_rgb,
            "grad_norms": grad_norms, "change_norms": leaf_norms(change)}
