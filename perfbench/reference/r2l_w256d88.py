"""Plain PyTorch reference of the R2L student (Wang et al., ECCV 2022):
a ray's 16 points along [near, far], each coordinate embedded as [sin(2^j
k), cos(2^j k), k], a head linear with relu, residual blocks h + res_scale *
W2 relu(W1 h), a global residual, and a sigmoid tail. Float32 with TF32 off,
exact sines and cosines; `kind` runs every linear layer in a lower precision
for the control. Its distillation step is the MSE over the batch and its hard
rows, Adam, and the hard-ray pool.

`kind` "int8" is the published W8A8 serving recipe (`forward_int`): each
body linear on int8 weights with one scale per output row and int8
activations under static scales that `static_scales` works out from a
float32 forward over calibration rays; head and tail stay float32. "int4"
is the same one step below, body weights on a 4-bit grid: the control.

The weights come from `init_params`, which the benchmark calls once and
hands to both sides; the parameter names are the reference state_dict's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ._plain import (Adam, get_rays, leaf_norms, linear, linspace, lr_at, octave_sincos,
                     precision, stratify, written_rows)

Params = Dict[str, torch.Tensor]

# largest weight level of each integer grid of the body; activations are
# int8 (ACT_LEVELS) in both
WEIGHT_LEVELS = {"int8": 127, "int4": 7}
ACT_LEVELS = 127
# static scales sit this far above the calibration rays' largest value
CAL_MARGIN = 1.02


def leaf_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, std) of every parameter, in the module's order: kernels
    lecun-normal, each block's second linear times its scale, biases 0.01."""
    w, b_std = cfg["width"], cfg["init"]["bias_std"]
    out = [("head.0.weight", (w, cfg["input_dim"]), cfg["input_dim"] ** -0.5),
           ("head.0.bias", (w,), b_std)]
    for b in range(cfg["n_block"]):
        for j in range(cfg["n_learnable"]):
            scale = cfg["init"]["second_linear_scale"] if j == cfg["n_learnable"] - 1 else 1.0
            out += [(f"body.{b}.body.{2 * j}.weight", (w, w), w ** -0.5 * scale),
                    (f"body.{b}.body.{2 * j}.bias", (w,), b_std)]
    out += [("tail.0.weight", (cfg["output_dim"], w), w ** -0.5),
            ("tail.0.bias", (cfg["output_dim"],), b_std)]
    return out


def init_params(cfg: Dict, generator: torch.Generator) -> Params:
    """Every parameter from one normal draw on the generator's device."""
    leaves = leaf_shapes(cfg)
    sizes = [int(np.prod(s)) for _, s, _ in leaves]
    flat = torch.randn(sum(sizes), generator=generator, device=generator.device)
    std = torch.repeat_interleave(
        torch.tensor([s for _, _, s in leaves], device=flat.device),
        torch.tensor(sizes, device=flat.device))
    flat = flat * std
    return {name: t.view(shape) for (name, shape, _), t in
            zip(leaves, torch.split(flat, sizes))}


def embed(x: torch.Tensor, L: int, recurrence: bool = False) -> torch.Tensor:
    """[..., K] -> [..., K * (2L + 1)], each scalar k as [sin(2^j k) for j <
    L, cos(2^j k) for j < L, k]; `recurrence`: the octaves by the
    double-angle recurrence, as the configuration's fast embed states."""
    sin, cos = octave_sincos(x, L, recurrence)
    out = torch.cat([sin, cos, x[..., None]], -1)
    return out.reshape(x.shape[:-1] + (-1,))


def ray_points(rays_o, rays_d, cfg: Dict, t_rand=None) -> torch.Tensor:
    z = linspace(cfg["near"], cfg["far"], cfg["n_sample"], rays_o.device)
    z = z.expand(rays_o.shape[:-1] + z.shape)
    if t_rand is not None:
        z = stratify(z, t_rand)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., None]
    return pts.reshape(pts.shape[:-2] + (-1,))


def forward(p: Params, x: torch.Tensor, cfg: Dict, kind: Optional[str] = None) -> torch.Tensor:
    h = torch.relu(linear(x, p["head.0.weight"], p["head.0.bias"], kind))
    x0 = h
    for b in range(cfg["n_block"]):
        g = h
        for j in range(cfg["n_learnable"]):
            if j:
                g = torch.relu(g)
            g = linear(g, p[f"body.{b}.body.{2 * j}.weight"], p[f"body.{b}.body.{2 * j}.bias"],
                       kind)
        h = h + cfg["res_scale"] * g
    if cfg["use_residual"]:
        h = h + x0
    return torch.sigmoid(linear(h, p["tail.0.weight"], p["tail.0.bias"], kind))


def _true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    # a tensor divisor: on a card torch multiplies by the reciprocal of a
    # Python scalar one, an ulp off the division the recipe states
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def quantize_rows(w: torch.Tensor, levels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [N, K] -> (integer levels as float32 [N, K], scales [N]): one scale
    a row of nn.Linear's [out, in] weight, max |w| / levels, each level
    round(w / scale) clamped to +-levels."""
    s = _true_div(w.abs().amax(-1).clamp_min(1e-12), levels)
    return torch.clamp(torch.round(w / s[:, None]), -levels, levels), s


def _act_levels(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), -ACT_LEVELS, ACT_LEVELS)


def _body(b: int, j: int) -> str:
    return f"body.{b}.body.{2 * j}"


@torch.no_grad()
def static_scales(p: Params, rays_o, rays_d, cfg: Dict) -> torch.Tensor:
    """[n_block, 2] static activation scales of the integer recipes: a
    float32 forward over the calibration rays records each block's largest
    |input| and largest inner activation (after the relu); each scale is
    that maximum times CAL_MARGIN over ACT_LEVELS."""
    maxes = []
    with precision():
        x = embed(ray_points(rays_o, rays_d, cfg), cfg["multires"])
        h = torch.relu(linear(x, p["head.0.weight"], p["head.0.bias"]))
        for b in range(cfg["n_block"]):
            g = torch.relu(linear(h, p[_body(b, 0) + ".weight"], p[_body(b, 0) + ".bias"]))
            maxes.append(torch.stack([h.abs().amax(), g.abs().amax()]))
            h = h + cfg["res_scale"] * linear(g, p[_body(b, 1) + ".weight"],
                                              p[_body(b, 1) + ".bias"])
    return torch.stack(maxes) * (CAL_MARGIN / ACT_LEVELS)


def quantized_body(p: Params, cfg: Dict, kind: str) -> Dict[str, Tuple]:
    """Each body linear's (levels, row scales) on `kind`'s weight grid, from
    the float32 weights (the configuration's dtype is the one it computes
    in; the checkpoint is float32)."""
    return {_body(b, j): quantize_rows(p[_body(b, j) + ".weight"], WEIGHT_LEVELS[kind])
            for b in range(cfg["n_block"]) for j in range(cfg["n_learnable"])}


def forward_int(p: Params, qbody: Dict[str, Tuple], x: torch.Tensor, cfg: Dict,
                act_scales: torch.Tensor) -> torch.Tensor:
    """The integer recipe's forward on the weights `p` and the body `qbody`
    (`quantized_body`): a float32 head; in each block the input to
    int8 levels under its static scale, the product of the integer levels in
    float32 (exact: every partial sum is below 2^24), each sum times the
    activation's and the weight row's scale plus the bias, the relu, the
    inner activation to int8 levels under its scale, the second product the
    same way, the residual; the global residual, a float32 tail. Where the
    kernel departs: its head and tail take bf16 operands and its embed the
    double-angle recurrence; it multiplies by the reciprocal of a scale
    where this divides, and folds the inner scale into the first epilogue
    (relu(t) / s equals relu(t / s)): an ulp apart, which moves a level
    only on a tie."""
    h = torch.relu(linear(x, p["head.0.weight"], p["head.0.bias"]))
    x0 = h
    for b in range(cfg["n_block"]):
        g = h
        for j in range(cfg["n_learnable"]):
            if j:
                g = torch.relu(g)
            s = act_scales[b, j]
            q, sw = qbody[_body(b, j)]
            g = (_act_levels(g / s) @ q.t()) * (s * sw) + p[_body(b, j) + ".bias"]
        h = h + cfg["res_scale"] * g
    if cfg["use_residual"]:
        h = h + x0
    return torch.sigmoid(linear(h, p["tail.0.weight"], p["tail.0.bias"]))


@torch.no_grad()
def render_rays(p: Params, rays_o, rays_d, cfg: Dict, kind: Optional[str] = None,
                block: int = 32768, act_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, out] float32 of the rays: kind None the float32 network, "fp8"
    every linear on that grid, "int8" / "int4" the integer recipe under
    `act_scales` (`static_scales`)."""
    out = []
    with precision():
        if kind in WEIGHT_LEVELS:
            qbody = quantized_body(p, cfg, kind)
            net = lambda x: forward_int(p, qbody, x, cfg, act_scales)  # noqa: E731
        else:
            net = lambda x: forward(p, x, cfg, kind)  # noqa: E731
        for s in range(0, rays_o.shape[0], block):
            out.append(net(embed(ray_points(rays_o[s:s + block], rays_d[s:s + block], cfg),
                                 cfg["multires"])))
    return torch.cat(out)


def render_frame(p: Params, c2w, H: int, W: int, focal: float, cfg: Dict,
                 kind: Optional[str] = None,
                 act_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[H, W, 3] float32 of one camera."""
    device = next(iter(p.values())).device
    rays_o, rays_d = get_rays(c2w, H, W, focal, device)
    return render_rays(p, rays_o, rays_d, cfg, kind, act_scales=act_scales).reshape(H, W, -1)


def train_steps(params0: Params, batches: Sequence, noises: Sequence[Dict], cfg: Dict,
                hard: Tuple[int, int], pool_rows: int, kind: Optional[str] = None,
                drop_half: bool = False, batch_pick: bool = False,
                block: int = 16384) -> Dict:
    """The distillation steps from params0 on the given batches (host arrays
    rays_o, rays_d, rgb) and draws ('t_rand' of the augmented batch,
    'idx_out', 'batch_idx'). Each step appends n_hard_out rows (from the
    batch while the pool fills, from the pool once it is full; from the
    batch always with batch_pick, the fault of a pick that misses the
    pool), takes the MSE over every row (over the first half alone with
    drop_half, the fault of a batch half left out), runs Adam at the step's
    lr, and mines the hardest n_hard_in of the batch's own rows into the
    pool: appended while it fills, written over the rows it handed out once
    it is full.

    Returns the losses, each leaf's gradient norm at the first step, each
    leaf's change norm after the last, the rows mined at each step
    ('mined') and the pool rows each step wrote ('pool')."""
    device = next(iter(params0.values())).device
    train = cfg["train"]
    p = {k: v.detach().clone().float() for k, v in params0.items()}
    opt = Adam(p, train["betas"], train["eps"])
    n_in, n_out = hard
    pool = torch.zeros((pool_rows, 9), device=device)
    count = 0
    losses, mined, written, grad_norms = [], [], [], None
    with precision():
        for k, (batch, noise) in enumerate(zip(batches, noises)):
            rows = torch.cat([torch.as_tensor(a, dtype=torch.float32, device=device)
                              for a in batch], -1)
            n = rows.shape[0]
            idx_out, batch_idx = noise["idx_out"].long(), noise["batch_idx"].long()
            picked = pool[idx_out] if count >= pool_rows and not batch_pick else rows[batch_idx]
            aug = torch.cat([rows, picked])
            t_rand = noise["t_rand"]
            used = aug.shape[0] // 2 if drop_half else aug.shape[0]
            grads = {k2: torch.zeros_like(v) for k2, v in p.items()}
            per_ray = []
            for s in range(0, used, block):
                e = min(s + block, used)
                leaves = {k2: v.requires_grad_(True) for k2, v in p.items()}
                x = embed(ray_points(aug[s:e, :3], aug[s:e, 3:6], cfg, t_rand[s:e]),
                          cfg["multires"], train["fast_embed"])
                err = torch.mean((forward(leaves, x, cfg, kind) - aug[s:e, 6:9]) ** 2, -1)
                part = torch.autograd.grad(err.sum() / used, list(leaves.values()))
                for k2, g in zip(leaves, part):
                    grads[k2] += g
                per_ray.append(err.detach())
                for v in p.values():
                    v.requires_grad_(False)
            per_ray = torch.cat(per_ray)
            losses.append(float(per_ray.double().mean()))
            if grad_norms is None:
                grad_norms = leaf_norms(grads)
            opt.step(grads, lr_at(train, k))
            hard_rows = aug[torch.topk(per_ray[:min(n, used)], n_in).indices]
            before = count
            if count >= pool_rows:
                pool[idx_out[:n_in]] = hard_rows
            else:
                start = min(count, pool_rows - n_in)
                pool[start:start + n_in] = hard_rows
                count = min(count + n_in, pool_rows)
            mined.append(hard_rows.cpu().numpy())
            written.append(written_rows(pool, before, idx_out, n_in).cpu().numpy())
    change = {k: p[k] - params0[k].float() for k in p}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": leaf_norms(change),
            "mined": mined, "pool": written}
