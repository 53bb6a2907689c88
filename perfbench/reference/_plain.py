"""Plain PyTorch pieces that both references share: rays, depths, a linear
layer in a chosen precision, Adam, the learning-rate schedule and the
comparison of two training records.

Everything here is float32 unless a lower precision is asked for, with TF32
off (`precision`), and imports nothing of the program.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0    # largest finite float8_e4m3fn


@contextlib.contextmanager
def precision(tf32: bool = False) -> Iterator[None]:
    """float32 products in full precision (tf32=False) or in TF32 on a card."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def linspace(near: float, far: float, n: int, device) -> torch.Tensor:
    t = torch.arange(n, dtype=torch.float64, device=device) / max(n - 1, 1)
    return (near * (1.0 - t) + far * t).float()


def get_rays(c2w, H: int, W: int, focal: float, device, focal_scale: float = 1.0):
    """Rays of every pixel of a pinhole camera: (rays_o, rays_d), each
    [H*W, 3] float32. Pixel (x, y) looks along ((x - W/2) / f, -(y - H/2) / f,
    -1) in the camera's frame, f the focal times focal_scale."""
    c2w = torch.as_tensor(np.asarray(c2w, np.float32)[:3, :4], device=device)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device),
                            indexing="ij")
    f = focal * focal_scale
    dirs = torch.stack([(xs - W * 0.5) / f, -(ys - H * 0.5) / f, -torch.ones_like(xs)], -1)
    rays_d = (dirs[..., None, :] * c2w[:3, :3]).sum(-1).reshape(-1, 3)
    return c2w[:3, 3].expand(rays_d.shape), rays_d


def octave_sincos(x: torch.Tensor, L: int, recurrence: bool = False):
    """(sin(2^j x), cos(2^j x)) for j < L, each [..., L] for x [...]: exact,
    or by the double-angle recurrence sin 2a = 2 sin a cos a, cos 2a = 1 - 2
    sin^2 a from one sine and cosine (the configuration's fast embed)."""
    if not recurrence:
        y = x[..., None] * (2.0 ** torch.arange(L, dtype=x.dtype, device=x.device))
        return torch.sin(y), torch.cos(y)
    s, c = [torch.sin(x)], [torch.cos(x)]
    for _ in range(1, L):
        s, c = s + [2.0 * s[-1] * c[-1]], c + [1.0 - 2.0 * s[-1] * s[-1]]
    return torch.stack(s, -1), torch.stack(c, -1)


def stratify(z: torch.Tensor, t_rand: torch.Tensor) -> torch.Tensor:
    """Each depth moved uniformly within its interval (midpoints between
    neighbours; the ends reach near and far)."""
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], -1)
    lower = torch.cat([z[..., :1], mids], -1)
    return lower + (upper - lower) * t_rand


def fake_quant(x: torch.Tensor, kind: Optional[str]) -> torch.Tensor:
    """x rounded to `kind` and back to float32: None keeps it, 'fp8' rounds
    to float8 e4m3 under a per-tensor scale that maps the largest magnitude
    to the format's largest finite value."""
    if kind is None:
        return x
    if kind == "fp8":
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {kind!r}")


class _QuantLinear(torch.autograd.Function):
    """y = q(x) q(w)^T + b, and a backward whose products take q() of their
    operands too: the whole layer in the lower precision."""

    @staticmethod
    def forward(ctx, x, w, b, kind):
        qx, qw = fake_quant(x, kind), fake_quant(w, kind)
        ctx.save_for_backward(qx, qw)
        ctx.kind = kind
        return F.linear(qx, qw, b)

    @staticmethod
    def backward(ctx, dy):
        qx, qw = ctx.saved_tensors
        qdy = fake_quant(dy, ctx.kind)
        return qdy @ qw, qdy.t() @ qx, dy.sum(0), None


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           kind: Optional[str] = None) -> torch.Tensor:
    if kind is None:
        return F.linear(x, w, b)
    return _QuantLinear.apply(x, w, b, kind)


def lr_at(train: Dict, step: int) -> float:
    """Exponential decay by 0.1 every lrate_decay thousand steps, after a
    linear warmup from warmup_lr[0] over warmup_lr[1] steps when given."""
    lrate, decay = train["lrate"], train["lrate_decay"] * 1000
    warm = train.get("warmup_lr")
    if warm is None:
        return lrate * 0.1 ** (step / decay)
    start, iters = warm
    if step < iters:
        return (lrate - start) / iters * step + start
    return lrate * 0.1 ** ((step - iters) / decay)


class Adam:
    """Adam as Kingma and Ba state it, with bias correction."""

    def __init__(self, params: Dict[str, torch.Tensor], betas: Sequence[float],
                 eps: float):
        self.params, self.betas, self.eps, self.t = params, tuple(betas), eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        b1, b2 = self.betas
        self.t += 1
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(lr * m_hat / (v_hat.sqrt() + self.eps))


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def worst_leaf_gap(cand: Dict[str, float], ref: Dict[str, float],
                   keep: Optional[Sequence[str]] = None) -> float:
    """The largest |cand norm - ref norm| over a leaf, against the larger of
    that leaf's reference norm and the median leaf's."""
    names = list(ref) if keep is None else list(keep)
    med = float(np.median([ref[k] for k in names]))
    return max(abs(cand[k] - ref[k]) / max(ref[k], med) for k in names)


def train_gaps(cand: Dict, ref: Dict, leaves: str = "", loss: str = "losses") -> Dict[str, float]:
    """The numbers by which a training record departs from the reference's:
    each step's loss (relative; `loss` names the record's list), the first
    gradient's norm by the worst leaf, and the parameters' change over the
    steps by the worst leaf among those whose reference gradient is at least
    a thousandth of the median leaf's (the others move under Adam by
    round-off alone); over the leaves whose names start with `leaves`."""
    losses = [abs(c - r) / abs(r) for c, r in zip(cand[loss], ref[loss])]
    g = {k: v for k, v in ref["grad_norms"].items() if k.startswith(leaves)}
    med = float(np.median(list(g.values())))
    moved = [k for k, v in g.items() if v >= 1e-3 * med]
    out = {"loss_gap": max(losses), "first_loss_gap": losses[0], "last_loss_gap": losses[-1],
           "grad_gap": worst_leaf_gap(cand["grad_norms"], g),
           "change_gap": worst_leaf_gap(cand["change_norms"], ref["change_norms"], moved)}
    if "mined" in ref:
        out["pool_gap"] = pool_gap(cand["pool"], ref["mined"])
        out["first_pool_gap"] = pool_gap(cand["pool"][:1], ref["mined"][:1])
    return out


def written_rows(pool: torch.Tensor, count: int, idx_out: torch.Tensor,
                 n_hard_in: int) -> torch.Tensor:
    """The rows of a hard pool [P, D] that a step wrote, read after it: the
    n_hard_in rows appended at `count` (clamped to the end) while the pool
    fills, the rows at idx_out[:n_hard_in] once it was full before the step
    (a row drawn twice holds one of the rows written to it)."""
    P = pool.shape[0]
    if count >= P:
        return pool[idx_out[:n_hard_in].long()].clone()
    start = min(count, P - n_hard_in)
    return pool[start:start + n_hard_in].clone()


def pool_gap(cand: List[np.ndarray], mined: List[np.ndarray]) -> float:
    """The largest share, over the steps, of the pool rows that the
    candidate wrote and that are not among the rows the reference mined."""
    worst = 0.0
    for c, r in zip(cand, mined):
        have = {row.tobytes() for row in np.ascontiguousarray(r, np.float32)}
        miss = sum(row.tobytes() not in have for row in np.ascontiguousarray(c, np.float32))
        worst = max(worst, miss / max(len(c), 1))
    return worst if len(cand) == len(mined) else math.inf
