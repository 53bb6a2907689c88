"""Hard-example mining: a device-resident pool of hard rays, after
`efficient_nerf_tpu.train.hard_mining` (:29-94).

After each step the hardest `n_hard_in` rays of the batch (by per-ray MSE)
enter a pool of [P, 9] rows (rays_o, rays_d, target). The batch is always
augmented with `n_hard_out` rows: drawn from the batch itself while the pool
fills, from the pool once it is full, and those pool rows are then replaced
by this step's hard rays. Mining scans only the first `batch_size` rows.

Differences from the JAX package, on purpose:
  * mining is `torch.topk`, which equals the JAX package's `exact=True`
    (`jax.lax.top_k`). Its default, `jax.lax.approx_max_k` (:78), is the
    TPU's partition-based top-k and has no torch counterpart;
  * `count` is a Python int and the pool rows are updated in place: the
    fill state is known on the host without a device read.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device

__all__ = ["HardPool", "hard_pool_init", "pick_hard_rays", "update_hard_pool"]


class HardPool(NamedTuple):
    rays: torch.Tensor   # [P, D] rows of [rays_o, rays_d, target]
    count: int           # rows filled so far


def hard_pool_init(pool_size: int, row_dim: int = 9,
                   device: DeviceLike = None) -> HardPool:
    return HardPool(torch.zeros((pool_size, row_dim), dtype=torch.float32,
                                device=resolve_device(device)), 0)


def pick_hard_rays(pool: HardPool, generator: Optional[torch.Generator],
                   batch: torch.Tensor, n_hard_out: int,
                   idx_out: Optional[torch.Tensor] = None,
                   batch_idx: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows to append to `batch` [B, D] and the pool indices they came from.

    idx_out [n_hard_out] and batch_idx [n_hard_out] are drawn from
    `generator` unless given (the tests hand in the JAX step's draws). While
    the pool fills, rows come from the batch; the indices still point into
    the pool, and update_hard_pool does not write through them then.
    """
    P, dev = pool.rays.shape[0], batch.device
    if idx_out is None:
        idx_out = torch.randint(0, P, (n_hard_out,), generator=generator,
                                device=dev)
    if batch_idx is None:
        batch_idx = torch.randint(0, batch.shape[0], (n_hard_out,),
                                  generator=generator, device=dev)
    idx_out, batch_idx = idx_out.to(dev), batch_idx.to(dev)
    picked = pool.rays[idx_out] if pool.count >= P else batch[batch_idx]
    return picked, idx_out


def update_hard_pool(pool: HardPool, batch: torch.Tensor,
                     per_ray_mse: torch.Tensor, idx_out: torch.Tensor,
                     n_hard_in: int, batch_size: int) -> HardPool:
    """Mine the hardest of the first `batch_size` rows of the augmented
    batch [B_aug, D] into the pool, in place: appended at `count` (clamped to
    the end) while the pool fills, written over the rows handed out this
    step (idx_out[:n_hard_in]) once it is full."""
    P = pool.rays.shape[0]
    if n_hard_in > P:
        raise ValueError(f"n_hard_in {n_hard_in} exceeds the pool size {P}")
    hard_idx = torch.topk(per_ray_mse[:batch_size].detach(), n_hard_in).indices
    hard_rows = batch[hard_idx].to(pool.rays.dtype)
    if pool.count >= P:
        pool.rays[idx_out[:n_hard_in]] = hard_rows
        return HardPool(pool.rays, P)
    start = min(pool.count, P - n_hard_in)
    pool.rays[start:start + n_hard_in] = hard_rows
    return HardPool(pool.rays, min(pool.count + n_hard_in, P))
