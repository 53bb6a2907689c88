"""The key a renderer's cached weight pack is valid for.

Both renderers pack a model's weights for their kernels once and reuse the
pack while no parameter changes; `param_version_key` says when one has.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

__all__ = ["param_version_key"]

_optimizer_steps = 0


def _count_optimizer_step(optimizer, args, kwargs) -> None:
    global _optimizer_steps
    _optimizer_steps += 1


# a fused optimizer (Adam(fused=True)) writes the parameters without bumping
# their version counters, so the pack's key also counts every optimizer step
# taken in the process
register_optimizer_step_post_hook(_count_optimizer_step)


def param_version_key(model: torch.nn.Module) -> Tuple:
    """What a pack of `model`'s weights is valid for: each parameter's
    storage and version counter, which in-place updates through
    autograd-visible ops (load_state_dict, a foreach optimizer) bump, and the
    count of optimizer steps, which also covers the fused optimizers that do
    not."""
    return (_optimizer_steps,) + tuple(
        (p.data_ptr(), p._version) for p in model.parameters())
