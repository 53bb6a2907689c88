"""Numerical-sanity tooling, after `efficient_nerf_tpu.utils.debug`.

The reference's closest equivalents are a DEBUG-gated NaN/inf scan over
render outputs (main.py:752-754) and globally-enabled autograd anomaly mode
(nerf_raybased.py:4 — a real slowdown we deliberately do not copy). Here
the checks are explicit and opt-in: `debug_nans` is a scoped
`torch.autograd.set_detect_anomaly`, the counterpart of JAX's
`jax_debug_nans`.
"""
from __future__ import annotations

import contextlib
from typing import Any, List

import torch

__all__ = ["find_nonfinite", "assert_finite", "debug_nans"]


def _leaves(tree: Any, prefix: str):
    """(name, tensor) of every tensor in a tensor, a module (its
    state_dict), a mapping or a sequence, nested."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, torch.nn.Module):
        yield from _leaves(tree.state_dict(), prefix)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")


def find_nonfinite(tree: Any, prefix: str = "") -> List[str]:
    """Names of the floating tensors in `tree` that hold NaN or inf."""
    return [name for name, t in _leaves(tree, prefix)
            if t.is_floating_point() and not bool(torch.isfinite(t).all())]


def assert_finite(tree: Any, what: str = "outputs") -> None:
    bad = find_nonfinite(tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {what}: {bad}")


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped autograd anomaly detection: a backward that produces NaN
    raises at the op that made it."""
    with torch.autograd.set_detect_anomaly(enable):
        yield
