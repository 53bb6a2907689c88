"""Weights across the two packages, in the reference's state_dict layout.

A copy of the numpy converters of `efficient_nerf_tpu.models.torch_import`
(which this package must not import) plus the torch side. Keys follow the
reference `NeRF_v3_2` student: `head.0`, `body.{b}.body.{2j}` (linears at
even indices of a Sequential, activations between) and `tail.0` (or `tail`
with `linear_tail`). torch `nn.Linear.weight` is [out, in]; flax
`Dense.kernel` is [in, out]; the JAX body stacks its blocks along axis 0.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["r2l_params_from_state_dict", "r2l_state_dict_from_params",
           "r2l_state_dict_from_jax"]


def _strip_module_prefix(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v,
                            dtype=np.float32)
    return out


def _dense(sd, prefix):
    return {
        "kernel": sd[f"{prefix}.weight"].T.copy(),
        "bias": sd[f"{prefix}.bias"].copy(),
    }


def _undense(d):
    return np.asarray(d["kernel"]).T, np.asarray(d["bias"])


def r2l_params_from_state_dict(state_dict, n_block: int, n_learnable: int = 2,
                               linear_tail: bool = False) -> Dict[str, Any]:
    """Reference (resmlp body) state_dict -> the JAX R2LNet param tree, as
    numpy arrays."""
    sd = _strip_module_prefix(state_dict)
    params: Dict[str, Any] = {"head": _dense(sd, "head.0")}

    body: Dict[str, Any] = {}
    for j in range(n_learnable):
        kernels = np.stack(
            [sd[f"body.{b}.body.{2 * j}.weight"].T for b in range(n_block)], 0
        )
        biases = np.stack(
            [sd[f"body.{b}.body.{2 * j}.bias"] for b in range(n_block)], 0
        )
        body[f"lin_{j}"] = {"kernel": kernels, "bias": biases}
    params["body"] = body

    tail_prefix = "tail" if linear_tail else "tail.0"
    params["tail"] = _dense(sd, tail_prefix)
    return params


def r2l_state_dict_from_params(params, n_learnable: int = 2,
                               linear_tail: bool = False) -> Dict[str, np.ndarray]:
    """The JAX R2LNet param tree -> reference state_dict, as numpy arrays."""
    sd = {}
    w, b = _undense(params["head"])
    sd["head.0.weight"], sd["head.0.bias"] = w, b
    body = params["body"]
    n_block = np.asarray(body["lin_0"]["kernel"]).shape[0]
    for bidx in range(n_block):
        for j in range(n_learnable):
            sd[f"body.{bidx}.body.{2 * j}.weight"] = (
                np.asarray(body[f"lin_{j}"]["kernel"])[bidx].T
            )
            sd[f"body.{bidx}.body.{2 * j}.bias"] = (
                np.asarray(body[f"lin_{j}"]["bias"])[bidx]
            )
    tail_prefix = "tail" if linear_tail else "tail.0"
    w, b = _undense(params["tail"])
    sd[f"{tail_prefix}.weight"], sd[f"{tail_prefix}.bias"] = w, b
    return sd


def r2l_state_dict_from_jax(params_np, n_learnable: int = 2,
                            linear_tail: bool = False) -> Dict[str, torch.Tensor]:
    """The JAX R2LNet param tree (leaves as numpy arrays) -> a state_dict of
    f32 CPU tensors that `efficient_nerf_tpu_torch.models.R2LNet` loads."""
    sd = r2l_state_dict_from_params(params_np, n_learnable, linear_tail)
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
