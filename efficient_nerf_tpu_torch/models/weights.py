"""Weights across the two packages, in the reference's state_dict layout.

A copy of the numpy converters of `efficient_nerf_tpu.models.torch_import`
(which this package must not import) plus the torch side. Keys follow the
reference models. The `NeRF_v3_2` student: `head.0`, `body.{b}.body.{2j}`
(linears at even indices of a Sequential, activations between) and `tail.0`
(or `tail` with `linear_tail`). The port's plain student bodies ('mlp' and
`layerwise_widths`), which the JAX converters do not read: `head.0`,
`body.{2i}` for the JAX `body_{i}` and the tail as above. The `NeRF`
teacher: `pts_linears.{i}`, `feature_linear`, `views_linears.0`,
`rgb_linear` and `alpha_linear` (or `output_linear` without viewdirs).
torch `nn.Linear.weight` is [out, in]; flax `Dense.kernel` is [in, out];
the JAX student body stacks its blocks along axis 0.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["r2l_params_from_state_dict", "r2l_state_dict_from_params",
           "r2l_state_dict_from_jax", "plain_r2l_state_dict_from_jax",
           "conv_state_dict_from_jax", "nerf_params_from_state_dict",
           "nerf_state_dict_from_params", "nerf_state_dict_from_jax"]


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


def plain_r2l_state_dict_from_jax(params_np, depth: int,
                                  linear_tail: bool = False) -> Dict[str, torch.Tensor]:
    """The JAX R2LNet param tree of a plain body ('mlp' or
    `layerwise_widths`: `head`, `body_0` ... `body_{depth-3}`, `tail`;
    leaves as numpy arrays) -> a state_dict of f32 CPU tensors in the port's
    Sequential layout: linears at the even indices, `body.{2i}` for
    `body_{i}`."""
    names = [("head", "head.0")]
    names += [(f"body_{i}", f"body.{2 * i}") for i in range(depth - 2)]
    names.append(("tail", "tail" if linear_tail else "tail.0"))
    sd = {}
    for theirs, ours in names:
        w, b = _undense(params_np[theirs])
        sd[f"{ours}.weight"] = torch.tensor(np.asarray(w, np.float32))
        sd[f"{ours}.bias"] = torch.tensor(np.asarray(b, np.float32))
    return sd


def conv_state_dict_from_jax(params_np, batch_stats_np=None) -> Dict[str, torch.Tensor]:
    """The JAX R2LConvNet's variables (leaves as numpy arrays) -> a
    state_dict of f32 CPU tensors that the port's `R2LConvNet` loads; its
    modules carry the flax names. Conv kernels HWIO -> OIHW; a BatchNorm's
    `scale`/`bias` become weight/bias, its `batch_stats` `mean`/`var` the
    running statistics (the flax init's zeros and ones when
    batch_stats_np is None)."""
    sd = {}
    for name, leaves in params_np.items():
        if "kernel" in leaves:
            sd[f"{name}.weight"] = np.asarray(leaves["kernel"]).transpose(3, 2, 0, 1)
            sd[f"{name}.bias"] = np.asarray(leaves["bias"])
        else:
            width = np.asarray(leaves["scale"]).shape[0]
            stats = (batch_stats_np or {}).get(
                name, {"mean": np.zeros(width), "var": np.ones(width)})
            sd[f"{name}.weight"] = np.asarray(leaves["scale"])
            sd[f"{name}.bias"] = np.asarray(leaves["bias"])
            sd[f"{name}.running_mean"] = np.asarray(stats["mean"])
            sd[f"{name}.running_var"] = np.asarray(stats["var"])
    out = {k: torch.tensor(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}
    for k in list(out):
        if k.endswith(".running_mean"):
            out[k[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def nerf_params_from_state_dict(state_dict, depth: int = 8,
                                use_viewdirs: bool = True) -> Dict[str, Any]:
    """Reference `NeRF` state_dict -> the JAX NeRFMLP param tree, as numpy
    arrays."""
    sd = _strip_module_prefix(state_dict)
    params = {f"pts_{i}": _dense(sd, f"pts_linears.{i}") for i in range(depth)}
    if use_viewdirs:
        params["feature"] = _dense(sd, "feature_linear")
        params["views_0"] = _dense(sd, "views_linears.0")
        params["rgb"] = _dense(sd, "rgb_linear")
        params["alpha"] = _dense(sd, "alpha_linear")
    else:
        params["output"] = _dense(sd, "output_linear")
    return params


def nerf_state_dict_from_params(params, depth: int = 8,
                                use_viewdirs: bool = True) -> Dict[str, np.ndarray]:
    """The JAX NeRFMLP param tree -> reference state_dict, as numpy arrays."""
    sd = {}
    for i in range(depth):
        w, b = _undense(params[f"pts_{i}"])
        sd[f"pts_linears.{i}.weight"], sd[f"pts_linears.{i}.bias"] = w, b
    if use_viewdirs:
        for ours, theirs in [("feature", "feature_linear"),
                             ("views_0", "views_linears.0"),
                             ("rgb", "rgb_linear"), ("alpha", "alpha_linear")]:
            w, b = _undense(params[ours])
            sd[f"{theirs}.weight"], sd[f"{theirs}.bias"] = w, b
    else:
        w, b = _undense(params["output"])
        sd["output_linear.weight"], sd["output_linear.bias"] = w, b
    return sd


def nerf_state_dict_from_jax(params_np, depth: int = 8,
                             use_viewdirs: bool = True) -> Dict[str, torch.Tensor]:
    """The JAX NeRFMLP param tree (leaves as numpy arrays) -> a state_dict of
    f32 CPU tensors that `efficient_nerf_tpu_torch.models.NeRFMLP` loads."""
    sd = nerf_state_dict_from_params(params_np, depth, use_viewdirs)
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
