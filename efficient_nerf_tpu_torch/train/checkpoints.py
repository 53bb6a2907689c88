"""Checkpoint save/resume, after `efficient_nerf_tpu.train.checkpoints`.

The port writes what the reference wrote (main.py:1516-1542), a
`torch.save` dict:

  global_step, network_fn_state_dict, network_fine_state_dict (teacher with
  a fine network), optimizer_state_dict, best_psnr, best_psnr_step,

plus `model_config`, the architecture flags the JAX package keeps in its
header (the streamed student rebuilds its teacher from them). The
state_dicts use the reference's `NeRF`/`NeRF_v3_2` key names
(models/weights.py), so the JAX package's `import_reference_checkpoint`
reads a port checkpoint of the teacher or of the resmlp student; the port's
plain student bodies keep their `body.{2i}` layout, which the JAX
converters do not read.

`load_checkpoint` reads a file by its content, not its name, and takes
what the JAX package's readers take:
- the JAX package's own `ENTPUCK1` file: the magic, a `<I` length, a JSON
  header (step, best_psnr, best_psnr_step, model_config, has_opt_state),
  then `flax.serialization.to_bytes({"params", "opt_state"})`, decoded by
  utils/msgpack.py (no flax, no msgpack package);
- any other file as a torch `.tar`: the port's own, or the reference's,
  whose whole pickled module under `network_fn` becomes an inert stub
  (models/torch_import.py: no global outside an allowlist is imported or
  called).

`import_reference_checkpoint` loads either into the port's modules. An
`ENTPUCK1` file's param tree goes through the converter of the module it
is given (models/weights.py: resmlp `R2LNet`, the plain `mlp`/layerwise
bodies, `R2LConvNet`, whose running statistics stay at init since the JAX
file holds no batch_stats, and a teacher's coarse and fine `NeRFMLP`). Its
optax Adam state (`{"0": {count, mu, nu}, "1": {count}}` of
`optax.adam(schedule)`) becomes torch Adam's: `mu`/`nu` through the same
converter as `exp_avg`/`exp_avg_sq` by parameter, `count` as `step`. The
two updates are the same: eps added outside the square root of the
bias-corrected second moment (optax's eps_root is 0), the lr the
schedule's at the step count. An empty state (`--freeze_pretrained`'s
`optax.set_to_zero`) restores none.
"""
from __future__ import annotations

import json
import os
import pickle
import struct
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.nerf import NeRFMLP
from ..models.r2l import R2LConvNet
from ..models.torch_import import load_torch_checkpoint
from ..models.weights import (conv_state_dict_from_jax, nerf_state_dict_from_jax,
                              plain_r2l_state_dict_from_jax, r2l_state_dict_from_jax)
from ..utils.msgpack import msgpack_restore

__all__ = ["save_checkpoint", "load_checkpoint", "restore_train_state",
           "import_reference_checkpoint", "JAX_MAGIC"]

JAX_MAGIC = b"ENTPUCK1"


def _cpu_state(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def _networks(model: torch.nn.Module) -> Tuple[torch.nn.Module, Optional[torch.nn.Module]]:
    """(network_fn, network_fine): a teacher is an nn.ModuleDict with
    'coarse' and optionally 'fine'; a student is one module."""
    if isinstance(model, torch.nn.ModuleDict):
        return model["coarse"], model["fine"] if "fine" in model else None
    return model, None


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    step: int = 0, best_psnr: float = 0.0,
                    best_psnr_step: int = 0,
                    model_config: Optional[Dict[str, Any]] = None) -> str:
    """Write a checkpoint file (atomic rename); returns its path."""
    fn, fine = _networks(model)
    ckpt: Dict[str, Any] = {
        "global_step": int(step),
        "network_fn_state_dict": _cpu_state(fn),
        "best_psnr": float(best_psnr),
        "best_psnr_step": int(best_psnr_step),
        "model_config": dict(model_config or {}),
    }
    if fine is not None:
        ckpt["network_fine_state_dict"] = _cpu_state(fine)
    if optimizer is not None:
        ckpt["optimizer_state_dict"] = optimizer.state_dict()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    return path


def _load_jax(path: str, f) -> Dict[str, Any]:
    """The rest of an ENTPUCK1 file, `f` read past its magic."""
    try:
        (hlen,) = struct.unpack("<I", f.read(4))
        meta = json.loads(f.read(hlen).decode())
        payload = msgpack_restore(f.read())
    except (struct.error, UnicodeDecodeError, json.JSONDecodeError, ValueError) as e:
        raise ValueError(f"{path}: a damaged ENTPUCK1 checkpoint ({e})") from None
    return {"global_step": int(meta.get("step", 0)),
            "best_psnr": float(meta.get("best_psnr", 0.0)),
            "best_psnr_step": int(meta.get("best_psnr_step", 0)),
            "model_config": meta.get("model_config") or {},
            "params": payload["params"],
            "opt_state": payload.get("opt_state") if meta.get("has_opt_state") else None}


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint dict, tensors on the CPU: a torch `.tar`'s own, or for
    an ENTPUCK1 file global_step, best_psnr, best_psnr_step and
    model_config from its header beside the raw numpy trees `params` and
    `opt_state` (None without one). A file that is neither raises
    ValueError."""
    with open(path, "rb") as f:
        if f.read(len(JAX_MAGIC)) == JAX_MAGIC:
            return _load_jax(path, f)
    try:
        return load_torch_checkpoint(path)
    except (pickle.UnpicklingError, EOFError, RuntimeError) as e:
        raise ValueError(f"{path}: neither an ENTPUCK1 checkpoint nor a torch .tar "
                         f"({type(e).__name__}: {e})") from None


def _jax_state_dict(tree, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A JAX param tree (or an Adam moment of one) as `model`'s state_dict,
    through the converter of its module type."""
    if isinstance(model, torch.nn.ModuleDict):
        out = {}
        for name, net in model.items():
            out.update({f"{name}.{k}": v for k, v in
                        _jax_state_dict(tree.get(name, tree["coarse"]), net).items()})
        return out
    if isinstance(model, NeRFMLP):
        return nerf_state_dict_from_jax(tree, model.depth, model.use_viewdirs)
    if isinstance(model, R2LConvNet):
        return conv_state_dict_from_jax(tree)
    if model.layerwise_widths or model.body_arch == "mlp":
        return plain_r2l_state_dict_from_jax(tree, model.depth, model.linear_tail)
    return r2l_state_dict_from_jax(tree, model.n_learnable, model.linear_tail)


def _adam_state_dict(opt_state, model: torch.nn.Module,
                     optimizer: Optional[torch.optim.Optimizer]) -> Optional[Dict[str, Any]]:
    """optax.adam's state as a torch Adam state_dict over model.parameters()
    (the param_groups of `optimizer`, or of a default Adam); None for an
    empty state."""
    adam = (opt_state or {}).get("0")
    if not isinstance(adam, dict) or "mu" not in adam:
        return None
    mu, nu = _jax_state_dict(adam["mu"], model), _jax_state_dict(adam["nu"], model)
    step = float(adam["count"])
    state = {i: {"step": torch.tensor(step), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
             for i, (name, _) in enumerate(model.named_parameters())}
    groups = (optimizer or torch.optim.Adam(model.parameters())).state_dict()["param_groups"]
    return {"state": state, "param_groups": groups}


def import_reference_checkpoint(path: str, model: torch.nn.Module,
                                optimizer: Optional[torch.optim.Optimizer] = None
                                ) -> Dict[str, Any]:
    """Load a checkpoint's weights into `model` (a teacher ModuleDict or a
    student module, built with the checkpoint's architecture); returns its
    meta: step, best_psnr, best_psnr_step, model_config, and the optimizer
    state_dict (None when the file has none). For an ENTPUCK1 file that
    state_dict takes its param_groups from `optimizer` when one is given."""
    ckpt = load_checkpoint(path)
    opt_sd = ckpt.get("optimizer_state_dict")
    if "params" in ckpt:
        model.load_state_dict(_jax_state_dict(ckpt["params"], model))
        opt_sd = _adam_state_dict(ckpt["opt_state"], model, optimizer)
    else:
        fn, fine = _networks(model)
        fn.load_state_dict(_strip_module(ckpt["network_fn_state_dict"]))
        if fine is not None:
            fine.load_state_dict(_strip_module(ckpt.get("network_fine_state_dict",
                                                        ckpt["network_fn_state_dict"])))
    return {"step": int(ckpt.get("global_step", 0)),
            "best_psnr": float(ckpt.get("best_psnr", 0.0) or 0.0),
            "best_psnr_step": int(ckpt.get("best_psnr_step", 0) or 0),
            "model_config": ckpt.get("model_config") or {},
            "optimizer_state_dict": opt_sd}


def _strip_module(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A DataParallel-saved state_dict without its 'module.' prefixes."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def restore_train_state(path: str, state):
    """Restore a TrainState (train.steps.TrainState) from a checkpoint in
    place: the weights, the optimizer's state where the file has one, and
    the step. Returns (meta, state)."""
    meta = import_reference_checkpoint(path, state.model, state.optimizer)
    if meta["optimizer_state_dict"] is not None:
        state.optimizer.load_state_dict(meta["optimizer_state_dict"])
    return meta, state._replace(step=meta["step"])
