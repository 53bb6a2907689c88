"""Checkpoint save/resume in the reference's `.tar` layout, after
`efficient_nerf_tpu.train.checkpoints`.

The JAX package writes its own flax msgpack file (`ENTPUCK1`); neither flax
nor msgpack is on the card's machine, so the port writes what the reference
wrote (main.py:1516-1542), a `torch.save` dict:

  global_step, network_fn_state_dict, network_fine_state_dict (teacher with
  a fine network), optimizer_state_dict, best_psnr, best_psnr_step,

plus `model_config`, the architecture flags the JAX package keeps in its
msgpack header (the streamed student rebuilds its teacher from them). The
state_dicts use the reference's `NeRF`/`NeRF_v3_2` key names
(models/weights.py), so the JAX package's `import_reference_checkpoint`
reads a port checkpoint of the teacher or of the resmlp student; the port's
plain student bodies keep their `body.{2i}` layout, which the JAX
converters do not read. A JAX-native `ENTPUCK1` file raises `ValueError`
naming the format. Files are read with `torch.load(weights_only=True)`:
tensors, numbers and strings only (a reference file that also pickles a
whole module under `network_fn` must be reduced to its state_dicts first).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

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


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint dict, tensors on the CPU. A JAX-native msgpack file
    raises ValueError."""
    with open(path, "rb") as f:
        if f.read(len(JAX_MAGIC)) == JAX_MAGIC:
            raise ValueError(
                f"{path}: a JAX-native ENTPUCK1 (flax msgpack) checkpoint; the port "
                "reads the reference .tar layout (torch.save of state_dicts). Convert it "
                "with the JAX package: save its params through "
                "models.torch_import.*_state_dict_from_params into a .tar")
    return torch.load(path, map_location="cpu", weights_only=True)


def import_reference_checkpoint(path: str, model: torch.nn.Module) -> Dict[str, Any]:
    """Load a checkpoint's state_dicts into `model` (a teacher ModuleDict or
    a student module, built with the checkpoint's architecture); returns
    its meta: step, best_psnr, best_psnr_step, model_config, and the
    optimizer state (None when the file has none)."""
    ckpt = load_checkpoint(path)
    fn, fine = _networks(model)
    fn.load_state_dict(_strip_module(ckpt["network_fn_state_dict"]))
    if fine is not None:
        fine.load_state_dict(_strip_module(ckpt.get("network_fine_state_dict",
                                                    ckpt["network_fn_state_dict"])))
    return {"step": int(ckpt.get("global_step", 0)),
            "best_psnr": float(ckpt.get("best_psnr", 0.0) or 0.0),
            "best_psnr_step": int(ckpt.get("best_psnr_step", 0) or 0),
            "model_config": ckpt.get("model_config") or {},
            "optimizer_state_dict": ckpt.get("optimizer_state_dict")}


def _strip_module(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A DataParallel-saved state_dict without its 'module.' prefixes."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def restore_train_state(path: str, state):
    """Restore a TrainState (train.steps.TrainState) from a checkpoint in
    place: the weights, the optimizer's state where the file has one, and
    the step. Returns (meta, state)."""
    meta = import_reference_checkpoint(path, state.model)
    if meta["optimizer_state_dict"] is not None:
        state.optimizer.load_state_dict(meta["optimizer_state_dict"])
    return meta, state._replace(step=meta["step"])
