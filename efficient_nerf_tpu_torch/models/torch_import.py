"""The reader of the reference's own `.tar` checkpoints, after
`efficient_nerf_tpu.models.torch_import.load_torch_checkpoint`.

The reference saves `global_step`, `network_fn_state_dict`, optionally
`network_fine_state_dict` and `optimizer_state_dict`, and for the R2L
student also the whole `nn.Module` pickled under `network_fn`
(main.py:1516-1542). That entry names the reference's own classes, which
`torch.load(weights_only=True)` refuses. This reader unpickles with a
`find_class` that returns the real object only for the globals that
state_dicts, optimizer state_dicts and plain numbers need (_ALLOWED); every
other global becomes a fresh inert class whose construction and
`__setstate__` keep their arguments and do nothing else. Nothing the file
names is imported or called, which sets it apart from the JAX package's
reader: that one imports any module the pickle names. The allowlist lives
here, not in torch's private weights-only unpickler, whose list moves
between torch versions.
"""
from __future__ import annotations

import _compat_pickle
import collections
import pickle
import types
from typing import Any, Dict

import torch

__all__ = ["load_torch_checkpoint", "StubbedGlobal"]


def _allowed() -> Dict[tuple, Any]:
    out = {("collections", "OrderedDict"): collections.OrderedDict,
           ("torch._utils", "_rebuild_tensor_v2"): torch._utils._rebuild_tensor_v2,
           ("torch._utils", "_rebuild_parameter"): torch._utils._rebuild_parameter,
           ("torch", "Size"): torch.Size}
    for t in (set, dict, list, tuple, int, float, str):
        out[("builtins", t.__name__)] = t
    # the legacy (non-zip) format's typed storages; torch.load resolves
    # these names itself before they reach find_class
    for name in ("Double", "Float", "Half", "BFloat16", "Long", "Int", "Short", "Char",
                 "Byte", "Bool"):
        if hasattr(torch, f"{name}Storage"):
            out[("torch", f"{name}Storage")] = getattr(torch, f"{name}Storage")
    return out


_ALLOWED = _allowed()


class StubbedGlobal:
    """What a pickled global outside the allowlist becomes: a class that
    keeps what it was built and set with, and does nothing else."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls)

    def __init__(self, *args, **kwargs):
        self.__dict__["_args"], self.__dict__["_kwargs"] = args, kwargs

    def __setstate__(self, state):
        self.__dict__["_state"] = state

    def __call__(self, *args, **kwargs):
        raise RuntimeError(f"{type(self).__qualname__}: a stub of an unpickled global")


def _stub(module: str, name: str) -> type:
    return type(name, (StubbedGlobal,), {"__module__": module, "__qualname__": name})


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        # protocol 2 (torch.save's) writes Python 2 names such as
        # __builtin__.set: map them as pickle's fix_imports would
        module, name = _compat_pickle.NAME_MAPPING.get((module, name), (module, name))
        module = _compat_pickle.IMPORT_MAPPING.get(module, module)
        found = _ALLOWED.get((module, name))
        return found if found is not None else _stub(module, name)


def _restricted_pickle_module() -> types.ModuleType:
    mod = types.ModuleType("efficient_nerf_tpu_torch_restricted_pickle")
    mod.Unpickler = _Unpickler
    mod.load = lambda f, **kw: _Unpickler(f, **kw).load()
    return mod


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A reference `.tar` (zip or legacy format) as its dict, tensors on the
    CPU; a pickled module comes back as an inert StubbedGlobal."""
    return torch.load(path, map_location="cpu", pickle_module=_restricted_pickle_module(),
                      weights_only=False)
