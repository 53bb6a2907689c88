"""The cache of a renderer's weight packs.

Both renderers pack a model's weights for their kernels once and keep the
pack on the model (`cached_pack`), while no parameter changes. A pack is
valid while this key, the walked key, is unchanged: the count of optimizer
steps taken in the process, and each of `model.parameters()`'s storage and
version counter, which in-place updates through autograd-visible ops
(load_state_dict, `mul_` under no_grad, a foreach optimizer) bump. The count
covers the fused optimizers (Adam(fused=True)), which write the parameters
without bumping their version counters.

Walking the module tree for that key costs more than half a millisecond on
a W256 D88 student, on every frame. So a pack also keeps each parameter it
was made from, with the `_parameters` dict that holds it, and the process's
structure epoch, which global registration hooks bump whenever any module
registers a parameter or a submodule (setattr of a new `nn.Parameter` or
module, `add_module`, `load_state_dict(..., assign=True)`). While the epoch
and the optimizer count are unchanged and every kept parameter is still in
its dict with its storage and version, the walked key is unchanged too, and
the pack is served without the walk. Anything else walks the tree and
compares the walked key, so a pack is made again exactly when the walked key
has changed: `.to(dtype)` moves each parameter's storage, a `del
module.weight` or a conversion that replaces the parameter objects
(`torch.__future__.set_overwrite_module_params_on_conversion(True)`) leaves a
kept parameter out of its dict.

Not seen without a walk: writes that go straight into a module's private
`_modules` or `_parameters` dicts and add an entry or swap a submodule,
rather than through setattr, `register_parameter` or `add_module`. After such
a write, delete the model's pack attribute so that the next call packs anew.

Counters: `pack_builds` (packs made) and `pack_hits` (packs served from
the cache), for the tests.
"""
from __future__ import annotations

from typing import Callable, Hashable, NamedTuple, Tuple

import torch
from torch.nn.modules.module import (register_module_module_registration_hook,
                                     register_module_parameter_registration_hook)
from torch.optim.optimizer import register_optimizer_step_post_hook

__all__ = ["cached_pack"]

_optimizer_steps = 0
_structure_epoch = 0
pack_builds = 0
pack_hits = 0


def _count_optimizer_step(optimizer, args, kwargs) -> None:
    global _optimizer_steps
    _optimizer_steps += 1


def _bump_structure_epoch(module, name, value) -> None:
    global _structure_epoch
    _structure_epoch += 1


register_optimizer_step_post_hook(_count_optimizer_step)
register_module_parameter_registration_hook(_bump_structure_epoch)
register_module_module_registration_hook(_bump_structure_epoch)


class _Entry(NamedTuple):
    key: Hashable            # the caller's part of the key
    steps: int               # _optimizer_steps when checked
    epoch: int               # _structure_epoch when checked
    slots: Tuple             # (the _parameters dict, name, parameter), in parameters() order
    stamps: Tuple            # (data_ptr, _version) of each parameter
    pack: object


def _slots(model: torch.nn.Module) -> Tuple:
    """Each of `model.parameters()` with the dict and the name it is held
    under, in the same order and with the same duplicates dropped."""
    seen, slots = set(), []
    for module in model.modules():
        params = module._parameters
        for name, p in params.items():
            if p is not None and p not in seen:
                seen.add(p)
                slots.append((params, name, p))
    return tuple(slots)


def _stamps(slots: Tuple) -> Tuple:
    return tuple((p.data_ptr(), p._version) for _, _, p in slots)


def _unchanged(e: _Entry) -> bool:
    """Every kept parameter still in its dict, with its storage and version."""
    for (params, name, p), (ptr, version) in zip(e.slots, e.stamps):
        if params.get(name) is not p or p.data_ptr() != ptr or p._version != version:
            return False
    return True


def cached_pack(model: torch.nn.Module, attr: str, key: Hashable,
                make: Callable[[], object]):
    """make() of `model`'s weights, kept on the model as `attr` and made
    again, under no_grad, when `key` or the walked key changes."""
    global pack_builds, pack_hits
    e = vars(model).get(attr)
    same_key = e is not None and e.key == key and e.steps == _optimizer_steps
    if same_key and e.epoch == _structure_epoch and _unchanged(e):
        pack_hits += 1
        return e.pack
    slots = _slots(model)
    stamps = _stamps(slots)
    if same_key and stamps == e.stamps:
        setattr(model, attr, e._replace(epoch=_structure_epoch, slots=slots))
        pack_hits += 1
        return e.pack
    with torch.no_grad():
        pack = make()
    pack_builds += 1
    setattr(model, attr, _Entry(key, _optimizer_steps, _structure_epoch, slots, stamps, pack))
    return pack
