"""The (data, model) mesh over the ranks of a process group, batch sharding
and tensor-parallel weights, after `efficient_nerf_tpu.parallel.mesh`
(:30-114).

`make_mesh` lays the process group's ranks out as [n_data, n_model] with
`torch.distributed.device_mesh.init_device_mesh` (rank r at data coordinate
r // n_model and model coordinate r % n_model) and keeps the device that
this rank names for itself. The 'data' subgroup joins the ranks that hold
the same weights and different rows; the 'model' subgroup the ranks that
hold the same rows and different slices of the weights.

`batch_sharding` and `replicated` of the JAX module return `NamedSharding`s
for `jax.device_put`; torch has no such object. `shard_batch` (this rank's
rows on this rank's device) and `parallel.train.replicate_state` (a
broadcast from the first rank of 'data') take their place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..device import DeviceLike, resolve_device, to_device

__all__ = ["Mesh", "make_mesh", "initialize_distributed", "shard_batch",
           "gather_batch", "all_reduce_bucket", "host_subset", "shard_params_tp",
           "gather_params_tp", "gather_tp", "tp_split_dim"]

AXES = ("data", "model")


@dataclass(frozen=True)
class Mesh:
    """A DeviceMesh over the ranks with axes ('data', 'model'), and the
    device this rank computes on."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.device_mesh.shape))

    @property
    def n_data(self) -> int:
        return self.device_mesh.shape[0]

    @property
    def n_model(self) -> int:
        return self.device_mesh.shape[1]

    @property
    def data_index(self) -> int:
        return self.device_mesh.get_local_rank("data")

    @property
    def model_index(self) -> int:
        return self.device_mesh.get_local_rank("model")

    def group(self, axis: str):
        """The process group of this rank's row ('model') or column ('data')
        of the mesh; its group ranks run in mesh order."""
        return self.device_mesh.get_group(axis)


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: DeviceLike = None) -> None:
    """Join the default process group once; a second call returns at once.

    init_method None reads torchrun's environment (env://); a
    'file:///path' method rendezvouses through a FileStore. The backend is
    'nccl' for a CUDA device and 'gloo' for the CPU unless given ('gloo' on
    a CUDA device runs several ranks on one card, which NCCL refuses). A
    failure raises: no other backend is tried. A CUDA device becomes this
    process's current device.
    """
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: DeviceLike = None) -> Mesh:
    """The [n_data, n_model] mesh over every rank of the default group (all
    of them on 'data' by default), computing on `device` (default: the
    current CUDA device). Raises ValueError unless n_data * n_model is the
    world size. Every rank calls it, in the same order as its other
    collectives."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "initialize_distributed first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} ranks")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(init_device_mesh(dev.type, (n_data, n_model), mesh_dim_names=AXES), dev)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of each global host array [N, ...]: rows [d N /
    n_data, (d + 1) N / n_data) for data coordinate d, as float32 tensors on
    the mesh's device (pinned, non-blocking for a card). Raises ValueError
    where N does not divide over 'data'."""
    out = []
    for a in arrays:
        n = a.shape[0]
        if n % mesh.n_data:
            raise ValueError(f"shard_batch: {n} rows do not divide over "
                             f"{mesh.n_data} data ranks")
        k = n // mesh.n_data
        d = mesh.data_index
        out.append(to_device(a[d * k:(d + 1) * k], mesh.device))
    return tuple(out) if len(out) > 1 else out[0]


def gather_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The global rows of a data-sharded tensor [n, ...] on every rank
    ([n_data * n, ...], in data order): one all_gather over 'data'."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.n_data)]
    dist.all_gather(parts, x, group=mesh.group("data"))
    return torch.cat(parts)


def all_reduce_bucket(mesh: Mesh, tensors: Sequence[Optional[torch.Tensor]]
                      ) -> List[Optional[torch.Tensor]]:
    """The sums over 'data' of float32 tensors (None stays None), in one
    all_reduce of one flat buffer; returned as views of that buffer."""
    live = [t for t in tensors if t is not None]
    flat = torch.cat([t.detach().reshape(-1) for t in live])
    dist.all_reduce(flat, group=mesh.group("data"))
    out, off = [], 0
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def host_subset(files: Sequence[str], process_index: Optional[int] = None,
                process_count: Optional[int] = None) -> list:
    """Deterministic per-process partition of a shard-file list: every
    process_count-th file of the sorted list from process_index. The
    defaults are this rank and the world size, or 0 and 1 without a process
    group."""
    on = dist.is_initialized()
    pi = (dist.get_rank() if on else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if on else 1) if process_count is None else process_count
    return [f for i, f in enumerate(sorted(files)) if i % pc == pi]


def tp_split_dim(name: str) -> Optional[int]:
    """The dim that tensor parallelism splits of an R2LNet (resmlp) parameter
    over 'model', or None where it is replicated, as `_tp_spec_for_path`
    (:59-82) pairs them: the head and each block's first linear split their
    output features (dim 0 of [out, in], the bias too), each block's second
    linear its input features (dim 1; its bias is added after the reduction
    and replicated), the tail is replicated."""
    parts = name.split(".")
    if parts[0] == "head":
        return 0
    if parts[0] == "body" and len(parts) == 5:   # body.{i}.body.{0,2}.{weight,bias}
        if parts[3] == "0":
            return 0
        if parts[3] == "2" and parts[4] == "weight":
            return 1
    return None


def _check_tp_model(model, mesh: Mesh) -> None:
    if not (getattr(model, "body_arch", "") == "resmlp"
            and not getattr(model, "layerwise_widths", ()) and model.n_learnable == 2):
        raise ValueError("tensor parallelism covers the resmlp R2LNet body "
                         "(two linears a block)")
    if model.width % mesh.n_model:
        raise ValueError(f"width {model.width} does not divide over "
                         f"{mesh.n_model} model ranks")


def shard_params_tp(mesh: Mesh, model: nn.Module) -> nn.Module:
    """Keep only this rank's tensor-parallel slice of each split parameter
    (`tp_split_dim`), as new nn.Parameters in place; the replicated ones
    stay. Build the optimizer afterwards. With n_model == 1 every slice is
    the whole tensor (plain replication). Returns the model."""
    _check_tp_model(model, mesh)
    m, k = mesh.n_model, mesh.model_index
    for name, p in list(model.named_parameters()):
        dim = tp_split_dim(name)
        if dim is None:
            continue
        n = p.shape[dim] // m
        *path, leaf = name.split(".")
        setattr(model.get_submodule(".".join(path)), leaf,
                nn.Parameter(p.detach().narrow(dim, k * n, n).clone()))
    return model


def gather_tp(mesh: Mesh, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The whole tensors of tensor-parallel slices {name: slice} (weights, or
    their gradients), on every rank: an all_gather over 'model' of each
    split one, concatenated along its split dim in model order."""
    out = {}
    grp = mesh.group("model")
    for name, t in named.items():
        dim = tp_split_dim(name)
        if dim is None:
            out[name] = t.detach().clone()
            continue
        parts: List[torch.Tensor] = [torch.empty_like(t) for _ in range(mesh.n_model)]
        dist.all_gather(parts, t.detach().contiguous(), group=grp)
        out[name] = torch.cat(parts, dim)
    return out


def gather_params_tp(mesh: Mesh, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The full state_dict of a model that `shard_params_tp` sliced, in the
    reference layout, on every rank (for the tests and the checkpoints)."""
    _check_tp_model(model, mesh)
    if model.head[0].weight.shape[0] * mesh.n_model != model.width:
        raise ValueError("gather_params_tp: the model is not sliced over "
                         f"{mesh.n_model} model ranks")
    return gather_tp(mesh, dict(model.state_dict()))
