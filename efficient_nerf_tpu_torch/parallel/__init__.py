"""Multi-GPU training and serving on `torch.distributed`, after
`efficient_nerf_tpu.parallel`.

The design difference: JAX drives every device of a host from one process
through a `Mesh` of devices. PyTorch runs one process per card, so here the
mesh is laid over the ranks of the process group: n_data * n_model is the
world size, and rank r sits at data coordinate r // n_model and model
coordinate r % n_model (`make_mesh`, over
`torch.distributed.device_mesh.init_device_mesh`). Each rank names its own
device (`initialize_distributed(..., device=...)`, `make_mesh(...,
device=...)`); nothing maps rank r to cuda:r implicitly, so several gloo
ranks may share one card, as the CPU tests and the card's smoke test run
them. NCCL takes one rank a card.

    initialize_distributed()            # torchrun's env://, or init_method=
    mesh = make_mesh(n_data=N)
    step = make_sharded_r2l_train_step(model, opt, mesh, near=..., far=...,
                                       n_sample=16, hard=(h_in, h_out))
    state, pool = replicate_state(mesh, init_train_state(model, opt), pool)
    state, pool, m = step(state, pool, gen, *shard_batch(mesh, o, d, t))

The JAX module's `batch_sharding` and `replicated` return NamedShardings
and have no torch counterpart: `shard_batch` and `replicate_state` take
their place.
"""
from .mesh import (Mesh, gather_batch, gather_params_tp, host_subset,
                   initialize_distributed, make_mesh, shard_batch, shard_params_tp)
from .render import make_sharded_r2l_forward
from .train import (make_sharded_r2l_train_step, make_sharded_teacher_train_step,
                    replicate_state)

__all__ = ["Mesh", "gather_batch", "gather_params_tp", "host_subset",
           "initialize_distributed", "make_mesh", "shard_batch", "shard_params_tp",
           "make_sharded_r2l_forward", "make_sharded_r2l_train_step",
           "make_sharded_teacher_train_step", "replicate_state"]
