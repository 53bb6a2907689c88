"""One rank of the port's multi-process tests (test_torch_parallel.py).

    python _torch_parallel_worker.py <spec.pt> <rank> <world>

Joins a gloo group of `world` ranks through a FileStore named in the spec,
runs the spec's cases on the CPU, one mesh each, and writes what each case
returned to out_<rank>.pt beside the spec. Imports torch, numpy and the
port only.
"""
import os
import sys

import torch

torch.set_num_threads(1)

from efficient_nerf_tpu_torch.models import NeRFMLP, R2LNet  # noqa: E402
from efficient_nerf_tpu_torch.parallel import (  # noqa: E402
    gather_batch, gather_params_tp, host_subset, initialize_distributed, make_mesh,
    make_sharded_r2l_forward, make_sharded_r2l_train_step,
    make_sharded_teacher_train_step, replicate_state, shard_batch, shard_params_tp)
from efficient_nerf_tpu_torch.parallel.mesh import gather_tp  # noqa: E402
from efficient_nerf_tpu_torch.render import RenderConfig  # noqa: E402
from efficient_nerf_tpu_torch.train import hard_pool_init, init_train_state  # noqa: E402


def _r2l(case):
    model = R2LNet(**case["model"])
    model.load_state_dict(case["state_dict"])
    return model


def run_r2l_step(mesh, case):
    """Steps of make_sharded_r2l_train_step from the case's weights; the
    metrics and pool after each step, the whole weights and gradients
    after the last."""
    model = _r2l(case)
    out = {}
    if mesh.n_model > 1:
        before = {k: v.clone() for k, v in model.state_dict().items()}
        shard_params_tp(mesh, model)
        out["gathered_equal"] = all(torch.equal(before[k], v) for k, v in
                                    gather_params_tp(mesh, model).items())
    opt = torch.optim.Adam(model.parameters(), lr=case["lr"], betas=(0.9, 0.999), eps=1e-8)
    step = make_sharded_r2l_train_step(model, opt, mesh, near=case["near"], far=case["far"],
                                       n_sample=case["n_sample"], L=case["L"],
                                       perturb=case["perturb"], hard=case["hard"],
                                       **case.get("kw", {}))
    state, pool = replicate_state(mesh, init_train_state(model, opt),
                                  hard_pool_init(case["pool"], device="cpu"))
    gen = torch.Generator().manual_seed(case["seed"])
    out["steps"] = []
    for o, d, t, noise in case["batches"]:
        state, pool, m = step(state, pool, gen, *shard_batch(mesh, o, d, t), noise=noise)
        out["steps"].append({"metrics": {k: float(v) for k, v in m.items()},
                             "pool": pool.rays.clone(), "count": pool.count})
    named = dict(model.named_parameters())
    out["params"] = gather_tp(mesh, {k: p.detach() for k, p in named.items()})
    out["grads"] = gather_tp(mesh, {k: p.grad for k, p in named.items()})
    out["step"] = state.step
    return out


def run_forward(mesh, case):
    model = _r2l(case).eval()
    fn = make_sharded_r2l_forward(model, mesh, near=case["near"], far=case["far"],
                                  n_sample=case["n_sample"], L=case["L"])
    o, d = shard_batch(mesh, case["rays_o"], case["rays_d"])
    local = fn(o, d)
    return {"rows": local.shape[0], "rgb": gather_batch(mesh, local)}


def run_teacher(mesh, case):
    models = {k: NeRFMLP(**case["model"]) for k in case["state_dicts"]}
    for k, m in models.items():
        m.load_state_dict(case["state_dicts"][k])
    opt = torch.optim.Adam([p for m in models.values() for p in m.parameters()],
                           lr=case["lr"], betas=(0.9, 0.999), eps=1e-8)
    cfg = RenderConfig(**case["cfg"])
    step = make_sharded_teacher_train_step(models["coarse"], models.get("fine"), opt, mesh,
                                           cfg, hwf=case["hwf"])
    state = replicate_state(mesh, init_train_state(torch.nn.ModuleDict(models), opt))
    o, d, t = shard_batch(mesh, case["rays_o"], case["rays_d"], case["target"])
    gen = None if case["seed"] is None else torch.Generator().manual_seed(case["seed"])
    state, m = step(state, gen, o, d, t, noise=case["noise"])
    return {"metrics": {k: float(v) for k, v in m.items()}, "step": state.step,
            "params": {f"{k}.{n}": p.detach().clone() for k, mm in models.items()
                       for n, p in mm.named_parameters()},
            "grads": {f"{k}.{n}": p.grad.clone() for k, mm in models.items()
                      for n, p in mm.named_parameters()}}


def run_api(mesh, case, spec, rank, world):
    """The gates: make_mesh refuses a shape that is not the world, shard_batch
    a batch that does not divide, a second initialize_distributed returns,
    and host_subset's defaults are this rank and the world size."""
    out = {}
    try:
        make_mesh(n_data=world + 1, device="cpu")
        out["make_mesh_error"] = ""
    except ValueError as e:
        out["make_mesh_error"] = str(e)
    try:
        shard_batch(mesh, torch.zeros(mesh.n_data * 3 + 1, 3).numpy())
        out["shard_batch_error"] = ""
    except ValueError as e:
        out["shard_batch_error"] = str(e)
    initialize_distributed(init_method="file://" + spec["store"], world_size=world,
                           rank=rank, backend="gloo", device="cpu")
    out["subset"] = host_subset(case["files"])
    out["subset_explicit"] = host_subset(case["files"], rank, world)
    out["mesh"] = (mesh.shape, mesh.data_index, mesh.model_index)
    return out


RUNNERS = {"r2l_step": run_r2l_step, "forward": run_forward, "teacher": run_teacher}


def nccl_flagship(tmp: str) -> None:
    """A one-rank NCCL group on cuda:0: the sharded flagship step (W256 D88,
    bf16, the fused training kernels) against the direct step from the same
    weights, batch and seed. One rank computes every row, gathers and sums
    over itself alone: the same arithmetic, so the losses, pools and weights
    are equal."""
    from efficient_nerf_tpu_torch.ops import r2l_train as rt
    from efficient_nerf_tpu_torch.train import make_r2l_train_step

    dev = torch.device("cuda", 0)
    initialize_distributed(init_method="file://" + os.path.join(tmp, "store"),
                           world_size=1, rank=0, device=dev)
    mesh = make_mesh(n_data=1, device=dev)
    torch.manual_seed(0)
    ref = R2LNet(16 * 3 * 21, 88, 256, dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(1)
    B, hard = 8192, (2048, 2048)
    o, d = (torch.randn(B, 3, generator=g, device=dev) for _ in range(2))
    t = torch.rand(B, 3, generator=g, device=dev)
    runs = []
    for sharded in (False, True):
        model = R2LNet(16 * 3 * 21, 88, 256, dtype=torch.bfloat16)
        model.load_state_dict(ref.state_dict())
        model.to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=5e-4, fused=True)
        kw = dict(near=2.0, far=6.0, n_sample=16, hard=hard)
        step = (make_sharded_r2l_train_step(model, opt, mesh, **kw) if sharded
                else make_r2l_train_step(model, opt, device=dev, **kw))
        state, pool = init_train_state(model, opt), hard_pool_init(B, device=dev)
        gen = torch.Generator(device=dev).manual_seed(2)
        launches = rt.r2l_train_fwd.launches
        losses = []
        for _ in range(2):
            state, pool, m = step(state, pool, gen, o, d, t)
            losses.append(float(m["loss_rgb"]))
        assert rt.r2l_train_fwd.launches - launches == 2
        runs.append((losses, pool.rays.clone(), {k: v.float() for k, v in
                                                  model.state_dict().items()}))
    (l0, p0, w0), (l1, p1, w1) = runs
    assert l0 == l1, (l0, l1)
    assert torch.equal(p0, p1)
    diff = max((w0[k] - w1[k]).abs().max().item() for k in w0)
    assert diff == 0.0, diff
    torch.distributed.destroy_process_group()
    print("NCCL_FLAGSHIP_OK", l0, flush=True)


def main():
    if sys.argv[1] == "--nccl-flagship":
        nccl_flagship(sys.argv[2])
        return
    spec_path, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    spec = torch.load(spec_path, weights_only=False)
    initialize_distributed(init_method="file://" + spec["store"], world_size=world,
                           rank=rank, backend="gloo", device="cpu")
    results = {}
    for name, case in spec["cases"].items():
        mesh = make_mesh(*case["mesh"], device="cpu")
        if case["kind"] == "api":
            results[name] = run_api(mesh, case, spec, rank, world)
        else:
            results[name] = RUNNERS[case["kind"]](mesh, case)
    torch.distributed.destroy_process_group()
    torch.save(results, os.path.join(os.path.dirname(spec_path), f"out_{rank}.pt"))


if __name__ == "__main__":
    main()
