"""The training steps on the card queue their steps without waiting for
the card: after one warm-up step, steps run under
`torch.cuda.set_sync_debug_mode("error")`, which raises on any stream,
device or event synchronisation and on any blocking copy, the autograd
engine's thread included. The fused distillation step runs with hard
mining, fused Adam and the warmup schedule; the f32 teacher step with its
coarse and fine networks, fused Adam and the decay schedule. It imports
nothing of the JAX package, so that it runs on the card's machine too."""
import numpy as np
import pytest
import torch

from efficient_nerf_tpu_torch.device import to_device
from efficient_nerf_tpu_torch.models import NeRFMLP, R2LNet
from efficient_nerf_tpu_torch.ops import r2l_train as rt
from efficient_nerf_tpu_torch.render import RenderConfig
from efficient_nerf_tpu_torch.train import (hard_pool_init, init_train_state,
                                            make_lr_schedule, make_r2l_train_step,
                                            make_teacher_train_step)

N_SAMPLE, L, DEPTH, WIDTH = 16, 10, 8, 256
IN_DIM = 3 * N_SAMPLE * (2 * L + 1)
BATCH, HARD = 4096, (512, 512)   # the pool fills in two steps
STEPS = 5                        # fill, full, and full with rows replaced


@pytest.mark.cuda
def test_fused_train_step_never_waits_for_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    tm = R2LNet(IN_DIM, DEPTH, WIDTH, use_residual=True, dtype=torch.bfloat16).to(dev)
    opt = torch.optim.Adam(tm.parameters(), lr=5e-4, betas=(0.9, 0.999), eps=1e-8,
                           fused=True)
    step = make_r2l_train_step(tm, opt, near=2.0, far=6.0, n_sample=N_SAMPLE, L=L,
                               hard=HARD, schedule=make_lr_schedule(5e-4, 500, (1e-4, 2)),
                               device=dev)
    state, pool = init_train_state(tm, opt), hard_pool_init(2 * HARD[0], device=dev)
    gen = torch.Generator(dev).manual_seed(0)

    def batch():   # host rows, moved to the card as the training loop moves them
        rows = rng.normal(size=(BATCH, 9)).astype(np.float32)
        rows[:, 6:] = rng.uniform(size=(BATCH, 3))
        return (to_device(rows[:, k:k + 3], dev) for k in (0, 3, 6))

    state, pool, _ = step(state, pool, gen, *batch())   # builds, Adam's state
    torch.cuda.synchronize()
    builds, fwd = rt._head_perm_index.builds, rt.r2l_train_fwd.launches
    losses = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(STEPS):
            state, pool, met = step(state, pool, gen, *batch())
            losses.append(met["loss_rgb"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert rt.r2l_train_fwd.launches - fwd == STEPS   # the kernels ran
    assert rt._head_perm_index.builds == builds
    assert pool.count == pool.rays.shape[0]
    assert all(np.isfinite(float(v)) for v in losses)


TEACHER_RAYS = 1024


@pytest.mark.cuda
def test_teacher_step_never_waits_for_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    nets = torch.nn.ModuleDict({k: NeRFMLP(depth=8, width=256, use_viewdirs=True).to(dev)
                                for k in ("coarse", "fine")})
    opt = torch.optim.Adam(nets.parameters(), lr=5e-4, betas=(0.9, 0.999), eps=1e-8,
                           fused=True)
    cfg = RenderConfig(n_samples=64, n_importance=128, perturb=True, white_bkgd=True)
    step = make_teacher_train_step(nets["coarse"], nets["fine"], opt, cfg,
                                   schedule=make_lr_schedule(5e-4, 500), device=dev)
    state = init_train_state(nets, opt)
    gen = torch.Generator(dev).manual_seed(0)

    def batch():   # host rays and pixels, moved as the training loop moves them
        o = rng.normal(size=(TEACHER_RAYS, 3)).astype(np.float32) * 0.1
        o[:, 2] += 4.0
        d = rng.normal(size=(TEACHER_RAYS, 3)).astype(np.float32) * 0.2
        d[:, 2] -= 1.0
        rgb = rng.uniform(size=(TEACHER_RAYS, 3)).astype(np.float32)
        return (to_device(x, dev) for x in (o, d, rgb))

    state, _ = step(state, gen, *batch())   # Adam's state, the cached depths
    torch.cuda.synchronize()
    losses = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(STEPS):
            state, met = step(state, gen, *batch())
            losses.append(met["loss"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert state.step == STEPS + 1
    assert all(np.isfinite(float(v)) for v in losses)
