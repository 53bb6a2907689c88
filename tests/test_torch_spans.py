"""The port's spans (`utils.profiling.span`): off, the shared no-op context
and no `record_function` call; under the profiler, the spans of a student
frame, a fused student step with a hard pool and a teacher step, each
inside the span the layout names; the loader's worker reads in the span
log, from its own threads, tied to the consumer's waits by sequence
number; and no log entry while no profiler runs."""
import threading

import numpy as np
import pytest
import torch

from efficient_nerf_tpu_torch.core.rays import get_rays_np
from efficient_nerf_tpu_torch.data.rays_dataset import RayShardDataset, ShardLoader
from efficient_nerf_tpu_torch.device import to_device
from efficient_nerf_tpu_torch.models import NeRFMLP, R2LNet
from efficient_nerf_tpu_torch.render import RenderConfig
from efficient_nerf_tpu_torch.render.r2l_renderer import r2l_render_image
from efficient_nerf_tpu_torch.train import (hard_pool_init, init_train_state,
                                            make_r2l_train_step, make_teacher_train_step)
from efficient_nerf_tpu_torch.utils import profiling, span, spans_logged, trace

N_SAMPLE, L, DEPTH, WIDTH, B = 4, 2, 4, 32, 24
IN_DIM = 3 * N_SAMPLE * (2 * L + 1)
NEAR, FAR = 2.0, 6.0
C2W = np.float32([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4]])


def parents(prof, names):
    """{span: the innermost other span of `names` whose time range holds it
    (None at the top)}, for each span of `names` in the trace; every
    occurrence of a name must have the same parent."""
    ev = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
          if e.name in names]
    out = {}
    for n, s, e in ev:
        holders = [(s2, -e2, n2) for n2, s2, e2 in ev
                   if (n2, s2, e2) != (n, s, e) and s2 <= s and e <= e2]
        parent = max(holders)[2] if holders else None
        assert out.setdefault(n, parent) == parent, (n, parent, out[n])
    return out


def test_off_span_is_the_shared_no_op(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    a, b = span("a"), span("b", seq=3)
    assert a is b
    with a as s:
        assert s is None
    before = spans_logged()
    ray = to_device(np.zeros((2, 3), np.float32), torch.device("cpu"))
    get_rays_np(4, 4, 2.0, C2W)
    assert ray.shape == (2, 3) and spans_logged() == before


@pytest.mark.parametrize("quant", ["", "int8"])
def test_student_frame_spans(tmp_path, quant):
    # "" takes the unfused path on the CPU; "int8" the kernel's path (its
    # plain version here): get_rays, then r2l_forward_rays
    torch.manual_seed(0)
    model = R2LNet(IN_DIM, DEPTH, WIDTH, use_residual=True).eval()
    with trace(str(tmp_path)) as prof:
        rgb = r2l_render_image(model, C2W, 6, 5, 4.0, NEAR, FAR, N_SAMPLE, L,
                               quant=quant, device="cpu")
    assert rgb.shape == (6, 5, 3)
    got = parents(prof, {"r2l.render_image", "r2l.rays", "r2l.forward"})
    assert got == {"r2l.render_image": None, "r2l.rays": "r2l.render_image",
                   "r2l.forward": "r2l.render_image"}


def test_fused_student_step_spans(tmp_path):
    torch.manual_seed(1)
    model = R2LNet(IN_DIM, DEPTH, WIDTH, use_residual=True)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_r2l_train_step(model, opt, near=NEAR, far=FAR, n_sample=N_SAMPLE, L=L,
                               hard=(4, 4), fused=True, device="cpu")
    state, pool = init_train_state(model, opt), hard_pool_init(8, device="cpu")
    gen = torch.Generator().manual_seed(0)
    rays = [torch.randn(B, 3), torch.randn(B, 3), torch.rand(B, 3)]
    with trace(str(tmp_path)) as prof:
        for _ in range(3):      # fills the pool, then picks from it
            state, pool, _ = step(state, pool, gen, *rays)
    phases = ("train.hard_pick", "train.sample", "train.forward", "train.backward",
              "train.adam", "train.mine")
    kernels = ("r2l_train.pack", "r2l_train.backward", "r2l_train.bwd_kernels",
               "r2l_train.bwd_grads")
    got = parents(prof, {"train.r2l_step", *phases, *kernels})
    assert got == {"train.r2l_step": None, **{p: "train.r2l_step" for p in phases},
                   "r2l_train.pack": "train.forward",
                   "r2l_train.backward": "train.backward",
                   "r2l_train.bwd_kernels": "r2l_train.backward",
                   "r2l_train.bwd_grads": "r2l_train.backward"}
    assert sum(e.name == "train.r2l_step" for e in prof.events()) == 3


def test_teacher_step_spans(tmp_path):
    cfg = RenderConfig(n_samples=8, n_importance=4, perturb=True, use_viewdirs=True,
                       near=NEAR, far=FAR)
    torch.manual_seed(2)
    coarse, fine = NeRFMLP(depth=2, width=16), NeRFMLP(depth=2, width=16)
    nets = torch.nn.ModuleDict({"coarse": coarse, "fine": fine})
    opt = torch.optim.Adam(nets.parameters(), lr=1e-3)
    step = make_teacher_train_step(coarse, fine, opt, cfg, device="cpu")
    ro, rd = get_rays_np(4, 4, 3.0, C2W)
    o, d = (to_device(x.reshape(-1, 3), torch.device("cpu")) for x in (ro, rd))
    with trace(str(tmp_path)) as prof:
        ro, rd = get_rays_np(4, 4, 3.0, C2W)
        step(init_train_state(nets, opt), torch.Generator().manual_seed(0), o, d,
             torch.rand(16, 3))
    names = ("train.teacher_step", "train.backward", "train.adam", "render.coarse",
             "render.fine_depths", "render.fine", "core.get_rays_np")
    assert parents(prof, set(names)) == {
        "train.teacher_step": None, "core.get_rays_np": None,
        **{n: "train.teacher_step" for n in names[1:-1]}}


def _shards(tmp_path, n=6, rows=64):
    rng = np.random.default_rng(0)
    for i in range(n):
        np.save(tmp_path / f"s{i:02d}.npy", rng.random((rows, 9), dtype=np.float32))
    return RayShardDataset(str(tmp_path), rng=np.random.default_rng(1))


def test_loader_reads_land_in_the_log(tmp_path):
    loader = ShardLoader(_shards(tmp_path), 2, rng=np.random.default_rng(2), prefetch=1,
                         num_threads=1, use_native=False)
    try:
        with trace(str(tmp_path / "tr")) as prof:
            for _ in range(4):
                next(loader)
    finally:
        loader.close()
    workers = {t.name for t in loader._threads}
    log = spans_logged()
    reads = [x for x in log if x.name == "data.shard_read"]
    waits = [x for x in log if x.name == "data.loader_next"]
    assert reads and all(x.thread in workers for x in reads)
    assert threading.main_thread().name not in workers
    assert all(x.end_ns >= x.start_ns for x in reads)
    # the consumer took batches 0-3 in order; the reads of 2 and 3 began
    # while the profiler ran (the queue holds one batch)
    assert [x.seq for x in waits] == [0, 1, 2, 3]
    assert {2, 3} <= {x.seq for x in reads}
    assert sum(e.name == "data.loader_next" for e in prof.events()) == 4
    assert not any(e.name == "data.shard_read" for e in prof.events())


def test_log_stays_empty_without_a_profiler(tmp_path):
    with trace(str(tmp_path / "tr")):
        pass
    assert spans_logged() == []
    loader = ShardLoader(_shards(tmp_path), 2, rng=np.random.default_rng(3), prefetch=1,
                         num_threads=2, use_native=False)
    try:
        for _ in range(4):
            next(loader)
    finally:
        loader.close()
    with span("x", seq=1) as s:
        assert s is None
    assert spans_logged() == []
    assert len(profiling._LOG) == 0 and profiling._LOG.maxlen == profiling.LOG_ENTRIES
