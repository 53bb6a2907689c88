"""The student's distillation step fed as `main._r2l_loop` feeds it: batches
of ray shards from `data.rays_dataset.ShardLoader` (the native reader, its
threads and prefetch), moved by `device.to_device`, into the step of
`train.steps.make_r2l_train_step` with the hard-ray pool, fused Adam and the
warmup schedule. Each request is one step; the step's random numbers are
drawn by the benchmark and handed in through its `noise` hook.

Traffic keys: shards, shard_rows, H, W, camera_angle_x, radius (the shards'
orbit rays, random focal scale), shards_per_batch, loader_threads,
prefetch, hard_ratio, hard_mul, warmup_steps.

Set-up writes the shards under the temporary directory (TMPDIR), builds
the step, and takes its first steps through the same feed. The steps that
fill the hard pool and one more, which picks from the full pool and writes
over the rows it picked as every step of the window does, are recorded: batches, draws, losses, the first gradient as Adam's state holds
it, the parameters after them, and the pool rows each step wrote. Set-up
takes at least warmup_steps steps. The check runs the reference's steps on
the same batches and draws.
"""
from __future__ import annotations

import shutil
import tempfile
from typing import Dict

import numpy as np
import torch

from efficient_nerf_tpu_torch.data import rays_dataset
from efficient_nerf_tpu_torch.device import to_device
from efficient_nerf_tpu_torch.train import hard_mining, schedules, steps

from .. import inputs, tracing
from ..reference._plain import leaf_norms, train_gaps, written_rows
from .r2l_frames import build_student

CANDIDATES = {"control": "fp8"}   # the reference in the nearest precision below bf16


def fill_steps(pool_rows: int, n_hard_in: int) -> int:
    """Steps until the hard pool is full: each appends n_hard_in rows."""
    count, steps_ = 0, 0
    while count < pool_rows:
        count, steps_ = min(count + n_hard_in, pool_rows), steps_ + 1
    return steps_


class Driver:
    def __init__(self, cell):
        cfg, t, dev = cell.config, cell.traffic, cell.device
        self.cell, self.cfg, self.t, self.dev = cell, cfg, t, dev
        tr = cfg["train"]
        self.params = cell.reference.init_params(cfg, inputs.torch_generator(cell.seed, dev, 0))
        self.tmp = tempfile.mkdtemp(prefix="perfbench-shards-")
        inputs.write_shards(self.tmp, t, cell.seed, dev)
        ds = rays_dataset.RayShardDataset(self.tmp, pseudo_ratio=-1)
        ds.files.sort()     # the order os.listdir gives differs between file systems
        self.loader = rays_dataset.ShardLoader(
            ds, t["shards_per_batch"], rng=inputs.numpy_rng(cell.seed, 5),
            prefetch=t["prefetch"], num_threads=t["loader_threads"], use_native=True)
        self.batch_rays = t["shards_per_batch"] * t["shard_rows"]
        n_hard = int(t["hard_ratio"] * self.batch_rays)
        self.hard = (n_hard, n_hard)
        self.pool_rows = int(self.batch_rays * t["hard_mul"])
        self.check_steps = fill_steps(self.pool_rows, n_hard) + 1
        self.model = build_student(cfg, self.params, dev)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=tr["lrate"],
                                    betas=tuple(tr["betas"]), eps=tr["eps"],
                                    fused=dev.type == "cuda")
        self.step = steps.make_r2l_train_step(
            self.model, self.opt, near=cfg["near"], far=cfg["far"], n_sample=cfg["n_sample"],
            L=cfg["multires"], perturb=tr["perturb"], hard=self.hard,
            fast_embed=tr["fast_embed"],
            schedule=schedules.make_lr_schedule(tr["lrate"], tr["lrate_decay"],
                                                tuple(tr["warmup_lr"])),
            device=dev)
        self.state = steps.init_train_state(self.model, self.opt)
        self.pool = hard_mining.hard_pool_init(self.pool_rows, device=dev)
        self.gen = inputs.torch_generator(cell.seed, dev, 6)
        self.record = {"batches": [], "noises": [], "losses": [], "pool": []}
        self.ref = None
        for k in range(max(t["warmup_steps"], self.check_steps)):
            self._step(record=k < self.check_steps)
            if k == 0:
                self._record_first_gradient()
            if k + 1 == self.check_steps:
                self._record_change()

    def _noise(self) -> Dict[str, torch.Tensor]:
        n_out = self.hard[1]
        b_aug = self.batch_rays + n_out
        return {"t_rand": torch.rand((b_aug, self.cfg["n_sample"]), generator=self.gen,
                                     device=self.dev),
                "idx_out": torch.randint(0, self.pool_rows, (n_out,), generator=self.gen,
                                         device=self.dev),
                "batch_idx": torch.randint(0, self.batch_rays, (n_out,), generator=self.gen,
                                           device=self.dev)}

    def _step(self, record: bool = False) -> None:
        with torch.profiler.record_function(tracing.FETCH_SPAN):
            batch = next(self.loader)
        o, d, tgt = (to_device(x, self.dev) for x in batch)
        noise = self._noise()
        count = self.pool.count
        self.state, self.pool, met = self.step(self.state, self.pool, None, o, d, tgt,
                                               noise=noise)
        if record:
            self.record["batches"].append(tuple(np.array(x) for x in batch))
            self.record["noises"].append(noise)
            self.record["losses"].append(met["loss_rgb"])
            self.record["pool"].append(
                written_rows(self.pool.rays, count, noise["idx_out"], self.hard[0]).cpu().numpy())

    def _record_first_gradient(self) -> None:
        """The first gradient as Adam got it: after one step from zero, the
        first moment holds (1 - beta1) times it."""
        b1 = self.opt.param_groups[0]["betas"][0]
        self.record["grad_norms"] = leaf_norms(
            {k: self.opt.state[p]["exp_avg"] / (1 - b1)
             for k, p in self.model.named_parameters()})

    def _record_change(self) -> None:
        self.record["change_norms"] = leaf_norms(
            {k: p.detach() - self.params[k] for k, p in self.model.named_parameters()})

    def request(self) -> None:
        self._step()

    def counters(self) -> Dict:
        return {"rays_per_request": self.batch_rays + self.hard[1]}

    def release(self) -> None:
        self.loader.close()
        shutil.rmtree(self.tmp, ignore_errors=True)
        self.record["losses"] = [float(v) for v in self.record["losses"]]
        del self.model, self.opt, self.step, self.state, self.pool

    def _reference(self, **kw) -> Dict:
        rec = self.record
        return self.cell.reference.train_steps(self.params, rec["batches"], rec["noises"],
                                               self.cfg, self.hard, self.pool_rows, **kw)

    def check(self, candidate: str = "program") -> Dict[str, float]:
        """program: the recorded steps against the reference's; control: the
        reference in fp8 against it; half_batch: the reference on half of
        each batch against it; batch_pick: the reference taking its hard
        rows from the batch once the pool is full, against it."""
        if self.ref is None:
            self.ref = self._reference()
        cand = {"program": lambda: self.record,
                "control": lambda: self._reference(kind=CANDIDATES["control"]),
                "half_batch": lambda: self._reference(drop_half=True),
                "batch_pick": lambda: self._reference(batch_pick=True)}[candidate]()
        return train_gaps(cand, self.ref)

