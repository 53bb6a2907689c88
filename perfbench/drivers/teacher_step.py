"""The teacher's training step as `main._train_nerf` feeds it at lego's
`no_batching` after precrop: each step picks one of the training frames,
makes its rays on the host with `core.rays.get_rays_np`, takes N_rand
random pixels of it, moves them with `device.to_device`, and runs the step
of `train.steps.make_teacher_train_step` (float32, coarse and fine networks,
fused Adam, the decay schedule). The step's random numbers are drawn by the
benchmark and handed in through its `noise` hook.

Traffic keys: H, W, camera_angle_x, radius (the frames' random orbit
cameras), frames (training frames, rgb uniform from the seed), N_rand,
check_steps, warmup_steps.

Set-up makes the frames, builds the step, and takes its first warmup_steps
steps through the same feed: the first check_steps are recorded (rays,
draws, losses, each step's fine rgb as the step's `render_rays` returned
it, the first gradient as Adam's state holds it, the parameters after
them). The check runs the reference's steps on the same rays and draws.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from efficient_nerf_tpu_torch.core.rays import get_rays_np
from efficient_nerf_tpu_torch.device import to_device
from efficient_nerf_tpu_torch.models import NeRFMLP
from efficient_nerf_tpu_torch.render import RenderConfig
from efficient_nerf_tpu_torch.train import schedules, steps

from .. import inputs
from ..reference._plain import leaf_norms, train_gaps

# A ray whose first-step rgb departs from the reference's by more than this,
# in any channel, counts as departing (PERF.md section 4).
FINE_TOL = 1e-3


def departing_share(cand, ref, tol: float) -> float:
    """The share of the reference's rays whose fine rgb the candidate
    departs from by more than tol in some channel; a ray the candidate did
    not render departs."""
    n = min(len(cand), len(ref))
    gap = (cand[:n].float() - ref[:n].float()).abs().amax(-1)
    return float(((gap > tol).sum() + (len(ref) - n)) / len(ref))


def build_teacher(cfg: Dict, params: Dict, device):
    """The coarse and the fine float32 NeRFMLP with the benchmark's weights."""
    nets = []
    for net in ("coarse", "fine"):
        m = NeRFMLP(depth=cfg["depth"], width=cfg["width"], input_ch=cfg["input_ch"],
                    input_ch_views=cfg["input_ch_views"], output_ch=cfg["output_ch"],
                    skips=tuple(cfg["skips"]), use_viewdirs=cfg["use_viewdirs"]).to(device)
        m.load_state_dict(params[net])
        nets.append(m)
    return nets[0], nets[1]


def render_config(cfg: Dict, **kw) -> RenderConfig:
    return RenderConfig(n_samples=cfg["n_samples"], n_importance=cfg["n_importance"],
                        lindisp=cfg["lindisp"], white_bkgd=cfg["white_bkgd"],
                        raw_noise_std=cfg["raw_noise_std"], use_viewdirs=cfg["use_viewdirs"],
                        multires=cfg["multires"], multires_views=cfg["multires_views"],
                        near=cfg["near"], far=cfg["far"], chunk=cfg["chunk"], **kw)


class Driver:
    def __init__(self, cell):
        cfg, t, dev = cell.config, cell.traffic, cell.device
        self.cell, self.cfg, self.t, self.dev = cell, cfg, t, dev
        tr = cfg["train"]
        self.params = cell.reference.init_params(cfg, inputs.torch_generator(cell.seed, dev, 0))
        coarse, fine = build_teacher(cfg, self.params, dev)
        self.nets = torch.nn.ModuleDict({"coarse": coarse, "fine": fine})
        self.opt = torch.optim.Adam(self.nets.parameters(), lr=tr["lrate"],
                                    betas=tuple(tr["betas"]), eps=tr["eps"],
                                    fused=dev.type == "cuda")
        self.step = steps.make_teacher_train_step(
            coarse, fine if cfg["fine_network"] else None, self.opt,
            render_config(cfg, perturb=tr["perturb"], fast_embed=tr["fast_embed"]),
            schedule=schedules.make_lr_schedule(tr["lrate"], tr["lrate_decay"]), device=dev)
        self.state = steps.init_train_state(self.nets, self.opt)
        self.focal = inputs.focal_of(t)
        frame_rng = inputs.numpy_rng(cell.seed, 9)
        self.poses = [inputs.random_orbit_pose(frame_rng, t["radius"]) for _ in range(t["frames"])]
        self.images = torch.rand((t["frames"], t["H"] * t["W"], 3),
                                 generator=inputs.torch_generator(cell.seed, dev, 9),
                                 device=dev).cpu().numpy()
        self.rng = inputs.numpy_rng(cell.seed, 10)
        self.gen = inputs.torch_generator(cell.seed, dev, 10)
        self.record = {"batches": [], "noises": [], "losses": [], "psnr": [], "fine_rgb": [],
                       "coarse_rgb": []}
        self.ref = None
        for k in range(t["warmup_steps"]):
            self._step(record=k < t["check_steps"])
            if k == 0:
                b1 = self.opt.param_groups[0]["betas"][0]
                self.record["grad_norms"] = leaf_norms(
                    {k2: self.opt.state[p]["exp_avg"] / (1 - b1)
                     for k2, p in self.nets.named_parameters()})
            if k + 1 == t["check_steps"]:
                self.record["change_norms"] = leaf_norms(
                    {k2: p.detach() - self.params[k2.split(".", 1)[0]][k2.split(".", 1)[1]]
                     for k2, p in self.nets.named_parameters()})

    def _batch(self):
        H, W = self.t["H"], self.t["W"]
        i = int(self.rng.integers(0, len(self.poses)))
        ro, rd = get_rays_np(H, W, self.focal, self.poses[i][:3, :4])
        sel = self.rng.choice(H * W, size=self.t["N_rand"], replace=False)
        return (np.ascontiguousarray(ro.reshape(-1, 3)[sel]),
                np.ascontiguousarray(rd.reshape(-1, 3)[sel]), self.images[i][sel])

    def _noise(self) -> Dict[str, torch.Tensor]:
        n = self.t["N_rand"]
        return {"t_rand": torch.rand((n, self.cfg["n_samples"]), generator=self.gen,
                                     device=self.dev),
                "u": torch.sort(torch.rand((n, self.cfg["n_importance"]), generator=self.gen,
                                           device=self.dev), -1).values}

    def _step(self, record: bool = False) -> None:
        batch = self._batch()
        noise = self._noise()
        if record:
            seen = []
            render = steps.render_rays

            def recording(*a, **kw):
                res = render(*a, **kw)
                seen.append((res.rgb.detach().cpu(), res.rgb0.detach().cpu()))
                return res
            steps.render_rays = recording
        try:
            self.state, met = self.step(self.state, None,
                                        *(to_device(x, self.dev) for x in batch), noise=noise)
        finally:
            if record:
                steps.render_rays = render
        if record:
            self.record["batches"].append(batch)
            self.record["noises"].append(noise)
            self.record["losses"].append(met["loss"])
            self.record["psnr"].append(met["psnr"])
            self.record["fine_rgb"].append(seen[0][0])
            self.record["coarse_rgb"].append(seen[0][1])

    def request(self) -> None:
        self._step()

    def counters(self) -> Dict:
        return {"rays_per_request": self.t["N_rand"]}

    def release(self) -> None:
        rec = self.record
        rec["losses"] = [float(v) for v in rec["losses"]]
        # the step reports the fine MSE as its PSNR
        rec["fine_losses"] = [10.0 ** (-float(v) / 10.0) for v in rec.pop("psnr")]
        del self.nets, self.opt, self.step, self.state

    def check(self, candidate: str = "program") -> Dict[str, float]:
        """program: the recorded steps against the reference's; control: the
        reference with TF32 products against it; half_batch: the reference
        on half of each batch against it. The coarse_ numbers take the
        coarse pass alone (its loss, the coarse network's leaves), which the
        fine depths' jumps at the coarse CDF's steps do not reach; the
        first step's rgb, as rendered before either side moved a weight:
        the share of rays whose fine rgb departs, which a few jumps move
        little, and the coarse rgb's largest gap."""
        rec, ref_mod = self.record, self.cell.reference

        def reference(**kw):
            return ref_mod.train_steps(self.params, rec["batches"], rec["noises"], self.cfg, **kw)

        if self.ref is None:
            self.ref = reference()
        ref = self.ref
        cand = {"program": lambda: rec, "control": lambda: reference(tf32=True),
                "half_batch": lambda: reference(drop_half=True)}[candidate]()
        for r in (cand, ref):
            r["coarse_losses"] = [a - b for a, b in zip(r["losses"], r["fine_losses"])]
        coarse = train_gaps(cand, ref, leaves="coarse.", loss="coarse_losses")
        out = {**train_gaps(cand, ref), **{f"coarse_{k}": v for k, v in coarse.items()}}
        out[f"fine_share_over_{FINE_TOL:g}"] = departing_share(cand["fine_rgb"][0],
                                                              ref["fine_rgb"][0], FINE_TOL)
        c0, r0 = cand["coarse_rgb"][0], ref["coarse_rgb"][0]
        out["coarse_rgb_max_gap"] = (float((c0.double() - r0.double()).abs().max())
                                     if len(c0) == len(r0) else math.inf)
        return out
