"""Student frames in a closed loop with one client, as `evaluate.render_path`
serves them: each request is an orbit camera handed to
`render.r2l_render_image`, and the frame comes back to host memory as
float32 numpy.

Traffic keys: H, W, camera_angle_x, phi, radius (the orbit; theta is drawn
from the seed for each frame), quant ('' or 'int8', with static scales
from `calibrate_n` rays of a set-up frame), warmup_frames, check_frames (the
frames the check keeps, drawn from the seed by reservoir sampling),
reference (absent: the float32 reference; 'int8': the W8A8 recipe).

Check: the kept frames against the reference's frames of the same cameras:
the share of pixel channels more than FAR from the reference's float32
frames (compared), with the largest and the root-mean-square gap beside it.
With reference 'int8' the reference is the plain W8A8 recipe, with static
scales of its own from the same calibration rays, and the share is of
channels more than FAR_INT8 from it; its control ("control") is that
recipe on 4-bit body weights in the program's place.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from efficient_nerf_tpu_torch.models import R2LNet
from efficient_nerf_tpu_torch.render import r2l_renderer

from .. import inputs

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# A channel this far from the float32 reference counts as far: the sound
# bf16 frames' largest gaps lie just under it, the int8 control's spread past
# it (PERF.md section 4).
FAR = 0.004
# The same for the int8 frames against the W8A8 reference: the sound
# frames' largest gaps lie under it (the kernel's bf16 head and tail flip a
# few levels), the 4-bit control's spread far past it (PERF.md section 4).
FAR_INT8 = 0.01


def build_student(cfg: Dict, params, device) -> R2LNet:
    model = R2LNet(input_dim=cfg["input_dim"], depth=cfg["depth"], width=cfg["width"],
                   output_dim=cfg["output_dim"], n_block=cfg["n_block"],
                   n_learnable=cfg["n_learnable"], body_arch=cfg["body_arch"],
                   act=cfg["act"], inact=cfg["inact"], outact=cfg["outact"],
                   res_scale=cfg["res_scale"], use_residual=cfg["use_residual"],
                   dtype=DTYPES[cfg["dtype"]]).to(device)
    model.load_state_dict(params)
    return model


class Reservoir:
    """k items drawn uniformly from a stream of unknown length."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = item


class Driver:
    def __init__(self, cell):
        cfg, t, dev = cell.config, cell.traffic, cell.device
        self.cell, self.cfg, self.t, self.dev = cell, cfg, t, dev
        self.params = cell.reference.init_params(cfg, inputs.torch_generator(cell.seed, dev, 0))
        self.model = build_student(cfg, self.params, dev).eval().requires_grad_(False)
        self.focal = inputs.focal_of(t)
        self.thetas = inputs.numpy_rng(cell.seed, 1)
        self.keep = Reservoir(t["check_frames"], inputs.numpy_rng(cell.seed, 2))
        self.scales = None
        if t["quant"]:
            o, d = self._calibration_rays()
            self.scales = r2l_renderer.calibrate_serving_scales(
                self.model, o, d, cfg["near"], cfg["far"], cfg["n_sample"], cfg["multires"],
                n_cal=t["calibrate_n"], device=dev)
        warm = inputs.numpy_rng(cell.seed, 4)
        for _ in range(t["warmup_frames"]):
            self._frame(self._pose(warm.uniform(-180.0, 180.0)))

    def _calibration_rays(self):
        """The rays of the set-up frame whose first calibrate_n the int8
        scales are calibrated on."""
        t = self.t
        return self.cell.reference.get_rays(self._pose(0.0), t["H"], t["W"], self.focal, self.dev)

    def _pose(self, theta: float) -> np.ndarray:
        return inputs.pose_spherical(theta, self.t["phi"], self.t["radius"])

    def _frame(self, pose: np.ndarray) -> np.ndarray:
        c, t = self.cfg, self.t
        rgb = r2l_renderer.r2l_render_image(
            self.model, pose[:3, :4], t["H"], t["W"], self.focal, c["near"], c["far"],
            c["n_sample"], c["multires"], quant=t["quant"], act_scales=self.scales,
            device=self.dev)
        return rgb.float().cpu().numpy()

    def request(self) -> None:
        pose = self._pose(self.thetas.uniform(-180.0, 180.0))
        self.keep.offer((pose, self._frame(pose)))

    def counters(self) -> Dict:
        return {"rays_per_request": self.t["H"] * self.t["W"]}

    def release(self) -> None:
        del self.model

    def check(self, candidate: str = "program") -> Dict[str, float]:
        if self.t.get("reference") == "int8":
            return self._check_int8(candidate)
        if candidate != "program":
            raise ValueError(f"{candidate!r}: the serving control is the program's int8 path")
        ref, t = self.cell.reference, self.t
        gaps = [(torch.as_tensor(got, device=self.dev)
                 - ref.render_frame(self.params, pose, t["H"], t["W"], self.focal, self.cfg)
                 ).abs().flatten() for pose, got in self.keep.items]
        if not gaps:
            return {}
        gap = torch.cat(gaps).double()
        return {"rgb_share_over_0.004": float((gap > FAR).double().mean()),
                "rgb_max_gap": float(gap.max()),
                "rgb_rms_gap": float(gap.square().mean().sqrt())}

    def _check_int8(self, candidate: str) -> Dict[str, float]:
        """The kept int8 frames ("program"), or the 4-bit recipe's frames of
        the same cameras ("control"), against the W8A8 reference's."""
        if candidate not in ("program", "control"):
            raise ValueError(f"{candidate!r}: the int8 frames' candidates are program, control")
        ref, t = self.cell.reference, self.t
        o, d = self._calibration_rays()
        n = t["calibrate_n"]
        scales = ref.static_scales(self.params, o[:n], d[:n], self.cfg)

        def frame(pose, kind):
            return ref.render_frame(self.params, pose, t["H"], t["W"], self.focal, self.cfg,
                                    kind=kind, act_scales=scales)
        gaps = []
        for pose, got in self.keep.items:
            got = (torch.as_tensor(got, device=self.dev) if candidate == "program"
                   else frame(pose, "int4"))
            gaps.append((got - frame(pose, "int8")).abs().flatten())
        if not gaps:
            return {}
        gap = torch.cat(gaps).double()
        return {f"rgb_share_over_{FAR_INT8}": float((gap > FAR_INT8).double().mean()),
                "rgb_max_gap": float(gap.max()),
                "rgb_rms_gap": float(gap.square().mean().sqrt())}
