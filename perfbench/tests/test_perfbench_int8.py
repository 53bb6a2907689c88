"""The int8 serving cell's yardstick on the CPU: the plain W8A8 reference
against the program's plain int8 version and its calibration at tiny
sizes, the 4-bit control against the reference at the published widths,
and kernel 4's readers on made-up events."""
import json
from pathlib import Path

import pytest
import torch

from efficient_nerf_tpu_torch.ops.r2l_int8 import (calibrate_r2l_int8, pack_r2l_weights_int8,
                                                   r2l_forward_int8_ref)
from perfbench import harness, inputs, tracing
from perfbench import yardstick as Y
from perfbench.drivers import r2l_frames
from perfbench.reference import r2l_w256d88 as R
from perfbench.tests._tiny import R2L

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "perfbench" / "configs" / "r2l_w256d88.json").read_text())
TRAFFIC = json.loads((ROOT / "perfbench" / "traffic" / "serve_orbit_int8.json").read_text())
LIMITS = json.loads((ROOT / "perfbench" / "limits" / "r2l_serve_int8.json").read_text())
SHARE = f"rgb_share_over_{r2l_frames.FAR_INT8}"


def setting(cfg, seed, side):
    """Weights, the model the program serves, the cell's calibration rays
    and a side x side crop of a frame's rays."""
    cpu = torch.device("cpu")
    p = R.init_params(cfg, inputs.torch_generator(seed, cpu, 0))
    model = r2l_frames.build_student(cfg, p, cpu)
    focal = inputs.focal_of(TRAFFIC)
    pose = inputs.pose_spherical(0.0, TRAFFIC["phi"], TRAFFIC["radius"])
    o, d = R.get_rays(pose, TRAFFIC["H"], TRAFFIC["W"], focal, cpu)
    n = TRAFFIC["calibrate_n"]
    fo, fd = R.get_rays(inputs.pose_spherical(37.0, TRAFFIC["phi"], TRAFFIC["radius"]),
                        side, side, focal, cpu)
    return p, model, (o[:n], d[:n]), (fo, fd)


def program(model, cfg, rays, scales, head_dtype):
    packed = pack_r2l_weights_int8(model.state_dict(), cfg["n_sample"], cfg["multires"],
                                   head_dtype=head_dtype)
    return r2l_forward_int8_ref(packed, *rays, cfg["near"], cfg["far"], cfg["n_sample"],
                                cfg["multires"], res_scale=cfg["res_scale"],
                                use_global_residual=cfg["use_residual"], act_scales=scales)


@pytest.fixture(scope="module")
def tiny():
    cfg = {**CONFIG, **R2L}
    p, model, cal, frame = setting(cfg, 20240611, 16)
    return cfg, p, model, cal, frame


def test_static_scales_match_the_programs_calibration(tiny):
    # the same float32 forward; the program embeds by a polynomial sine and
    # the double-angle recurrence, the reference exactly: 1e-4 relative
    # holds that apart from any other recipe (at W256 D88: 1.6e-5)
    cfg, p, model, cal, _ = tiny
    want = calibrate_r2l_int8(model.state_dict(), *cal, cfg["near"], cfg["far"],
                              cfg["n_sample"], cfg["multires"], res_scale=cfg["res_scale"])
    got = R.static_scales(p, *cal, cfg)
    assert got.shape == (cfg["n_block"], 2)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0.0)


def test_w8a8_reference_matches_the_programs_plain_int8(tiny):
    cfg, p, model, cal, frame = tiny
    scales = R.static_scales(p, *cal, cfg)
    want = R.render_rays(p, *frame, cfg, "int8", act_scales=scales)
    # an f32 head and tail: the same levels and products; what is left is
    # the order of float32 operations (and the embed), far below a level
    f32 = (program(model, cfg, frame, scales, torch.float32) - want).abs()
    assert f32.max() <= 1e-5
    # the kernel's bf16 head and tail round every pre-activation by up to
    # 2^-8: that flips a few levels, and moves the tail's sigmoid by ~1e-3;
    # no channel reaches FAR_INT8
    bf16 = (program(model, cfg, frame, scales, torch.bfloat16) - want).abs()
    assert bf16.max() < r2l_frames.FAR_INT8
    assert bf16.square().mean().sqrt() <= 2e-3


def test_int4_control_departs_beyond_the_limit():
    # the published widths on 1,600 rays: the 4-bit body's share of far
    # channels lies far past the limit, the program's plain int8 version
    # inside it
    cfg = CONFIG
    p, model, cal, frame = setting(cfg, 1234567890123, 40)
    scales = R.static_scales(p, *cal, cfg)
    want = R.render_rays(p, *frame, cfg, "int8", act_scales=scales)

    def share(got):
        return float(((got - want).abs() > r2l_frames.FAR_INT8).double().mean())
    assert share(R.render_rays(p, *frame, cfg, "int4", act_scales=scales)) > 10 * LIMITS[SHARE]
    assert share(program(model, cfg, frame, scales, torch.bfloat16)) <= LIMITS[SHARE]


def reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read


def view(device, requests=2, rays=1000):
    host = [(tracing.WINDOW_SPAN, 0.0, 100.0)]
    return harness.LayerView(tracing.Trace(device, host, (0.0, 100.0)), requests,
                             {"rays_per_request": rays}, CONFIG, TRAFFIC)


def test_int8_readers():
    kernel = [("void r2l_int8_kernel<128, false, 1>(Maps, Args)", 10.0, 30.0),
              ("void r2l_int8_kernel<128, false, 1>(Maps, Args)", 50.0, 70.0)]
    least = Y.r2l_int8_least_s(CONFIG, 2000)
    # 2,000 rays: operations outlast the bytes
    assert least > (2 * Y.r2l_int8_weight_bytes(CONFIG) + 2000 * 36) / Y.PEAK_HBM_BYTES
    assert reader("r2l_int8_roofline")(view(kernel)) == pytest.approx(100.0 * least / 40e-6)
    assert reader("serve_int8_mfu")(view(kernel)) == pytest.approx(100.0 * least / 100e-6)
    # no kernel 4 in the window: nothing to read
    assert reader("r2l_int8_roofline")(view([("void r2l_forward_kernel<128>", 10.0, 30.0)])) \
        is None
